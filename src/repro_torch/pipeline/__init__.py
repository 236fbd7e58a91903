"""Host-side data pipeline, numpy on both sides so routing and cell plans
are bit-identical to the JAX package's: the chunked in-memory source and
its scaled view (``dataset``), the chunked GEMM-form nearest-center router
and Lloyd sweeps (``assign``), and the streaming cell builder
(``cell_stream``)."""
from repro_torch.pipeline.dataset import (  # noqa: F401
    ArraySource,
    ChunkSource,
    ScaledSource,
    as_source,
    streaming_mean_std,
)
