"""Host-side data pipeline pieces the serving path needs: the chunked
in-memory source (``dataset``) and the chunked GEMM-form nearest-center
router (``assign``), numpy on both sides so routing is bit-identical to
the JAX package's."""
from repro_torch.pipeline.dataset import (  # noqa: F401
    ArraySource,
    ChunkSource,
    as_source,
)
