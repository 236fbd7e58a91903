"""Data pipeline, numpy on the host so routing and cell plans are
bit-identical to the JAX package's: the chunked in-memory, memmap and npz
sources and the scaled view (``dataset``); the chunked GEMM-form
nearest-center router, Lloyd sweeps and minibatch k-means (``assign``),
whose assignment runs on the host (numpy) or on the card (plain PyTorch,
or the resident-center kernel B6); and the streaming cell builder
(``cell_stream``)."""
from repro_torch.pipeline.dataset import (  # noqa: F401
    ArraySource,
    ChunkSource,
    MemmapSource,
    ScaledSource,
    as_source,
    streaming_mean_std,
)
