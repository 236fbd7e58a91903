"""repro_torch — the PyTorch/CUDA port of the liquidSVM reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
paths and imports neither ``jax`` nor ``repro``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``; the hand-written Hopper kernels
are in ``csrc/`` and are built with ``nvcc`` at first use.

Ported so far: the cell-routed SVM serving path (``repro_torch.serve``),
the training path (``train.svm_trainer.LiquidSVM``, ``api.session.SVM``)
and the LM path: the dense attention backbones (``models``, ``configs``),
frozen-backbone embeddings (``embed``), ``serve.EmbedServe`` and LM
generation (``serve.engine.generate``).
"""
