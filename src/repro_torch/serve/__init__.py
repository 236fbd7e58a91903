"""Serving layer: the cell-routed SVM serving subsystem (``model_bank`` +
``svm_engine``), its health loop (``monitor.HealthMonitor`` and the
drift-triggered ``refresh``), the bridge from the JAX package's banks
(``convert``), the co-located embedding front (``embed_engine.EmbedServe``)
and LM generation (``engine``, ``kv_cache``)."""
from repro_torch.serve.convert import bank_from_reference
from repro_torch.serve.embed_engine import EmbedServe
from repro_torch.serve.model_bank import ModelBank
from repro_torch.serve.monitor import HealthMonitor
from repro_torch.serve.refresh import refresh_bank, refresh_drifted
from repro_torch.serve.svm_engine import OverloadError, SVMEngine, blend_weights

__all__ = ["EmbedServe", "HealthMonitor", "ModelBank", "OverloadError",
           "SVMEngine", "bank_from_reference", "blend_weights",
           "refresh_bank", "refresh_drifted"]
