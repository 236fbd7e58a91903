"""Staged liquidSVM-style user surface: sessions, scenarios, config keys
(the JAX package's ``repro.api``).

* :mod:`repro_torch.api.session` — the staged cycle.  ``SVM(x, y, ...)``
  with ``train()`` -> :class:`TrainResult` (models + retained CV surface),
  ``select(rule)`` -> :class:`SelectResult` (argmin / npl / roc /
  quantile / expectile; only moved winners are re-solved), ``test()`` ->
  :class:`TestResult`.  Stage artifacts persist via ``save`` / ``load``
  in the reference's checkpoint format (``python -m repro_torch.cli``).
* :mod:`repro_torch.api.scenarios` — front-ends ``mcSVM`` ``lsSVM``
  ``qtSVM`` ``exSVM`` ``nplSVM`` ``rocSVM`` returning configured sessions.
* :mod:`repro_torch.api.config` — the validated string-key config layer
  (``describe_keys()`` lists the keys).
"""
from repro_torch.api.config import (ConfigError, apply_keys, available_keys,
                                    describe_keys, parse_keys,
                                    split_serve_keys, weight_grid)
from repro_torch.api.scenarios import (exSVM, lsSVM, mcSVM, nplSVM, qtSVM,
                                       rocSVM)
from repro_torch.api.session import SVM, SelectResult, TestResult, TrainResult

__all__ = [
    "SVM", "TrainResult", "SelectResult", "TestResult",
    "mcSVM", "lsSVM", "qtSVM", "exSVM", "nplSVM", "rocSVM",
    "ConfigError", "apply_keys", "parse_keys", "available_keys",
    "describe_keys", "split_serve_keys", "weight_grid",
]
