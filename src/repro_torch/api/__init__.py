"""The staged session API (``session``): ``SVM`` -> ``TrainResult`` ->
``SelectResult``.  The scenario front-ends, the string-key config layer
and the CLI of the JAX package's ``repro.api`` are not ported yet."""
from repro_torch.api.session import SVM, SelectResult, TestResult, TrainResult

__all__ = ["SVM", "SelectResult", "TestResult", "TrainResult"]
