"""The estimator entry point (``svm_trainer.LiquidSVM``), checkpoints in
the JAX package's format (``checkpoint``) and the bridge from the JAX
package's selections (``convert``)."""
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig

__all__ = ["LiquidSVM", "SVMTrainerConfig"]
