"""The estimator entry point (``svm_trainer.LiquidSVM``), checkpoints in
the JAX package's format (``checkpoint``), the bridge from the JAX
package's selections (``convert``), and LM training on one device or
sharded over a mesh (``optimizer``, ``lm_trainer``; imported where they
are used)."""
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig

__all__ = ["LiquidSVM", "SVMTrainerConfig"]
