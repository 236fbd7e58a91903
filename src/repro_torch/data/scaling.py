"""Train-statistics scaling (the paper: "Based on the training a scaling was
determined and both training and test set were normalized by that")."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scaler:
    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Scaler":
        return Scaler(mean=x.mean(0), std=np.maximum(x.std(0), 1e-8))

    @staticmethod
    def fit_stream(source, chunk_size: int = 65536) -> "Scaler":
        """Fit from a :class:`repro_torch.pipeline.dataset.ChunkSource` in one
        pass (f64 accumulators) — x is never resident."""
        from repro_torch.pipeline.dataset import as_source, streaming_mean_std
        mean, std = streaming_mean_std(as_source(source), chunk_size)
        return Scaler(mean=mean, std=np.maximum(std, 1e-8))

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((x - self.mean) / self.std).astype(np.float32)