"""Small MLP (counterpart of ``bluefog_tpu/models/mlp.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .layers import Dense, FlaxModel

__all__ = ["MLP"]


class MLP(FlaxModel):
    """``Dense -> relu -> ... -> Dense`` over the flattened input (flax
    flattens the input as given, NHWC for images).  ``in_features`` is
    what flax infers from the first input: the flattened size."""

    def __init__(self, features: Sequence[int] = (64, 64, 10), *,
                 in_features: int, generator: Optional[torch.Generator]
                 = None):
        super().__init__()
        self.n_layers = len(features)
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(in_features, f))
            in_features = f
        self._finish(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x
