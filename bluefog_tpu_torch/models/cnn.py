"""MNIST CNN (counterpart of ``bluefog_tpu/models/cnn.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Conv, Dense, Dropout, FlaxModel, nchw

__all__ = ["MnistCNN"]


class MnistCNN(FlaxModel):
    """Two VALID 3x3 convs (32, 64) with relu, a 2x2 max pool, dropout
    0.25, ``Dense(128)``, relu, dropout 0.5, ``Dense(num_classes)``; f32.
    The input is NHWC ``[B, image_size, image_size, in_features]`` (MNIST:
    28 x 28 x 1), as every activation; the flatten follows that order."""

    def __init__(self, num_classes: int = 10, *, image_size: int = 28,
                 in_features: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, 32, (3, 3), padding="VALID")
        self.Conv_1 = Conv(32, 64, (3, 3), padding="VALID")
        side = (image_size - 4) // 2
        self.dropout_0, self.dropout_1 = Dropout(0.25), Dropout(0.5)
        self.Dense_0 = Dense(side * side * 64, 128)
        self.Dense_1 = Dense(128, num_classes)
        self._finish(generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = self.dropout_0(nchw(F.max_pool2d, x, 2, 2), train, generator)
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = self.dropout_1(x, train, generator)
        return self.Dense_1(x)
