"""VGG (counterpart of ``bluefog_tpu/models/vgg.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Conv, Dense, Dropout, FlaxModel, nchw

__all__ = ["VGG", "VGG11", "VGG16"]

_CFG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_CFG11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


class VGG(FlaxModel):
    """3x3 "SAME" convs with relu and 2x2 max pools per ``cfg``, then two
    ``Dense(hidden)`` with relu and dropout 0.5, then ``Dense(num_classes)``.
    The convs and hidden layers run in ``dtype``, the head in f32.  The
    input is NHWC ``[B, image_size, image_size, in_features]``, as every
    activation; the flatten follows that order."""

    def __init__(self, cfg: Tuple = _CFG16, num_classes: int = 1000,
                 hidden: int = 4096, dtype: torch.dtype = torch.bfloat16, *,
                 image_size: int = 224, in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = tuple(cfg), dtype
        c, side, i = in_features, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                setattr(self, f"Conv_{i}", Conv(c, v, (3, 3), dtype=dtype))
                c, i = v, i + 1
        self.Dense_0 = Dense(side * side * c, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, hidden, dtype=dtype)
        self.Dense_2 = Dense(hidden, num_classes, dtype=torch.float32)
        self.dropout_0, self.dropout_1 = Dropout(0.5), Dropout(0.5)
        self._finish(generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = nchw(F.max_pool2d, x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = x.reshape(x.shape[0], -1)
        x = self.dropout_0(F.relu(self.Dense_0(x)), train, generator)
        x = self.dropout_1(F.relu(self.Dense_1(x)), train, generator)
        return self.Dense_2(x)


def VGG16(**kw) -> VGG:
    return VGG(cfg=_CFG16, **kw)


def VGG11(**kw) -> VGG:
    return VGG(cfg=_CFG11, **kw)
