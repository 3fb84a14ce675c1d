"""ResNet v1.5 (counterpart of ``bluefog_tpu/models/resnet.py``), the
model of the benchmark.

Mixed precision as in JAX: every conv casts its input and its f32 kernel
to ``dtype`` (bf16 by default), runs in it and has no bias; BatchNorm
promotes its input and computes and returns f32; the residual add, the
ReLU, the global mean pool over H and W, the head ``Dense`` and the
logits are f32.  Stride 2 sits on the 3x3 conv (v1.5), blocks whose shape
changes have ``proj`` / ``proj_bn`` shortcuts, and the last BatchNorm of
each block starts with scale 0.  The stem is a 7x7 stride-2 conv padded
(3, 3), BatchNorm, ReLU and a 3x3 stride-2 max pool padded (1, 1) with
-inf.  The input and every activation are NHWC ``[B, H, W, C]``; the
convs and the pool run on their ``channels_last`` NCHW views.

``forward(x, train=True)`` returns ``(logits, {"batch_stats": new})``
with the running statistics updated from the batch (flax's
``mutable=["batch_stats"]``); ``train=False`` returns the logits of the
running statistics.  BatchNorm uses each rank's own batch statistics, as
per-GPU BN does in the reference setup.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense, FlaxModel, nchw

__all__ = ["BottleneckBlock", "BasicBlock", "ResNet", "ResNet18",
           "ResNet34", "ResNet50"]

Updates = Dict[str, Dict[str, torch.Tensor]]


class _Block(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.out_features = filters * self.expansion
        self.has_proj = strides != 1 or in_features != self.out_features
        if self.has_proj:
            self.proj = Conv(in_features, self.out_features, (1, 1),
                             (strides, strides), use_bias=False, dtype=dtype)
            self.proj_bn = BatchNorm(self.out_features)

    def _residual(self, x: torch.Tensor, train: bool, updates: Updates):
        return self.proj_bn(self.proj(x), train, updates) if self.has_proj \
            else x


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 (x4 filters), BatchNorm and ReLU after
    each; the last BatchNorm's scale starts at 0."""
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__(in_features, filters, strides, dtype)
        conv = partial(Conv, use_bias=False, dtype=dtype)
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), (strides, strides))
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = conv(filters, self.out_features, (1, 1))
        self.BatchNorm_2 = BatchNorm(self.out_features, zero_scale=True)

    def forward(self, x: torch.Tensor, train: bool, updates: Updates
                ) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train, updates))
        y = self.BatchNorm_2(self.Conv_2(y), train, updates)
        return F.relu(self._residual(x, train, updates) + y)


class BasicBlock(_Block):
    """3x3 (stride) -> 3x3, BatchNorm after each; the last BatchNorm's
    scale starts at 0."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__(in_features, filters, strides, dtype)
        conv = partial(Conv, use_bias=False, dtype=dtype)
        self.Conv_0 = conv(in_features, filters, (3, 3), (strides, strides))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)

    def forward(self, x: torch.Tensor, train: bool, updates: Updates
                ) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train, updates))
        y = self.BatchNorm_1(self.Conv_1(y), train, updates)
        return F.relu(self._residual(x, train, updates) + y)


class ResNet(FlaxModel):
    """ResNet over ``stage_sizes`` blocks of ``block_cls``; stage s has
    ``num_filters * 2**s`` filters and its first block (s > 0) stride 2.
    ``in_features`` is the input's channel count (flax infers it)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, *,
                 in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(in_features, num_filters, (7, 7), (2, 2),
                         padding=[(3, 3), (3, 3)], use_bias=False,
                         dtype=dtype)
        self.stem_bn = BatchNorm(num_filters)
        self.block_names = []
        c = num_filters
        for stage, num_blocks in enumerate(stage_sizes):
            for b in range(num_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                block = block_cls(c, num_filters * 2 ** stage, strides,
                                  dtype)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                setattr(self, name, block)
                self.block_names.append(name)
                c = block.out_features
        self.Dense_0 = Dense(c, num_classes, dtype=torch.float32)
        self._finish(generator)

    def forward(self, x: torch.Tensor, train: bool = True):
        updates: Updates = {}
        x = F.relu(self.stem_bn(self.stem(x.to(self.dtype)), train,
                                updates))
        x = nchw(F.max_pool2d, x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train, updates)
        logits = self.Dense_0(x.mean((1, 2))).float()
        if not train:
            return logits
        return logits, {"batch_stats": self._stats_tree(updates)}


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
