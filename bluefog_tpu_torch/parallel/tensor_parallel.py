"""Megatron tensor parallelism over stacked tp peers (counterpart of
``bluefog_tpu/parallel/tensor_parallel.py``).

The JAX modules are flax layers run inside ``shard_map``: each device
holds its shard of the weight, and a row-parallel layer completes its
output with one ``psum`` over the tp axis.  Here the ``tp`` peers live
stacked on dim 0: every weight is ``[tp, ...]`` (peer ``t``'s shard in
row ``t``) and every activation ``[tp, ...]`` (peer ``t``'s copy).  The
``psum`` is :func:`~bluefog_tpu_torch.ops.collectives.psum` over dim 0,
whose autograd transpose sums the cotangents over the peers.

Weights keep the flax orientation (``x @ kernel``), so a JAX tree copies
in with :meth:`load_flax`.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.collectives import psum

__all__ = ["ColumnParallelDense", "RowParallelDense", "TPMlpBlock"]


def _copy(param: nn.Parameter, value: Any) -> None:
    with torch.no_grad():
        param.copy_(torch.as_tensor(np.array(value), dtype=param.dtype))


def _per_peer_matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x[t] @ kernel[t]`` for every peer ``t``: ``[tp, ..., i] x [tp, i,
    o] -> [tp, ..., o]``."""
    y = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), kernel)
    return y.reshape(x.shape[:-1] + (kernel.shape[-1],))


class ColumnParallelDense(nn.Module):
    """Dense with its ``features`` outputs split across the ``tp`` peers:
    ``x [tp, ..., in] -> [tp, ..., features / tp]``, no communication."""

    def __init__(self, in_features: int, features: int, tp: int,
                 use_bias: bool = True):
        super().__init__()
        if features % tp:
            raise ValueError(f"features {features} not divisible by "
                             f"model-axis size {tp}")
        self.kernel = nn.Parameter(torch.empty(tp, in_features,
                                               features // tp))
        self.bias = (nn.Parameter(torch.zeros(tp, features // tp))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _per_peer_matmul(x, self.kernel)
        if self.bias is not None:
            y = y + self.bias.reshape((self.bias.shape[0],)
                                      + (1,) * (y.ndim - 2) + (-1,))
        return y

    def load_flax(self, tree: Mapping[str, Any]) -> None:
        """Copy the JAX module's stacked ``{"Dense_0": {"kernel",
        "bias"}}`` (leaves ``[tp, ...]``)."""
        _copy(self.kernel, tree["Dense_0"]["kernel"])
        if self.bias is not None:
            _copy(self.bias, tree["Dense_0"]["bias"])


class RowParallelDense(nn.Module):
    """Dense with its inputs split across the ``tp`` peers: each peer
    multiplies its ``in_features / tp`` columns, one :func:`psum` over the
    peers completes the output, and each peer adds its bias once after
    the reduction: ``x [tp, ..., in / tp] -> [tp, ..., features]``."""

    def __init__(self, in_features: int, features: int, tp: int,
                 use_bias: bool = True):
        super().__init__()
        if in_features % tp:
            raise ValueError(f"in_features {in_features} not divisible by "
                             f"model-axis size {tp}")
        self.kernel = nn.Parameter(torch.empty(tp, in_features // tp,
                                               features))
        self.bias = (nn.Parameter(torch.zeros(tp, features))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _per_peer_matmul(x, self.kernel)
        y = psum(y, 0)
        if self.bias is not None:
            y = y + self.bias.reshape((self.bias.shape[0],)
                                      + (1,) * (y.ndim - 2) + (-1,))
        return y

    def load_flax(self, tree: Mapping[str, Any]) -> None:
        """Copy the JAX module's stacked ``{"Dense_0": {"kernel"},
        "bias"}`` (leaves ``[tp, ...]``)."""
        _copy(self.kernel, tree["Dense_0"]["kernel"])
        if self.bias is not None:
            _copy(self.bias, tree["bias"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class TPMlpBlock(nn.Module):
    """Column -> activation -> row parallel MLP (one psum per block)."""

    def __init__(self, in_features: int, hidden: int, features: int,
                 tp: int, activation: Callable = _gelu):
        super().__init__()
        self.col = ColumnParallelDense(in_features, hidden, tp)
        self.row = RowParallelDense(hidden, features, tp)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.row(self.activation(self.col(x)))

    def load_flax(self, tree: Mapping[str, Any]) -> None:
        """Copy the JAX ``TPMlpBlock``'s stacked params
        (``{"ColumnParallelDense_0", "RowParallelDense_0"}``)."""
        self.col.load_flax(tree["ColumnParallelDense_0"])
        self.row.load_flax(tree["RowParallelDense_0"])
