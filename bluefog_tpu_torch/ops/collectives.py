"""Wire-codec helpers (counterpart of ``bluefog_tpu/ops/collectives.py``).

Only the amax scaling that the quantized KV store shares with the gossip
wire codec is ported so far; the collectives themselves come with the
training slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["_amax_scale"]

_TINY = float(np.finfo(np.float32).tiny)


def _amax_scale(xf: torch.Tensor, qmax: float, blk: Optional[int]):
    """(scaled values ready to cast, riding scale(s)).  Per-buffer when
    ``blk`` is None, else one scale per row of the ``[n, blk]`` input.
    The scale is floored at the smallest normal f32: for a subnormal amax
    the division would underflow to 0 and ``xf / scale`` become inf, which
    e4m3fn (no inf) would turn into NaN.  With the floor, tiny payloads
    quantize to 0."""
    amax = (xf.abs().max() if blk is None
            else xf.abs().amax(dim=1, keepdim=True))
    scale = torch.where(amax > 0, torch.clamp(amax / qmax, min=_TINY),
                        torch.ones_like(amax))
    return xf / scale, scale.to(torch.float32)
