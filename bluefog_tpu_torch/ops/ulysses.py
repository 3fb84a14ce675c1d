"""Attention helpers (counterpart of ``bluefog_tpu/ops/ulysses.py``).

Only ``dense_attention``, the prefill attention of the serving engine,
is ported so far; the Ulysses all-to-all attention comes with the
long-context training slice (kernels K1/K2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dense_attention"]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Dense attention on ``[B, T, H, D]`` with ``[Tq, Tk]`` scores in
    memory, computed at the f32 floor (f64 inputs stay f64)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bihd,bjhd->bihj", q.to(ct) * scale, k.to(ct))
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = s.masked_fill(~mask[:, None, :][None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bihj,bjhd->bihd", p, v.to(ct)).to(q.dtype)
