"""Attention helpers (counterpart of ``bluefog_tpu/ops/ulysses.py``).

* :func:`dense_attention`: the serving engine's prefill attention;
* :func:`local_flash_attention`: non-collective flash attention, a
  ``torch.autograd.Function`` whose forward is K1 and whose backward is K2
  (:mod:`bluefog_tpu_torch.ops.flash_attention`);
* :func:`ulysses_attention` at a sequence axis of size 1, the attention of
  the composed LM's decoder blocks.  The Ulysses all-to-all at ``sp > 1``
  is not ported yet (``compose_parallelism`` refuses the carving).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import flash_attention as _fa
from .ring import online_softmax_merge

__all__ = ["dense_attention", "local_flash_attention", "ulysses_attention"]


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


def _local_fwd_impl(q, k, v, causal: bool, scale: float, block_q: int):
    o, l, m = _fa.attention_block_partial(q, k, v, 0, 0, causal=causal,
                                          scale=scale, block_q=block_q)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / denom[..., None]).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")),
                      m + torch.log(denom))
    return out, lse


class _LocalFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _local_fwd_impl(q, k, v, causal, scale, block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q = ctx.args
        do = g.float().contiguous()
        delta = (do * out.float()).sum(dim=-1)
        dq, dk, dv = _fa.attention_block_backward(
            q, k, v, do, lse, delta, 0, 0, causal=causal, scale=scale,
            block_q=block_q)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool, scale: float,
                          block_q: int = 512) -> torch.Tensor:
    """Non-collective flash attention over ``[B, T, H, D]`` (kv heads may
    divide the q heads): K1 with both offsets at 0, then ``o / l``; the
    backward takes ``delta = sum(do * out)`` and runs K2.  On CUDA tensors
    both are the hand-written kernels; on CPU tensors their plain
    versions."""
    return _LocalFlash.apply(q, k, v, bool(causal), float(scale),
                             int(block_q))


def _chunk_len(Tk: int, max_chunk: int) -> int:
    """Largest divisor of ``Tk`` that is <= max_chunk."""
    for c in range(min(max_chunk, Tk), 0, -1):
        if Tk % c == 0:
            return c
    return Tk


def _plain_local_attention(q, k, v, causal: bool, scale: float,
                           max_chunk: int = 512) -> torch.Tensor:
    """The plain path (JAX ``_jnp_local_attention``): online-softmax local
    attention over K/V chunks, so memory stays O(Tq x chunk); gradients by
    autograd."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    chunk = _chunk_len(Tk, max_chunk)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc) * scale
    q_pos = torch.arange(Tq, device=q.device)
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=acc, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), dtype=acc, device=q.device)
    for c in range(Tk // chunk):
        kt = k[:, c * chunk:(c + 1) * chunk]
        vt = v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bihd,bjhd->bihj", qf, kt.to(acc))
        if causal:
            k_pos = c * chunk + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None, None] >= k_pos[None, None, :]
            s = s.masked_fill(~mask[None], float("-inf"))
        o, l, m = online_softmax_merge(o, l, m, s, vt)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, scale: Optional[float] = None,
                      use_pallas: bool = False, pallas_block_q: int = 512
                      ) -> torch.Tensor:
    """The JAX ``ulysses_attention`` at a sequence axis of size 1 (the only
    carving ported; ``compose_parallelism`` refuses sp > 1): the
    ``[batch, block_len, heads, head_dim]`` block holds the whole sequence
    and every head, so no all-to-all runs.  On CUDA tensors it always goes
    through :func:`local_flash_attention` (the K1/K2 kernels;
    ``use_pallas`` selects nothing there); on the CPU ``use_pallas``
    selects it, else the plain online-softmax path."""
    if q.ndim != 4:
        raise ValueError("expected [batch, block_len, heads, head_dim]")
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(
            "ulysses scatters heads across the axis and needs equal q/kv "
            "head counts; grouped-query (GQA) kv is a ring_attention "
            "feature")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if q.device.type == "cuda" or use_pallas:
        return local_flash_attention(q, k, v, causal, float(scale),
                                     pallas_block_q)
    return _plain_local_attention(q, k, v, causal, float(scale))
