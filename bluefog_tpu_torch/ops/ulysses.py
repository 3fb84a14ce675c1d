"""Attention helpers (counterpart of ``bluefog_tpu/ops/ulysses.py``).

* :func:`dense_attention`: the serving engine's prefill attention;
* :func:`local_flash_attention`: non-collective flash attention, a
  ``torch.autograd.Function`` whose forward is K1 and whose backward is K2
  (:mod:`bluefog_tpu_torch.ops.flash_attention`);
* :func:`ulysses_attention`, the attention of the composed LM's decoder
  blocks: exact attention over a sequence sharded across the sp peers
  stacked along one dim, by two all-to-alls
  (:func:`~bluefog_tpu_torch.ops.collectives.all_to_all`) around K1, and
  around K2 in its backward.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import flash_attention as _fa
from .collectives import all_to_all
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


def _scatter_heads(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """``[..., B, T/sp, H, D] -> [..., B, T, H/sp, D]`` over the sp peers
    stacked along dim ``axis``: heads scatter, the sequence gathers (the
    identity without an axis or with one peer)."""
    if axis is None or x.shape[axis] == 1:
        return x
    return all_to_all(x, axis, -2, -3, lead=x.ndim - 4)


def _gather_heads(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """Inverse of :func:`_scatter_heads`."""
    if axis is None or x.shape[axis] == 1:
        return x
    return all_to_all(x, axis, -3, -2, lead=x.ndim - 4)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Every leading dim (peers and batch) into one contiguous batch dim:
    ``[..., T, H, D] -> [N, T, H, D]``, as the kernels take it."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).contiguous()


class _UlyssesFlash(torch.autograd.Function):
    """Scatter heads -> K1 -> gather heads; the backward runs its own
    all-to-alls around K2 (the JAX ``_ulysses_fwd``/``_ulysses_bwd``).
    All peers' scattered heads go through one launch, the peers folded
    into the batch."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, block_q):
        scattered = [_scatter_heads(t, axis) for t in (q, k, v)]
        qg, kg, vg = (_fold(t) for t in scattered)
        out_g, lse = _local_fwd_impl(qg, kg, vg, causal, scale, block_q)
        ctx.save_for_backward(qg, kg, vg, out_g, lse)
        ctx.args = (axis, causal, scale, block_q,
                    [t.shape for t in scattered])
        return _gather_heads(out_g.view(scattered[0].shape), axis)

    @staticmethod
    def backward(ctx, g):
        qg, kg, vg, out_g, lse = ctx.saved_tensors
        axis, causal, scale, block_q, shapes = ctx.args
        # the cotangent is sequence-sharded like the output; move it to
        # the head-sharded layout the residuals live in
        do = _fold(_scatter_heads(g, axis)).float()
        delta = (do * out_g.float()).sum(dim=-1)
        grads = _fa.attention_block_backward(
            qg, kg, vg, do, lse, delta, 0, 0, causal=causal, scale=scale,
            block_q=block_q)
        return tuple(_gather_heads(d.view(shape).to(t.dtype), axis)
                     for d, t, shape in zip(grads, (qg, kg, vg), shapes)
                     ) + (None,) * 4


def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool, scale: float,
                          block_q: int = 512) -> torch.Tensor:
    """Non-collective flash attention over ``[B, T, H, D]`` (kv heads may
    divide the q heads): K1 with both offsets at 0, then ``o / l``; the
    backward takes ``delta = sum(do * out)`` and runs K2.  On CUDA tensors
    both are the hand-written kernels; on CPU tensors their plain
    versions."""
    return _UlyssesFlash.apply(q, k, v, None, bool(causal), float(scale),
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
                      axis: Optional[int] = None, causal: bool = False,
                      scale: Optional[float] = None,
                      use_pallas: bool = False, pallas_block_q: int = 512
                      ) -> torch.Tensor:
    """Exact attention over a sequence sharded across the sp peers stacked
    along dim ``axis`` (the JAX ``ulysses_attention`` over a mesh axis):
    each peer's block is the trailing ``[batch, block_len, heads,
    head_dim]``, and dims before it other than ``axis`` are further peers
    (stage, tp), each attending on its own.  One all-to-all scatters heads
    and gathers the sequence, every peer attends over the whole sequence
    for its ``heads / sp`` heads, and a second restores the sequence
    sharding.  ``axis=None``: q/k/v are one ``[B, T, H, D]`` block holding
    the whole sequence, and no all-to-all runs.

    On CUDA tensors the local attention is always K1, the backward K2
    with its own all-to-alls (``use_pallas`` selects nothing there); on
    the CPU ``use_pallas`` selects the kernels' plain versions, else the
    plain online-softmax path (the JAX ``_jnp_local_attention``) with
    gradients by autograd."""
    if q.ndim < 4 or (axis is None and q.ndim != 4):
        raise ValueError("expected [batch, block_len, heads, head_dim]")
    if k.shape[-2] != q.shape[-2] or v.shape[-2] != q.shape[-2]:
        raise ValueError(
            "ulysses scatters heads across the axis and needs equal q/kv "
            "head counts; grouped-query (GQA) kv is a ring_attention "
            "feature")
    n = 1
    if axis is not None:
        axis = int(axis) % q.ndim
        if axis >= q.ndim - 4:
            raise ValueError(f"axis {axis} must be a peer dim before the "
                             "[batch, block_len, heads, head_dim] block")
        n = q.shape[axis]
    H = q.shape[-2]
    if H % n:
        raise ValueError(
            f"ulysses SP needs heads ({H}) divisible by axis size ({n}); "
            "use ring_attention for uneven head counts")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if q.device.type == "cuda" or use_pallas:
        return _UlyssesFlash.apply(q, k, v, axis, bool(causal),
                                   float(scale), int(pallas_block_q))
    scattered = [_scatter_heads(t, axis) for t in (q, k, v)]
    out = _plain_local_attention(*(_fold(t) for t in scattered), causal,
                                 float(scale))
    return _gather_heads(out.view(scattered[0].shape), axis)
