"""Ring attention over stacked ranks (counterpart of the contiguous layout
of ``bluefog_tpu/ops/ring.py``).

The JAX function runs inside ``shard_map``: each device holds one block
of the sequence and K/V blocks rotate around the ring by ``ppermute``.
Here the ranks live stacked along dim 0 of every tensor (``q, k, v``:
``[n, batch, block_len, heads, head_dim]``), so rotation is a roll along
dim 0: ring step ``t`` hands rank ``i`` the block of rank
``src = (i - t) % n`` (rank i receives from i - 1 at every step), at
global offsets ``i * block_q`` and ``src * block_k``.

:func:`ring_attention` with CUDA tensors (or ``use_pallas`` on the CPU)
goes through one ``torch.autograd.Function``: the forward folds K1
partials (:func:`~bluefog_tpu_torch.ops.flash_attention.attention_block_partial`)
with ``merge_partials`` and keeps ``(q, k, v, out, lse)``; the backward
runs its own ring of K2 calls whose dk/dv accumulate per source block in
the order the JAX accumulators rotate.  Otherwise it takes the plain
path, :func:`_plain_ring_attention` (online softmax, autograd).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import flash_attention as _fa

__all__ = ["ring_attention", "online_softmax_merge"]


def _block_visible(idx: int, src: int, blk_q: int, blk_k: int,
                   causal: bool, window: int) -> Optional[bool]:
    """Block-level visibility of K/V block ``src`` for rank ``idx``'s
    queries: False only when EVERY (q, k) position pair is masked —
    causally (whole block in the future) or by the sliding window (whole
    block more than ``window`` tokens behind)."""
    if not causal:
        return None                       # everything visible
    vis = idx * blk_q + blk_q - 1 >= src * blk_k
    if window:
        vis = vis and (idx * blk_q - (src * blk_k + blk_k - 1) < window)
    return vis


def online_softmax_merge(o, l, m, s, vt):
    """One flash-attention accumulation: fold the score block ``s`` (may
    contain ``-inf`` masked entries) and value block ``vt`` into the running
    ``(o, l, m)`` statistics.  Guards fully-masked rows (``m`` stays
    ``-inf``, their ``p`` contributes 0)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    zero = torch.zeros_like(m_new)
    safe_m = torch.where(torch.isneginf(m_new), zero, m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    corr = torch.where(torch.isneginf(m), zero, torch.exp(m - safe_m))
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum(
        "bihj,bjhd->bihd", p, vt.to(o.dtype))
    return o, l, m_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None,
                   use_pallas: bool = False, pallas_block_q: int = 512,
                   layout: str = "contiguous",
                   window: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence split into ``n`` stacked rank
    blocks: ``q`` ``[n, batch, block_len, heads, head_dim]``, ``k``/``v``
    with ``heads`` a multiple of their kv heads (GQA).  Returns each rank's
    output block, stacked like ``q``.

    On CUDA tensors the blocks always go through the K1/K2 kernels
    (``use_pallas`` is accepted for parity and selects nothing there); on
    the CPU ``use_pallas`` selects the same ring over the kernels' plain
    versions.  ``window`` (needs ``causal``) masks keys more than
    ``window - 1`` tokens behind the query.  Only the contiguous layout is
    ported."""
    if q.ndim != 5:
        raise ValueError(
            "expected stacked [n_ranks, batch, block_len, heads, head_dim]")
    if q.shape[3] % k.shape[3] or k.shape[3] != v.shape[3]:
        raise ValueError(
            f"q heads {q.shape[3]} must be a multiple of kv heads "
            f"{k.shape[3]} (grouped-query attention), with k/v matching")
    if k.shape[0] != q.shape[0] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} must stack the same ranks")
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if window is not None:
        if not causal:
            raise ValueError("sliding-window attention needs causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if layout == "zigzag":
            raise ValueError(
                "window is a contiguous-layout feature (the zigzag "
                "visibility table assumes full causal attention)")
    if layout == "zigzag":
        raise ValueError("the zigzag ring layout is not yet ported to "
                         "bluefog_tpu_torch; use layout='contiguous'")
    if q.device.type == "cuda" or use_pallas:
        return _RingFlash.apply(q, k, v, bool(causal), float(scale),
                                int(pallas_block_q), int(window or 0))
    return _plain_ring_attention(q, k, v, causal, float(scale), window or 0)


def _ring_forward(q, k, v, causal: bool, scale: float, block_q: int,
                  window: int):
    """Per rank: fold the visible K1 partials in ring order; returns the
    normalized output and the global log-sum-exp per q row."""
    n, blk_q, blk_k = q.shape[0], q.shape[2], k.shape[2]
    outs, lses = [], []
    for i in range(n):
        o = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[1:4], dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[1:4], float("-inf"), device=q.device)
        for t in range(n):
            src = (i - t) % n
            if _block_visible(i, src, blk_q, blk_k, causal, window) is False:
                continue
            part = _fa.attention_block_partial(
                q[i], k[src], v[src], i * blk_q, src * blk_k, causal=causal,
                scale=scale, block_q=block_q, window=window)
            o, l, m = _fa.merge_partials((o, l, m), part)
        denom = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((o / denom[..., None]).to(q.dtype))
        lses.append(torch.where(l == 0.0, torch.full_like(l, float("-inf")),
                                m + torch.log(denom)))
    return torch.stack(outs), torch.stack(lses)


class _RingFlash(torch.autograd.Function):
    """K1 forward, K2 backward: no ``[Tq, Tk]`` matrix is kept between
    the two (the backward recomputes scores block by block)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _ring_forward(q, k, v, causal, scale, block_q, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, window = ctx.args
        n, blk_q, blk_k = q.shape[0], q.shape[2], k.shape[2]
        do = g.float().contiguous()
        delta = (do * out.float()).sum(dim=-1)           # [n, B, Tq, H]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        # step t, rank i holds block src = (i - t) % n; block src's dk/dv
        # gather the contributions of ranks src, src + 1, ... in that
        # order, as the JAX accumulators rotating with their block do
        for t in range(n):
            for i in range(n):
                src = (i - t) % n
                if _block_visible(i, src, blk_q, blk_k, causal,
                                  window) is False:
                    continue
                dq_p, dk_p, dv_p = _fa.attention_block_backward(
                    q[i], k[src], v[src], do[i], lse[i], delta[i],
                    i * blk_q, src * blk_k, causal=causal, scale=scale,
                    block_q=block_q, window=window)
                dq[i] += dq_p
                dk[src] += dk_p
                dv[src] += dv_p
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _plain_ring_attention(q, k, v, causal: bool, scale: float,
                          window: int = 0) -> torch.Tensor:
    """The plain path (JAX ``_jnp_ring_attention``): per rank, an online
    softmax over the visible K/V blocks in ring order; gradients by
    autograd."""
    n, blk_q, blk_k = q.shape[0], q.shape[2], k.shape[2]
    G = q.shape[3] // k.shape[3]
    outs = []
    for i in range(n):
        qf = q[i].float() * scale
        q_pos = i * blk_q + torch.arange(blk_q, device=q.device)
        o = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[1:4], dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[1:4], float("-inf"), device=q.device)
        for t in range(n):
            src = (i - t) % n
            if _block_visible(i, src, blk_q, blk_k, causal, window) is False:
                continue
            kt, vt = k[src], v[src]
            if G > 1:
                kt = kt.repeat_interleave(G, dim=2)
                vt = vt.repeat_interleave(G, dim=2)
            s = torch.einsum("bihd,bjhd->bihj", qf, kt.float())
            if causal:
                k_pos = src * blk_k + torch.arange(blk_k, device=q.device)
                diff = q_pos[:, None, None] - k_pos[None, None, :]
                keep = diff >= 0
                if window:
                    keep = keep & (diff < window)
                s = s.masked_fill(~keep[None], float("-inf"))
            o, l, m = online_softmax_merge(o, l, m, s, vt)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((o / l[..., None]).to(q.dtype))
    return torch.stack(outs)
