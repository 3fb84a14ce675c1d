"""Ring primitives and ring attention over stacked ranks (counterpart of
``bluefog_tpu/ops/ring.py``).

The JAX functions run inside ``shard_map``: each device holds one block
of the sequence and K/V blocks rotate around the ring by ``ppermute``.
Here the ranks live stacked along dim 0 of every tensor (``q, k, v``:
``[n, batch, block_len, heads, head_dim]``), so rotation is an index
along dim 0: ring step ``t`` hands rank ``i`` the block of rank ``src =
(i - t) % n`` (rank i receives from i - 1 at every step; :func:`ring_pass`
is the one-step roll that moves every block).

Two layouts, both exact causal (or, contiguous only, bidirectional or
windowed) attention over the whole sequence:

* ``contiguous``: rank i holds block i, at global offsets ``i * block_q``
  and ``src * block_k``.  With CUDA tensors (or ``use_pallas`` on the CPU)
  one ``torch.autograd.Function`` folds a K1 partial
  (:func:`~bluefog_tpu_torch.ops.flash_attention.attention_block_partial`)
  per visible block with ``merge_partials`` and keeps ``(q, k, v, out,
  lse)``; the backward runs its own ring of K2 calls whose dk/dv
  accumulate per source block in the order the JAX accumulators rotate.
  Otherwise the plain path, :func:`_plain_ring_attention` (online
  softmax, autograd).
* ``zigzag`` (causal only): the sequence is pre-permuted by
  :func:`zigzag_order`, so rank i holds chunks ``i`` and ``2n-1-i``.  A
  chunk pair is then wholly visible or wholly masked, except the two
  diagonal pairs of step 0, so the kernel path launches K1 (and K2 in the
  backward) once per class of chunk pair per ring step with every rank's
  pairs stacked on the batch dim: at step 0 the diagonal pairs (causal,
  relative offset 0) and the always-visible ``q_hi x k_lo`` pairs, at
  every later step the two visible pairs of each rank (``causal=False``):
  ``n + 1`` launches a call each way (:class:`_ZigzagFlash`).  The plain
  path is :func:`_plain_zigzag` (the JAX ``_zigzag_impl`` with jnp
  partials; autograd).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import flash_attention as _fa
from .collectives import allreduce

__all__ = ["ring_attention", "online_softmax_merge", "ring_pass",
           "ring_allreduce", "zigzag_order", "zigzag_inverse",
           "zigzag_positions"]


def ring_pass(x: torch.Tensor, *, shift: int = 1) -> torch.Tensor:
    """Rotate blocks around the ranks stacked on dim 0: rank i receives
    from rank ``i - shift`` (the JAX ``ppermute`` with pairs ``(i, i +
    shift)``)."""
    return torch.roll(x, shifts=shift, dims=0)


def ring_allreduce(x: torch.Tensor, *, average: bool = False
                   ) -> torch.Tensor:
    """The JAX name of :func:`~bluefog_tpu_torch.ops.collectives.allreduce`
    with the JAX default, the sum (what its reduce-scatter + all-gather
    leaves on each device)."""
    return allreduce(x, average=average)


def zigzag_order(n: int, total_len: int) -> np.ndarray:
    """Permutation putting a contiguous sequence into the zigzag layout:
    ``tokens[zigzag_order(n, T)]`` sharded contiguously over ``n`` ranks
    gives rank i chunks ``(i, 2n-1-i)`` of the original sequence."""
    if total_len % (2 * n):
        raise ValueError(f"sequence length {total_len} not divisible by 2n")
    C = total_len // (2 * n)
    chunks = np.arange(total_len).reshape(2 * n, C)
    order = [c for i in range(n) for c in (chunks[i], chunks[2 * n - 1 - i])]
    return np.concatenate(order)


def zigzag_inverse(n: int, total_len: int) -> np.ndarray:
    """Inverse permutation of :func:`zigzag_order` (zigzag ->
    contiguous)."""
    return np.argsort(zigzag_order(n, total_len))


def zigzag_positions(idx, n: int, chunk: int) -> torch.Tensor:
    """Global positions of rank ``idx``'s zigzag tokens (``[2 * chunk]``
    int32): chunk ``idx`` followed by chunk ``2n-1-idx``.  ``idx`` may be
    a 1-D tensor of ranks (``[len(idx), 2 * chunk]``), e.g.
    ``torch.arange(n)`` for every stacked rank at once."""
    idx = torch.as_tensor(idx, dtype=torch.int32)
    ar = torch.arange(chunk, dtype=torch.int32, device=idx.device)
    lo = idx[..., None] * chunk + ar
    hi = (2 * n - 1 - idx)[..., None] * chunk + ar
    return torch.cat([lo, hi], dim=-1)


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
    versions.  ``window`` (needs ``causal``, contiguous layout) masks keys
    more than ``window - 1`` tokens behind the query.  ``layout="zigzag"``
    (causal only) expects each rank's block in the balanced order of
    :func:`zigzag_order`: chunks ``(i, 2n-1-i)``."""
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
        if not causal:
            raise ValueError(
                "zigzag layout only pays for causal attention; use the "
                "contiguous layout for bidirectional")
        if q.shape[2] % 2:
            raise ValueError("zigzag needs an even per-device block length "
                             "(two chunks per device)")
        if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
            raise ValueError(
                "zigzag needs equal q/k/v block lengths (the chunk ids that "
                "drive the visibility table assume one shard layout)")
        if q.device.type == "cuda" or use_pallas:
            return _ZigzagFlash.apply(q, k, v, float(scale),
                                      int(pallas_block_q))
        return _plain_zigzag(q, k, v, float(scale))
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


# -- the zigzag layout ---------------------------------------------------

def _lo_hi(x: torch.Tensor, copies: int = 2) -> torch.Tensor:
    """``[n, B, 2C, ...] -> [copies * n, B, C, ...]``: every rank's low
    chunk, then every rank's high chunk (chunk ``i`` is rank i's sequence
    chunk i, chunk ``n + i`` its chunk 2n-1-i); ``copies=3`` repeats the
    high chunks once more, so that each ring step's q chunks are one
    slice (:func:`_zigzag_plan`)."""
    n, B, T2 = x.shape[:3]
    halves = x.reshape((n, B, 2, T2 // 2) + tuple(x.shape[3:]))
    lo, hi = halves[:, :, 0], halves[:, :, 1]
    return torch.cat([lo] + [hi] * (copies - 1))


def _from_lo_hi(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_lo_hi` (two copies)."""
    n2, B, C = x.shape[:3]
    y = x.reshape((2, n2 // 2, B, C) + tuple(x.shape[3:])).movedim(0, 2)
    return y.reshape((n2 // 2, B, 2 * C) + tuple(x.shape[3:]))


def _zigzag_plan(n: int, t: int):
    """Ring step ``t`` as ``(launches, q_folds, k_folds)``, over the chunks
    of :func:`_lo_hi`.

    A launch ``(causal, q0, rows, k_pieces)`` takes q chunks ``q0 .. q0 +
    rows - 1`` of ``[lo, hi, hi]`` (a slice) and the k/v chunks of the
    ``[a, b)`` pieces of ``[lo, hi]`` laid end to end; its row r pairs
    the r-th of each.  A fold ``(launch, r0, r1, chunk)`` adds rows ``[r0,
    r1)`` of a launch's result into q (or k) chunks ``chunk ..``; the
    folds run in the order the JAX step sums: a q chunk takes ``q_hi x
    k_lo`` before its other pair, a k chunk its other pair before ``q_hi
    x k_lo``.

    Step 0: ``q_hi x k_lo`` of every rank (wholly visible), then the
    diagonal pairs (causal at relative offset 0).  Step t >= 1, ranks
    enumerated ``i = t, ..., n-1, 0, ..., t-1`` so that the source ``s =
    (i - t) % n`` runs ``0 .. n-1``: rows ``0 .. n-1`` are ``q_lo[i] x
    k_lo[s]`` (i >= t) and ``q_hi[i] x k_hi[s]`` (i < t), rows ``n ..
    2n-1`` are ``q_hi[i] x k_lo[s]``; every pair is wholly visible, so
    the step is one launch."""
    if t == 0:
        return ([(False, n, n, [(0, n)]), (True, 0, 2 * n, [(0, 2 * n)])],
                [(0, 0, n, n), (1, 0, 2 * n, 0)],
                [(1, 0, 2 * n, 0), (0, 0, n, 0)])
    return ([(False, t, 2 * n, [(0, n - t), (2 * n - t, 2 * n), (0, n)])],
            [(0, n, 2 * n - t, n + t), (0, 2 * n - t, 2 * n, n),
             (0, 0, n, t)],
            [(0, 0, n - t, 0), (0, n - t, n, 2 * n - t), (0, n, 2 * n, 0)])


def _pieces(x: torch.Tensor, pieces) -> torch.Tensor:
    """Chunks ``[a, b)`` of ``x`` for each piece, end to end."""
    parts = [x[a:b] for a, b in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """``[rows, B, ...] -> [rows * B, ...]``, as the kernels take it."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _rows(parts, rows: int):
    """Each kernel result ``[rows * B, ...]`` as ``[rows, B, ...]``."""
    return [p.reshape((rows, -1) + tuple(p.shape[1:])) for p in parts]


class _ZigzagFlash(torch.autograd.Function):
    """The zigzag ring through K1/K2 (the JAX ``_zigzag_pallas`` and its
    backward): per ring step one launch per class of chunk pair, every
    rank's pairs of the class stacked on the batch dim (``n + 1`` launches
    each way, :func:`_zigzag_plan`).  q-side operands are slices of a
    ``[lo, hi, hi]`` copy made once a call; k/v are cut from ``[lo, hi]``
    with one concatenation a step.  The forward keeps ``(q, k, v, out,
    lse)``; the backward recomputes each pair's scores in K2 and
    accumulates dk/dv per source chunk in the order the JAX accumulators
    rotate."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block_q):
        n, dev = q.shape[0], q.device
        qw, ks, vs = _lo_hi(q, 3), _lo_hi(k), _lo_hi(v)
        shape = (2 * n,) + tuple(qw.shape[1:])
        o = torch.zeros(shape, dtype=torch.float32, device=dev)
        l = torch.zeros(shape[:4], dtype=torch.float32, device=dev)
        m = torch.full(shape[:4], float("-inf"), device=dev)
        for t in range(n):
            launches, q_folds, _ = _zigzag_plan(n, t)
            parts = [_rows(_fa.attention_block_partial(
                _fold_batch(qw[q0:q0 + rows]), _fold_batch(_pieces(ks, kp)),
                _fold_batch(_pieces(vs, kp)), 0, 0, causal=causal,
                scale=scale, block_q=block_q), rows)
                for causal, q0, rows, kp in launches]
            for j, r0, r1, c in q_folds:
                at = slice(c, c + r1 - r0)
                o[at], l[at], m[at] = _fa.merge_partials(
                    (o[at], l[at], m[at]), tuple(p[r0:r1] for p in parts[j]))
        denom = torch.where(l == 0.0, torch.ones_like(l), l)
        out = _from_lo_hi((o / denom[..., None]).to(q.dtype))
        lse = _from_lo_hi(torch.where(
            l == 0.0, torch.full_like(l, float("-inf")),
            m + torch.log(denom)))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, block_q)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        scale, block_q = ctx.args
        n, dev = q.shape[0], q.device
        do = g.float().contiguous()
        delta = (do * out.float()).sum(dim=-1)           # [n, B, 2C, H]
        qw, dow, lsew, dlw = (_lo_hi(x, 3) for x in (q, do, lse, delta))
        ks, vs = _lo_hi(k), _lo_hi(v)
        dq = torch.zeros((2 * n,) + tuple(qw.shape[1:]), dtype=torch.float32,
                         device=dev)
        dk = torch.zeros(ks.shape, dtype=torch.float32, device=dev)
        dv = torch.zeros(vs.shape, dtype=torch.float32, device=dev)
        for t in range(n):
            launches, q_folds, k_folds = _zigzag_plan(n, t)
            grads = []
            for causal, q0, rows, kp in launches:
                qt, dot, lset, dlt = (_fold_batch(x[q0:q0 + rows])
                                      for x in (qw, dow, lsew, dlw))
                grads.append(_rows(_fa.attention_block_backward(
                    qt, _fold_batch(_pieces(ks, kp)),
                    _fold_batch(_pieces(vs, kp)), dot, lset, dlt, 0, 0,
                    causal=causal, scale=scale, block_q=block_q), rows))
            for j, r0, r1, c in q_folds:
                dq[c:c + r1 - r0] += grads[j][0][r0:r1]
            for j, r0, r1, c in k_folds:
                dk[c:c + r1 - r0] += grads[j][1][r0:r1]
                dv[c:c + r1 - r0] += grads[j][2][r0:r1]
        return (_from_lo_hi(dq).to(q.dtype), _from_lo_hi(dk).to(k.dtype),
                _from_lo_hi(dv).to(v.dtype), None, None)


def _plain_zigzag(q, k, v, scale: float) -> torch.Tensor:
    """The plain path (JAX ``_zigzag_impl`` with jnp partials): per rank,
    its low and high chunks fold the visible chunk pairs of each ring step
    with an online softmax; gradients by autograd."""
    n, B, T2 = q.shape[:3]
    C = T2 // 2
    G = q.shape[3] // k.shape[3]
    ar = torch.arange(C, device=q.device)

    def partial(qc, kc, vc, q_off, k_off, masked):
        if G > 1:
            kc = kc.repeat_interleave(G, dim=2)
            vc = vc.repeat_interleave(G, dim=2)
        s = torch.einsum("bihd,bjhd->bihj", qc.float() * scale, kc.float())
        if masked:
            keep = (q_off + ar)[:, None] >= (k_off + ar)[None, :]
            s = s.masked_fill(~keep[None, :, None, :], float("-inf"))
        o = torch.zeros(qc.shape[:3] + vc.shape[-1:], dtype=torch.float32,
                        device=q.device)
        l = torch.zeros(qc.shape[:3], dtype=torch.float32, device=q.device)
        m = torch.full(qc.shape[:3], float("-inf"), device=q.device)
        return online_softmax_merge(o, l, m, s, vc)

    def fresh():
        return (torch.zeros((B, C) + q.shape[3:], dtype=torch.float32,
                            device=q.device),
                torch.zeros((B, C, q.shape[3]), dtype=torch.float32,
                            device=q.device),
                torch.full((B, C, q.shape[3]), float("-inf"),
                           device=q.device))

    def norm(olm):
        o, l, _ = olm
        return o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]

    outs = []
    for i in range(n):
        q_lo, q_hi = q[i][:, :C], q[i][:, C:]
        off_lo, off_hi = i * C, (2 * n - 1 - i) * C
        lo, hi = fresh(), fresh()
        for t in range(n):
            src = (i - t) % n
            k_lo, k_hi = k[src][:, :C], k[src][:, C:]
            v_lo, v_hi = v[src][:, :C], v[src][:, C:]
            koff_lo, koff_hi = src * C, (2 * n - 1 - src) * C
            if i >= src:
                lo = _fa.merge_partials(lo, partial(q_lo, k_lo, v_lo, off_lo,
                                                    koff_lo, True))
            hi = _fa.merge_partials(hi, partial(q_hi, k_lo, v_lo, off_hi,
                                                koff_lo, False))
            if src >= i:
                hi = _fa.merge_partials(hi, partial(q_hi, k_hi, v_hi, off_hi,
                                                    koff_hi, True))
        outs.append(torch.cat([norm(lo), norm(hi)], dim=1).to(q.dtype))
    return torch.stack(outs)
