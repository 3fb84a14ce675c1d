"""Expert parallelism over stacked peers (counterpart of
``bluefog_tpu/parallel/expert.py``): the capacity dispatch
(:func:`moe_dispatch`, :func:`moe_combine`, :func:`moe_apply`,
:func:`moe_apply_topk`) and the dropless one (:func:`moe_apply_dropless`).

The JAX functions run on one device of an ``expert`` mesh axis of size
``n``; device ``d`` owns the contiguous experts ``[d * E_local, (d + 1) *
E_local)``.  Here the ``n`` peers of the axis are stacked on dim 0 of
every per-peer tensor (``x [n, T, D]``, ``expert_idx [n, T]``) and each
``lax.all_to_all`` is the stacked
:func:`~bluefog_tpu_torch.ops.collectives.all_to_all` over that dim; at
``axis_size`` 1 the tensors are one peer's (``x [T, D]``), as in JAX.
The expert work runs once for every owner: ``expert_fn`` of
:func:`moe_apply` gets the owners' token blocks stacked ``[n, rows, D]``
(``[rows, D]`` at size 1), and ``grouped_fn`` of
:func:`moe_apply_dropless` gets every owner's tile-padded buffer in ONE
call, owner ``p``'s tiles with the folded ids ``p * E_local + e`` (the
layout :func:`~bluefog_tpu_torch.moe.dropless.grouped_ffn` reads from
``[n, E_local, ...]`` weights in place) and ``-1`` on the tiles past an
owner's last group (zero rows: the grouped FFN skips them and answers
zeros).

The public functions keep the JAX guards and texts; their range checks
read the ids back to the host.  The trainer calls the unchecked cores
(:func:`dropless_dispatch`, :func:`capacity_dispatch`,
:func:`capacity_combine`) on the composed carving's peers, ``x [Q, n, T,
D]`` (``Q`` the other peers of a tick: stage, tp, sp), which read
nothing back.

Every function carries gradients: the scatters into fresh zero buffers
(``index_put``) transpose to gathers, and the trash row past a dropless
buffer is cut off before ``grouped_fn`` (the JAX ``[:n_pad]`` slice), so
it takes no cotangent.  :func:`load_balancing_loss` is the JAX
Switch-Transformer auxiliary loss.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..moe.dropless import (dropless_rows, mark_trash_tiles, sort_by_expert,
                            tile_layout)
from ..ops.collectives import all_to_all

__all__ = ["moe_dispatch", "moe_combine", "moe_apply", "moe_apply_topk",
           "moe_apply_dropless", "dropless_dispatch", "capacity_dispatch",
           "capacity_combine", "choice_major", "gate_sum",
           "load_balancing_loss"]


def _resolve_num_experts(axis: str, n: int,
                         num_experts: Optional[int]) -> int:
    E = n if num_experts is None else num_experts
    if not isinstance(E, (int, np.integer)) or E < 1:
        raise ValueError(
            f"moe num_experts={num_experts!r} must be a positive int")
    if E % n:
        raise ValueError(
            f"moe num_experts ({E}) must be a multiple of the '{axis}' "
            f"axis size ({n}): each device owns a contiguous block of "
            "num_experts // axis_size experts")
    return int(E)


def _check_range(expert_idx: torch.Tensor, E: int, what: str) -> None:
    """The JAX eager range check (it reads the ids back to the host)."""
    if expert_idx.numel():
        lo, hi = int(expert_idx.min()), int(expert_idx.max())
        if lo < 0 or hi >= E:
            raise ValueError(
                "moe_routing_expert_idx_out_of_range: expert_idx must lie "
                f"in [0, {E}), got min={lo} max={hi}; {what}")


def _lead(n: int) -> tuple:
    """The index that gives one axis's tensors (``[T, ...]`` at size 1,
    ``[n, T, ...]`` above) the cores' leading ``[1, n]`` dims; indexing a
    core's result with ``(0,) * len(_lead(n))`` takes them off again."""
    return (None, None) if n == 1 else (None,)


def _stack(x: torch.Tensor, expert_idx: torch.Tensor, n: int, what: str):
    """One axis's peers as the cores' ``[1, n, T, ...]``."""
    want = 2 if n == 1 else 3
    if x.ndim != want or expert_idx.shape != x.shape[:-1] or (
            n > 1 and x.shape[0] != n):
        lead = "" if n == 1 else f"{n}, "
        raise ValueError(f"{what} over an axis of size {n} wants x "
                         f"[{lead}T, D] and expert_idx [{lead}T], got "
                         f"{tuple(x.shape)} / {tuple(expert_idx.shape)}")
    return x[_lead(n)], expert_idx[_lead(n)]


# ---------------------------------------------------------------------------
# Capacity dispatch
# ---------------------------------------------------------------------------

def _routing(expert_idx: torch.Tensor, num_experts: int, capacity: int,
             check: bool = True):
    """Per-row slot position within its expert and whether it is kept,
    over the last dim of ``expert_idx``.  Guards: ``capacity`` must be a
    positive static int, and (``check``) ids out of ``[0, num_experts)``
    raise ``moe_routing_expert_idx_out_of_range``; unchecked, an
    out-of-range row is dropped."""
    if not isinstance(capacity, (int, np.integer)) or capacity <= 0:
        raise ValueError(
            "moe_routing_invalid_capacity: capacity must be a positive "
            f"static int, got {capacity!r}; a non-positive capacity drops "
            "every token (capacity = ceil(capacity_factor * tokens / "
            "num_experts) — raise the capacity factor)")
    if check:
        _check_range(expert_idx, num_experts, "out-of-range indices would "
                     "silently produce garbage one-hots")
    in_range = (expert_idx >= 0) & (expert_idx < num_experts)
    safe = torch.clamp(expert_idx, 0, num_experts - 1).long()
    onehot = torch.nn.functional.one_hot(safe, num_experts) \
        * in_range[..., None]
    pos = ((torch.cumsum(onehot, -2) - 1) * onehot).sum(-1)
    keep = (pos < capacity) & in_range
    return pos, keep


def capacity_dispatch(x: torch.Tensor, expert_idx: torch.Tensor, *,
                      capacity: int, num_experts: int,
                      check: bool = False):
    """The stacked core of :func:`moe_dispatch`: ``x [Q, n, T, D]`` rows
    of ``Q`` groups of ``n`` expert-parallel peers, ``expert_idx [Q, n,
    T]``.  Returns ``(expert_in [Q, n, n * E_local, capacity, D], pos,
    keep)``: owner ``o``'s block ``[s * E_local + e]`` holds the rows
    source ``s`` sent to its local expert ``e``.

    Each kept (expert, slot) gets exactly one row and a dropped row adds
    ``x * 0`` to slot ``capacity - 1``, so the accumulating scatter gives
    the same sums whatever order its atomics run in."""
    Q, n, T, D = x.shape
    E = num_experts
    pos, keep = _routing(expert_idx, E, capacity, check)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    safe = torch.clamp(expert_idx, 0, E - 1).long()
    q = torch.arange(Q, device=x.device)[:, None, None].expand(Q, n, T)
    s = torch.arange(n, device=x.device)[None, :, None].expand(Q, n, T)
    buf = x.new_zeros((Q, n, E, capacity, D)).index_put(
        (q, s, safe, slot), x * keep[..., None].to(x.dtype),
        accumulate=True)
    # source s's expert block e -> owner e // E_local's source block s
    return all_to_all(buf, 1, 2, 2), pos, keep


def capacity_combine(expert_out: torch.Tensor, expert_idx: torch.Tensor,
                     pos: torch.Tensor, keep: torch.Tensor, *,
                     capacity: int, num_experts: int) -> torch.Tensor:
    """The stacked core of :func:`moe_combine`: ``expert_out [Q, n, n *
    E_local, capacity, D]`` home to ``[Q, n, T, D]``; dropped rows come
    back as zeros."""
    back = all_to_all(expert_out, 1, 2, 2)        # [Q, n, E, capacity, D]
    Q, n, T = expert_idx.shape
    slot = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    safe = torch.clamp(expert_idx, 0, num_experts - 1).long()
    q = torch.arange(Q, device=back.device)[:, None, None].expand(Q, n, T)
    s = torch.arange(n, device=back.device)[None, :, None].expand(Q, n, T)
    y = back[q, s, safe, slot]
    return y * keep[..., None].to(y.dtype)


def moe_dispatch(x: torch.Tensor, expert_idx: torch.Tensor, *,
                 capacity: int, axis: str = "expert", axis_size: int = 1,
                 num_experts: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route rows to their experts' owners: ``(expert_in [(n,) n *
    E_local, capacity, D], pos, keep)`` for ``x [(n,) T, D]``; owner
    ``o``'s ``expert_in.reshape(n, E_local, capacity, D)[s, e]`` holds the
    rows source ``s`` routed to its local expert ``e`` (zeros in unused
    slots)."""
    E = _resolve_num_experts(axis, axis_size, num_experts)
    x4, i3 = _stack(x, expert_idx, axis_size, "moe_dispatch")
    out, pos, keep = capacity_dispatch(x4, i3, capacity=capacity,
                                       num_experts=E, check=True)
    home = (0,) * len(_lead(axis_size))
    return out[home], pos[home], keep[home]


def moe_combine(expert_out: torch.Tensor, expert_idx: torch.Tensor,
                pos: torch.Tensor, keep: torch.Tensor, *, capacity: int,
                axis: str = "expert", axis_size: int = 1,
                num_experts: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`moe_dispatch`: bring each row's output home.
    Dropped rows come back as zeros."""
    E = _resolve_num_experts(axis, axis_size, num_experts)
    ix = _lead(axis_size)
    y = capacity_combine(expert_out[ix], expert_idx[ix], pos[ix], keep[ix],
                         capacity=capacity, num_experts=E)
    return y[(0,) * len(ix)]


def moe_apply(x: torch.Tensor, expert_idx: torch.Tensor,
              expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Any, *, capacity: int, axis: str = "expert",
              axis_size: int = 1,
              num_experts: Optional[int] = None) -> torch.Tensor:
    """Dispatch, the owners' experts, combine (one MoE layer).
    ``expert_fn(params, tokens)`` gets each owner's flattened ``[n *
    E_local * capacity, D]`` rows (stacked ``[n, ...]`` over the owners
    at ``axis_size`` > 1, with ``expert_params`` as given) and must keep
    their shape."""
    expert_in, pos, keep = moe_dispatch(
        x, expert_idx, capacity=capacity, axis=axis, axis_size=axis_size,
        num_experts=num_experts)
    *lead, rows, cap, D = expert_in.shape
    flat = expert_in.reshape(tuple(lead) + (rows * cap, D))
    expert_out = expert_fn(expert_params, flat)
    if expert_out.shape != flat.shape:
        raise ValueError("expert_fn must preserve [tokens, D] shape")
    return moe_combine(expert_out.reshape(expert_in.shape), expert_idx, pos,
                       keep, capacity=capacity, axis=axis,
                       axis_size=axis_size, num_experts=num_experts)


def moe_apply_topk(x: torch.Tensor, topk_idx: torch.Tensor,
                   topk_gate: torch.Tensor,
                   expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   expert_params: Any, *, capacity: int,
                   axis: str = "expert", axis_size: int = 1,
                   fused: bool = True,
                   num_experts: Optional[int] = None) -> torch.Tensor:
    """Top-k routed MoE layer: the k choices stacked choice-major into ONE
    dispatch and combine with ``k * capacity`` pooled slots per (source,
    expert), every first choice ahead of any second (the GShard
    priority); ``fused=False`` runs k independent dispatches of
    ``capacity`` slots each."""
    if topk_idx.ndim != x.ndim or topk_idx.shape != topk_gate.shape:
        raise ValueError(
            f"topk_idx/topk_gate must both be [tokens, k], got "
            f"{tuple(topk_idx.shape)} / {tuple(topk_gate.shape)}")
    k = topk_idx.shape[-1]
    kw = dict(axis=axis, axis_size=axis_size, num_experts=num_experts)
    if not fused:
        y = torch.zeros_like(x)
        for j in range(k):
            out = moe_apply(x, topk_idx[..., j], expert_fn, expert_params,
                            capacity=capacity, **kw)
            y = y + out * topk_gate[..., j:j + 1].to(x.dtype)
        return y
    x_rep, flat_idx = choice_major(x, topk_idx)
    out = moe_apply(x_rep, flat_idx, expert_fn, expert_params,
                    capacity=k * capacity, **kw)
    return gate_sum(out, topk_gate)


def choice_major(x: torch.Tensor, idx: torch.Tensor):
    """``(x_rep [*lead, k * T, D], flat [*lead, k * T])`` for ``x [*lead,
    T, D]`` and ``idx [*lead, T, k]``: the k choices as virtual rows,
    choice-major (every first choice ahead of any second)."""
    k, T = idx.shape[-1], x.shape[-2]
    x_rep = x.repeat((1,) * (x.ndim - 2) + (k, 1))
    return x_rep, idx.transpose(-1, -2).reshape(x.shape[:-2] + (k * T,))


def gate_sum(out: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``sum_j out[j] * gate[..., j]`` over the choice-major ``out
    [*lead, k * T, D]`` and ``gate [*lead, T, k]``."""
    k, T, D = gate.shape[-1], gate.shape[-2], out.shape[-1]
    out = out.reshape(out.shape[:-2] + (k, T, D))
    gates = gate.movedim(-1, -2)[..., None].to(out.dtype)  # [*lead, k, T, 1]
    return (out * gates).sum(-3)


# ---------------------------------------------------------------------------
# Dropless dispatch
# ---------------------------------------------------------------------------

def moe_apply_dropless(
    x: torch.Tensor,             # [(n,) T, D] (choice-tiled) rows
    expert_idx: torch.Tensor,    # [(n,) T] int: chosen expert per row
    grouped_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    expert_params: Any,
    *,
    axis: str = "expert",
    axis_size: int = 1,
    num_experts: Optional[int] = None,
    tile: int = 8,
) -> torch.Tensor:
    """Dropless MoE layer over an expert axis of ``axis_size`` stacked
    peers: each peer's stable sort by expert id, per-destination wire
    blocks of ``T`` rows and the per-(source, expert) counts through the
    stacked ``all_to_all``, each owner's regroup into the tile-padded
    buffer, ``grouped_fn(params, xt, tile_eid)`` once over every owner's
    buffer (folded ids, ``-1`` on trash tiles; see the module
    docstring), the home ``all_to_all`` and the inverse sort.  No row is
    dropped, and with an identity ``grouped_fn`` dispatch and combine are
    the identity bit for bit.  Out-of-range ids raise
    ``moe_routing_expert_idx_out_of_range`` (an eager check, which reads
    the ids back to the host)."""
    E = _resolve_num_experts(axis, axis_size, num_experts)
    x4, i3 = _stack(x, expert_idx, axis_size, "moe_apply_dropless")
    _check_range(expert_idx, E, "dropless dispatch would silently "
                 "mis-route out-of-range rows")
    y = dropless_dispatch(x4, i3, grouped_fn, expert_params, E, tile)
    return y[(0,) * len(_lead(axis_size))]


def dropless_dispatch(x: torch.Tensor, expert_idx: torch.Tensor,
                      grouped_fn, expert_params, E: int,
                      tile: int) -> torch.Tensor:
    """The core of :func:`moe_apply_dropless` without the range check (no
    value is read back to the host, so the serving and training hot paths
    call it): ``x [Q, n, T, D]`` (or one peer's ``[T, D]``), ``expert_idx
    [Q, n, T]`` global ids in ``[0, E)``, ``n`` the expert-parallel
    peers.  Every owner of every group goes into ONE ``grouped_fn``
    call: owner ``(q, o)``'s tiles at ``(q * n + o) * n_tiles ..`` with
    ids ``(q * n + o) * E_local + e``, ``-1`` past its last group."""
    one = x.ndim == 2
    if one:
        x, expert_idx = x[None, None], expert_idx[None, None]
    Q, n, T, D = x.shape
    e_local = E // n
    dev = x.device
    safe = torch.clamp(expert_idx, 0, E - 1)
    P = Q * n                                      # every peer, flat

    # -- source: each peer's stable sort by expert id, its rows packed to
    #    the front of each destination's wire block of T rows
    order, sizes, _ = sort_by_expert(safe.reshape(P, T), E)   # per peer
    base = (torch.arange(P, device=dev) * T)[:, None]
    src_rows = (order + base).reshape(-1)          # flat rows, sorted order
    x_sorted = x.reshape(P * T, D)[src_rows]
    if n > 1:
        eid_sorted = safe.reshape(P, T).gather(1, order)
        dst = eid_sorted // e_local
        d_counts = sizes.view(P, n, e_local).sum(-1)          # [P, n]
        d_start = torch.cumsum(d_counts, -1) - d_counts
        src_slot = dst * T + (torch.arange(T, device=dev)
                              - d_start.gather(1, dst))       # [P, T]
        wire = (src_slot + base * n).reshape(-1)
        send = x.new_zeros((P * n * T, D))
        send[wire] = x_sorted
        recv = all_to_all(send.view(Q, n, n, T, D), 1, 2, 2)  # [Q, o, s]
        counts = all_to_all(sizes.view(Q, n, n, e_local), 1, 2, 2)
    else:
        recv = x_sorted.view(Q, 1, 1, T, D)
        counts = sizes.view(Q, 1, 1, E)

    # -- owner: regroup the received rows (front-packed per source block,
    #    expert-sorted within) into the tile-padded buffer
    bounds = torch.cumsum(counts, -1)                  # [Q, o, s, e]
    i = torch.arange(T, device=dev)
    le = torch.searchsorted(bounds, i.expand(Q, n, n, T).contiguous(),
                            right=True)
    valid = le < e_local                               # i < block total
    le_c = torch.clamp(le, max=e_local - 1)
    lstart = bounds - counts
    src_off = torch.cumsum(counts, 2) - counts         # earlier sources
    grank = i - lstart.gather(-1, le_c) + src_off.gather(-1, le_c)
    gsz = counts.sum(2)                                # [Q, o, e]
    pad_start, tile_eid = tile_layout(gsz, tile=tile, max_rows=n * T)
    n_pad = dropless_rows(n * T, e_local, tile)
    # invalid (beyond-count, all-zero) rows park on a trash row past each
    # owner's buffer; it is cut off before grouped_fn
    slot = torch.where(valid, pad_start.unsqueeze(2).expand(
        Q, n, n, e_local).gather(-1, le_c) + grank,
        torch.full_like(grank, n_pad))
    slot = (slot.view(P, n * T)
            + (torch.arange(P, device=dev) * (n_pad + 1))[:, None]
            ).reshape(-1)
    buf = x.new_zeros((P * (n_pad + 1), D))
    buf[slot] = recv.reshape(P * n * T, D)
    xt = buf.view(P, n_pad + 1, D)[:, :n_pad].reshape(-1, tile, D)
    eids = mark_trash_tiles(gsz, tile_eid, tile=tile).view(P, -1)
    eids = torch.where(eids >= 0, eids + (torch.arange(P, device=dev)
                                          * e_local)[:, None], eids)
    out = grouped_fn(expert_params, xt, eids.reshape(-1).to(torch.int32))
    if out.shape != xt.shape:
        raise ValueError("grouped_fn must preserve [n_tiles, tile, D] "
                         f"shape, got {tuple(out.shape)} for "
                         f"{tuple(xt.shape)}")
    o_pad = torch.cat([out.view(P, n_pad, D),
                       out.new_zeros((P, 1, D))], 1).view(-1, D)
    back = o_pad[slot]

    # -- home: invert the wire blocks, then the sort
    if n > 1:
        home = all_to_all(back.view(Q, n, n, T, D), 1, 2, 2)
        y_sorted = home.reshape(P * n * T, D)[wire]
    else:
        y_sorted = back
    y = x.new_zeros((P * T, D), dtype=out.dtype)
    y[src_rows] = y_sorted
    y = y.view(Q, n, T, D)
    return y[0, 0] if one else y


def load_balancing_loss(router_probs: torch.Tensor,
                        expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary load-balancing loss for one peer's
    tokens: ``E * sum_e fraction_routed_e * mean_router_prob_e``, with
    ``router_probs`` the full softmax ``[T, E]`` and ``expert_idx`` the
    (top-1) assignment actually dispatched.  Minimized (value 1.0) by
    uniform routing; differentiable in ``router_probs``."""
    num_experts = router_probs.shape[-1]
    f = torch.nn.functional.one_hot(expert_idx.long(), num_experts).to(
        router_probs.dtype).mean(0)
    p = router_probs.mean(0)
    return num_experts * (f * p).sum()
