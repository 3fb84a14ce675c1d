"""Routed-MoE layer primitives (counterpart of
``bluefog_tpu/moe/layers.py``): the top-k and expert-choice routers, the
router statistics, and the training sublayers: dropless (the grouped FFN,
K4 on the card), capacity dispatch (:func:`moe_ffn_routed`), expert
choice (:func:`moe_ffn_expert_choice`) and their dense-equivalent twins.

Every function takes one peer's tokens (``x [T, D]``, as the JAX
functions do; expert choice ``[B, T, D]``) or the stacked peers of a
composed tick (``x [*lead, T, D]`` with every weight carrying the same
leading dims).  ``tp_dim`` names the leading dim that holds the
tensor-parallel peers and ``ep_dim`` the expert-parallel ones, which must
be the innermost leading dim (the JAX flat order); a JAX ``psum`` over
``"tp"`` or ``"expert"`` becomes a sum over that dim
(:func:`bluefog_tpu_torch.ops.collectives.psum`) and an ``all_to_all``
over ``"expert"`` the stacked one.  Without ``ep_dim`` the expert axis
has size 1.  Expert weights are each peer's own ``[E_local, D, F / TP]``
block (all ``E`` experts at ep 1).

The dropless sublayer folds every peer of a tick into ONE dispatch and
ONE grouped-FFN call (owner ``p``'s experts at folded ids ``p * E_local +
e``, the weights passed as ``[P, E_local, ...]`` views that K4 reads in
place).  Capacity dispatch and expert choice compute their experts with
``torch.matmul`` (:func:`_expert_einsum`, a plain einsum in JAX too).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.collectives import all_to_all, peer_sum, psum
from ..parallel.expert import (capacity_combine, capacity_dispatch,
                               choice_major, dropless_dispatch, gate_sum)
from .dropless import grouped_ffn

__all__ = ["router_topk", "router_expert_choice", "moe_dropless_combine",
           "moe_ffn_dropless", "moe_ffn_routed", "moe_ffn_expert_choice",
           "moe_ffn_dense", "moe_ffn_dense_ec"]


def _ep(x: torch.Tensor, ep_dim: Optional[int], lead: int) -> int:
    """The expert-parallel peer count of a stacked ``x`` (1 without
    ``ep_dim``); ``ep_dim`` must be the innermost of the ``lead`` dims."""
    if ep_dim is None:
        return 1
    if ep_dim % x.ndim != lead - 1:
        raise ValueError(f"ep_dim {ep_dim} must be the innermost leading "
                         f"dim ({lead - 1}) of a {tuple(x.shape)} input: "
                         "the expert axis is innermost in the flat order")
    return x.shape[ep_dim]


def _psum(x: torch.Tensor, dim: Optional[int],
          lead: Optional[int] = None) -> torch.Tensor:
    return x if dim is None else psum(x, dim, lead)


def router_topk(x: torch.Tensor, wr: torch.Tensor, *, top_k: int):
    """Softmax router: ``(logits, probs, topk_idx, topk_gate)`` for ``x
    [..., T, D]`` and ``wr [..., D, E]``.  For ``top_k > 1`` the kept
    gates are renormalized to sum to one.  On equal probabilities the
    lower expert index comes first, as ``lax.top_k`` orders them: the top
    k come from a descending sort that is stable in the index
    (``torch.topk`` promises no order among ties)."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k!r}")
    logits = x @ wr                                    # [..., T, E]
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt.values[..., :top_k], srt.indices[..., :top_k]
    if top_k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    return logits, probs, idx, gate


def _router_stats(logits: torch.Tensor, probs: torch.Tensor,
                  idx: torch.Tensor, keep: torch.Tensor, *,
                  num_experts: int,
                  ep_dim: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The JAX ``_router_stats`` over the token dim ``-2`` of each peer:
    ``aux`` = E * sum(f_bar * p_bar), with ``f_bar`` (the first choices'
    dispatch fractions) and ``p_bar`` (the mean probabilities) each the
    sum over the expert-parallel peers of their ``1 / ep``-scaled shard
    means, so ``aux`` and ``usage`` (= ``f_bar``) are global; ``z`` the
    mean squared logsumexp, ``dropped`` 1 - the kept fraction (``keep``
    over the last dim) and ``entropy`` the mean token entropy stay
    shard-local."""
    ep = 1 if ep_dim is None else probs.shape[ep_dim]
    dt = probs.dtype
    f_part = F.one_hot(idx[..., 0].long(), num_experts).to(dt).mean(-2) / ep
    p_part = probs.mean(-2) / ep
    f_bar, p_bar = _psum(f_part, ep_dim), _psum(p_part, ep_dim)
    aux = num_experts * (f_bar * p_bar).sum(-1)
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean(-1)
    dropped = 1.0 - keep.to(dt).mean(-1)
    entropy = -(probs * torch.log(probs + 1e-20)).sum(-1).mean(-1)
    return {"aux": aux, "z": z, "dropped": dropped, "entropy": entropy,
            "usage": f_bar}


def _expert_einsum(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   tp_dim: Optional[int] = None) -> torch.Tensor:
    """Per-expert FFN on ``[..., E, T, D]`` token blocks: column-split
    w1, row-split w2, one psum over tp (the Megatron split inside every
    expert, so tp and ep compose)."""
    u = F.gelu(torch.matmul(h, w1), approximate="tanh")
    return _psum(torch.matmul(u, w2), tp_dim, h.ndim - 3)


def _groups(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[*lead, T, ...]`` as the dispatch cores' ``[Q, n, T, ...]``."""
    return x.reshape((-1, n) + tuple(x.shape[-2:]))


def moe_dropless_combine(
    x: torch.Tensor,              # [*lead, T, D]
    idx: torch.Tensor,            # [*lead, T, k] routed expert ids
    gate: torch.Tensor,           # [*lead, T, k] gates
    w1: torch.Tensor,             # [*lead, E_local, D, F]
    w2: torch.Tensor,             # [*lead, E_local, F, D]
    *,
    num_experts: int,
    tile: int = 8,
    impl: Optional[str] = None,
    tp_dim: Optional[int] = None,
    ep_dim: Optional[int] = None,
) -> torch.Tensor:
    """The gate-weighted dropless grouped FFN on precomputed routing.
    Rows go out choice-major (``x`` tiled k times, ``idx`` transposed and
    flattened per peer), so the tiles hold the rows the JAX function puts
    there; every peer shares one dispatch (over the ``ep_dim`` peers, the
    stacked ``all_to_all``s) and one grouped-FFN call, with owner ``p``'s
    experts at ``p * E_local ..``.  With ``tp_dim`` the grouped output is
    summed over the tp peers before the gate-weighted combine, as the JAX
    ``psum`` over ``"tp"`` inside ``grouped`` (there before the home
    ``all_to_all`` and the inverse sort; each tp peer routes the same
    tokens alike, so the sum commutes with them bit for bit), the peers
    added in order.  The ids
    come from the router and lie in range, so this takes the unchecked
    dispatch and reads nothing back to the host."""
    lead, (T, D) = x.shape[:-2], x.shape[-2:]
    k, n = idx.shape[-1], _ep(x, ep_dim, len(lead))
    P = math.prod(lead)
    x_rep, flat = choice_major(x, idx)
    wk = (w1, w2) if not lead else (w1.reshape((P,) + w1.shape[-3:]),
                                     w2.reshape((P,) + w2.shape[-3:]))

    def grouped(params, xt, tile_eid):
        return grouped_ffn(xt, tile_eid, *params, impl=impl,
                           rows=P * k * T)

    out = dropless_dispatch(_groups(x_rep, n), _groups(flat[..., None], n)
                            [..., 0], grouped, wk, num_experts, tile)
    out = out.reshape(lead + (k * T, D))
    if tp_dim is not None:
        out = peer_sum(out, tp_dim, len(lead)).unsqueeze(tp_dim) \
            .expand_as(out)
    return gate_sum(out, gate)


def moe_ffn_dropless(
    x: torch.Tensor,              # [*lead, T, D] (post-LN) tokens
    wr: torch.Tensor,             # [*lead, D, E] router
    w1: torch.Tensor,             # [*lead, E_local, D, F / TP]
    w2: torch.Tensor,             # [*lead, E_local, F / TP, D]
    *,
    num_experts: int,
    top_k: int,
    tile: int = 8,
    impl: Optional[str] = None,
    tp_dim: Optional[int] = None,
    ep_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One dropless routed expert-FFN sublayer: top-k router, sort-based
    grouped dispatch, the grouped FFN (K4 on the card), inverse
    permutation, gate-weighted sum.  Returns ``(y, stats)`` with
    ``stats["dropped"]`` exactly 0 (no capacity exists to drop at)."""
    T = x.shape[-2]
    logits, probs, idx, gate = router_topk(x, wr, top_k=top_k)
    y = moe_dropless_combine(x, idx, gate, w1, w2, num_experts=num_experts,
                             tile=tile, impl=impl, tp_dim=tp_dim,
                             ep_dim=ep_dim)
    keep = torch.ones(x.shape[:-2] + (top_k * T,), dtype=torch.bool,
                      device=x.device)
    return y, _router_stats(logits, probs, idx, keep,
                            num_experts=num_experts, ep_dim=ep_dim)


def moe_ffn_routed(
    x: torch.Tensor,              # [*lead, T, D] (post-LN) tokens
    wr: torch.Tensor,             # [*lead, D, E] router
    w1: torch.Tensor,             # [*lead, E_local, D, F / TP]
    w2: torch.Tensor,             # [*lead, E_local, F / TP, D]
    *,
    num_experts: int,
    top_k: int,
    capacity: int,
    tp_dim: Optional[int] = None,
    ep_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One capacity-dispatch sublayer: choice-major fused dispatch (one
    ``all_to_all`` round trip for all k choices, ``k * capacity`` pooled
    slots per (source, expert), first choices first), each owner's local
    experts by :func:`_expert_einsum`, combine, gate-weighted sum
    (dropped rows contribute zero).  Returns ``(y, stats)``."""
    lead, (T, D) = x.shape[:-2], x.shape[-2:]
    E, k = num_experts, top_k
    n = _ep(x, ep_dim, len(lead))
    e_local, cap = E // n, k * capacity
    logits, probs, idx, gate = router_topk(x, wr, top_k=k)
    x_rep, flat = choice_major(x, idx)
    flat = _groups(flat[..., None], n)[..., 0]
    expert_in, pos, keep = capacity_dispatch(
        _groups(x_rep, n), flat, capacity=cap, num_experts=E)
    Q = expert_in.shape[0]                   # [Q, o, s * E_local, C, D]
    h = expert_in.view(Q, n, n, e_local, cap, D).transpose(2, 3)
    h = h.reshape(lead + (e_local, n * cap, D))
    o = _expert_einsum(h, w1, w2, tp_dim)    # [*lead, E_local, n * C, D]
    o = o.reshape(Q, n, e_local, n, cap, D).transpose(2, 3)
    out = capacity_combine(o.reshape(Q, n, n * e_local, cap, D), flat, pos,
                           keep, capacity=cap, num_experts=E)
    y = gate_sum(out.reshape(lead + (k * T, D)), gate)
    return y, _router_stats(logits, probs, idx,
                            keep.reshape(lead + (k * T,)), num_experts=E,
                            ep_dim=ep_dim)


def moe_ffn_dense(
    x: torch.Tensor,              # [*lead, T, D]
    wr: torch.Tensor,             # [*lead, D, E]
    w1: torch.Tensor,             # [*lead, E, D, F / TP]: every expert
    w2: torch.Tensor,             # [*lead, E, F / TP, D]
    *,
    top_k: int,
    tp_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The dense-equivalent twin (the JAX float64 oracle's): identical
    router and gating, every expert computed on every token (the
    Megatron split inside each expert, summed over ``tp_dim``) and
    selected by a one-hot mask.  Tests and oracles only: E x the active
    operations."""
    E = w1.shape[-3]
    logits, probs, idx, gate = router_topk(x, wr, top_k=top_k)
    o = _expert_einsum(x.unsqueeze(-3), w1, w2, tp_dim)   # [*lead, E, T, D]
    sel = F.one_hot(idx.long(), E).to(x.dtype)         # [*lead, T, k, E]
    y = torch.einsum("...tke,...etd,...tk->...td", sel, o, gate.to(x.dtype))
    keep = torch.ones(x.shape[:-2] + (top_k * x.shape[-2],),
                      dtype=torch.bool, device=x.device)
    return y, _router_stats(logits, probs, idx, keep, num_experts=E)


def router_expert_choice(x: torch.Tensor, wr: torch.Tensor, *,
                         capacity: int):
    """Expert-choice router (Zhou et al. 2022): each expert takes its
    top-``capacity`` tokens per batch row by router probability.  ``x``
    is ``[..., B, T, D]`` (whole sequences: sp must be 1), ``wr [..., D,
    E]`` (its leading dims those of ``x`` before ``B``); returns ``(logits [..., B, T, E], probs, sel [..., B, E, C],
    gate [..., B, E, C])``.  Among equal probabilities the lower token
    index comes first, as ``lax.top_k`` orders them (a descending sort
    stable in the index)."""
    if x.ndim < 3:
        raise ValueError(
            f"router_expert_choice expects [B, T, D] tokens (whole "
            f"sequences; sp must be 1), got shape {tuple(x.shape)}")
    T = x.shape[-2]
    if not isinstance(capacity, int) or not 1 <= capacity <= T:
        raise ValueError(
            f"moe_ec_invalid_capacity: expert-choice capacity must be in "
            f"[1, seq_len={T}], got {capacity!r}")
    logits = x @ wr.unsqueeze(-3)                      # [..., B, T, E]
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs.transpose(-1, -2), dim=-1, descending=True,
                     stable=True)
    return logits, probs, srt.indices[..., :capacity], \
        srt.values[..., :capacity]


def _router_stats_ec(logits: torch.Tensor, probs: torch.Tensor,
                     sel: torch.Tensor, *, num_experts: int,
                     ep_dim: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Expert-choice stats: balance is structural (``usage`` = 1/E,
    ``aux`` = 0, ``dropped`` = 0); ``coverage``, the fraction of tokens
    picked by at least one expert, is summed over the expert-parallel
    peers of their ``1 / ep``-scaled shard means, like ``usage`` in the
    top-k path; ``z`` and ``entropy`` are shard-local means over [B, T]."""
    ep = 1 if ep_dim is None else probs.shape[ep_dim]
    dt = probs.dtype
    lead = logits.shape[:-3]
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean((-2, -1))
    entropy = -(probs * torch.log(probs + 1e-20)).sum(-1).mean((-2, -1))
    hit = torch.zeros(logits.shape[:-1], dtype=dt, device=logits.device)
    hit = hit.scatter(-1, sel.flatten(-2), 1.0)
    coverage = _psum(hit.mean((-2, -1)) / ep, ep_dim)
    zero = torch.zeros(lead, dtype=dt, device=logits.device)
    return {"aux": zero, "z": z, "dropped": zero, "entropy": entropy,
            "usage": torch.full(lead + (num_experts,), 1.0 / num_experts,
                                dtype=dt, device=logits.device),
            "coverage": coverage}


def _ec_scatter(x: torch.Tensor, sel: torch.Tensor, vals: torch.Tensor
                ) -> torch.Tensor:
    """``zeros_like(x)`` with ``vals [..., B, E, C, D]`` added at the
    tokens ``sel [..., B, E, C]`` picked (the JAX ``.at[b, sel].add``);
    the accumulating ``index_put`` sums a token's experts in a fixed
    order on the card (sort-based, no atomics)."""
    *lead, B, T, D = x.shape
    n = math.prod(lead) * B
    rows = (sel.reshape(n, -1)
            + (torch.arange(n, device=x.device) * T)[:, None]).reshape(-1)
    y = x.new_zeros((n * T, D)).index_put(
        (rows,), vals.reshape(-1, D).to(x.dtype), accumulate=True)
    return y.view(x.shape)


def moe_ffn_expert_choice(
    x: torch.Tensor,              # [*lead, B, T, D] each peer's sequences
    wr: torch.Tensor,             # [*lead, D, E] router
    w1: torch.Tensor,             # [*lead, E_local, D, F / TP]
    w2: torch.Tensor,             # [*lead, E_local, F / TP, D]
    *,
    num_experts: int,
    capacity: int,
    tp_dim: Optional[int] = None,
    ep_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One expert-choice sublayer: every expert gathers its top-C tokens
    per batch row into a statically balanced ``[E, B * C, D]`` buffer (no
    padding, nothing dropped), one ``all_to_all`` round trip over the
    expert-parallel peers, each owner's local experts by
    :func:`_expert_einsum`, and the gate-weighted outputs added back at
    the picked tokens.  Returns ``(y, stats)``."""
    lead, (B, T, D) = x.shape[:-3], x.shape[-3:]
    E, C = num_experts, capacity
    n = _ep(x, ep_dim, len(lead))
    e_local = E // n
    logits, probs, sel, gate = router_expert_choice(x, wr, capacity=C)
    idx = sel.reshape(lead + (B, E * C, 1)).expand(lead + (B, E * C, D))
    xe = x.gather(-2, idx).view(lead + (B, E, C, D))
    buf = xe.movedim(-4, -3).reshape((-1, n, E, B * C, D))
    recv = all_to_all(buf, 1, 2, 2)            # [Q, o, s * E_local, BC, D]
    Q = recv.shape[0]
    h = recv.view(Q, n, n, e_local, B * C, D).transpose(2, 3)
    o = _expert_einsum(h.reshape(lead + (e_local, n * B * C, D)), w1, w2,
                       tp_dim)
    o = o.reshape(Q, n, e_local, n, B * C, D).transpose(2, 3)
    back = all_to_all(o.reshape(Q, n, E, B * C, D), 1, 2, 2)
    oe = back.reshape(lead + (E, B, C, D)).movedim(-4, -3)  # [..B, E, C, D]
    y = _ec_scatter(x, sel, oe * gate[..., None].to(x.dtype))
    return y, _router_stats_ec(logits, probs, sel, num_experts=E,
                               ep_dim=ep_dim)


def moe_ffn_dense_ec(
    x: torch.Tensor,              # [*lead, B, T, D]
    wr: torch.Tensor,             # [*lead, D, E]
    w1: torch.Tensor,             # [*lead, E, D, F / TP]: every expert
    w2: torch.Tensor,             # [*lead, E, F / TP, D]
    *,
    capacity: int,
    tp_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dense-equivalent twin of expert choice: every expert computed on
    every token, then each expert's top-C token outputs selected by
    gather.  Tests and oracles only (E x the operations)."""
    lead, (B, T, D) = x.shape[:-3], x.shape[-3:]
    E = w1.shape[-3]
    logits, probs, sel, gate = router_expert_choice(x, wr, capacity=capacity)
    h = x.reshape(lead + (1, B * T, D))
    o = _expert_einsum(h, w1, w2, tp_dim)          # [*lead, E, B * T, D]
    oe = o.reshape(lead + (E, B, T, D)).movedim(-4, -3)   # [..B, E, T, D]
    C = sel.shape[-1]
    sel_out = oe.gather(-2, sel[..., None].expand(lead + (B, E, C, D)))
    y = _ec_scatter(x, sel, sel_out * gate[..., None].to(x.dtype))
    return y, _router_stats_ec(logits, probs, sel, num_experts=E)
