"""Routed-MoE layer primitives (counterpart of
``bluefog_tpu/moe/layers.py``) at ep = 1: the top-k softmax router, the
gate-weighted dropless combine, the router statistics, and the training
sublayers (the dropless one and its dense-equivalent twin).

Every function takes one peer's tokens (``x [T, D]``, as the JAX
functions do) or the stacked peers of a composed tick (``x [*lead, T,
D]`` with every weight carrying the same leading dims).  The stacked form
folds every peer into ONE grouped-FFN call: the ids of peer ``p`` are
offset by ``p * E`` and the weights passed as ``[P, E, ...]`` views, so
K4 reads each peer's experts in place.  ``tp_dim`` names the leading dim
that holds the tensor-parallel peers; the JAX ``psum`` over ``"tp"``
becomes a sum over it (:func:`bluefog_tpu_torch.ops.collectives.psum`).
At ep = 1 the JAX ``psum`` over ``"expert"`` is the identity.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.collectives import psum
from ..parallel.expert import dropless_dispatch
from .dropless import grouped_ffn

__all__ = ["router_topk", "moe_dropless_combine", "moe_ffn_dropless",
           "moe_ffn_dense"]


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
                  num_experts: int) -> Dict[str, torch.Tensor]:
    """The JAX ``_router_stats`` at ep = 1, over the token dim ``-2`` of
    each peer: ``aux`` = E * sum(f * p) (f the first choices' dispatch
    fractions, p the mean probabilities), ``z`` the mean squared
    logsumexp, ``dropped`` 1 - the kept fraction (``keep`` over the last
    dim), ``entropy`` the mean token entropy, ``usage`` = f."""
    dt = probs.dtype
    f = F.one_hot(idx[..., 0].long(), num_experts).to(dt).mean(-2)
    p = probs.mean(-2)
    aux = num_experts * (f * p).sum(-1)
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean(-1)
    dropped = 1.0 - keep.to(dt).mean(-1)
    entropy = -(probs * torch.log(probs + 1e-20)).sum(-1).mean(-1)
    return {"aux": aux, "z": z, "dropped": dropped, "entropy": entropy,
            "usage": f}


def moe_dropless_combine(
    x: torch.Tensor,              # [*lead, T, D]
    idx: torch.Tensor,            # [*lead, T, k] routed expert ids
    gate: torch.Tensor,           # [*lead, T, k] gates
    w1: torch.Tensor,             # [*lead, E, D, F]
    w2: torch.Tensor,             # [*lead, E, F, D]
    *,
    num_experts: int,
    tile: int = 8,
    impl: Optional[str] = None,
    tp_dim: Optional[int] = None,
) -> torch.Tensor:
    """The gate-weighted dropless grouped FFN on precomputed routing.
    Rows go out choice-major (``x`` tiled k times, ``idx`` transposed and
    flattened per peer), so the tiles hold the rows the JAX function puts
    there; the stacked peers share one dispatch and one grouped-FFN call
    (peer ``p``'s experts are ``p * E .. p * E + E - 1``).  With
    ``tp_dim`` the grouped output is summed over the tp peers before the
    gate-weighted combine, as the JAX ``psum`` over ``"tp"`` inside
    ``grouped`` (there before the inverse permutation; each tp peer
    routes the same tokens alike, so the sum commutes with it bit for
    bit).  The ids come from the router and lie in range, so this takes
    the unchecked dispatch and reads nothing back to the host."""
    lead, (T, D) = x.shape[:-2], x.shape[-2:]
    k, E = idx.shape[-1], num_experts
    P = math.prod(lead)
    x_rep = x.reshape(P, T, D).repeat(1, k, 1)         # [P, k*T, D]
    flat = idx.reshape(P, T, k).transpose(1, 2).reshape(P, k * T)
    if P > 1:                                          # peer p's experts
        flat = flat + torch.arange(P, device=idx.device)[:, None] * E
    wk = (w1, w2) if not lead else (w1.reshape((P,) + w1.shape[-3:]),
                                     w2.reshape((P,) + w2.shape[-3:]))

    def grouped(params, xt, tile_eid):
        return grouped_ffn(xt, tile_eid, *params, impl=impl)

    out = dropless_dispatch(x_rep.reshape(P * k * T, D), flat.reshape(-1),
                            grouped, wk, P * E, tile)
    out = out.reshape(lead + (k, T, D))
    if tp_dim is not None:
        out = psum(out, tp_dim)
    gates = gate.movedim(-1, -2)[..., None].to(x.dtype)   # [*lead, k, T, 1]
    return (out * gates).sum(-3)


def moe_ffn_dropless(
    x: torch.Tensor,              # [*lead, T, D] (post-LN) tokens
    wr: torch.Tensor,             # [*lead, D, E] router
    w1: torch.Tensor,             # [*lead, E, D, F / TP]
    w2: torch.Tensor,             # [*lead, E, F / TP, D]
    *,
    num_experts: int,
    top_k: int,
    tile: int = 8,
    impl: Optional[str] = None,
    tp_dim: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One dropless routed expert-FFN sublayer: top-k router, sort-based
    grouped dispatch, the grouped FFN (K4 on the card), inverse
    permutation, gate-weighted sum.  Returns ``(y, stats)`` with
    ``stats["dropped"]`` exactly 0 (no capacity exists to drop at)."""
    T = x.shape[-2]
    logits, probs, idx, gate = router_topk(x, wr, top_k=top_k)
    y = moe_dropless_combine(x, idx, gate, w1, w2, num_experts=num_experts,
                             tile=tile, impl=impl, tp_dim=tp_dim)
    keep = torch.ones(x.shape[:-2] + (top_k * T,), dtype=torch.bool,
                      device=x.device)
    return y, _router_stats(logits, probs, idx, keep,
                            num_experts=num_experts)


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
    u = F.gelu(torch.einsum("...td,...edf->...etf", x, w1),
               approximate="tanh")
    o = torch.einsum("...etf,...efd->...etd", u, w2)
    if tp_dim is not None:
        o = psum(o, tp_dim)
    sel = F.one_hot(idx.long(), E).to(x.dtype)         # [*lead, T, k, E]
    y = torch.einsum("...tke,...etd,...tk->...td", sel, o, gate.to(x.dtype))
    keep = torch.ones(x.shape[:-2] + (top_k * x.shape[-2],),
                      dtype=torch.bool, device=x.device)
    return y, _router_stats(logits, probs, idx, keep, num_experts=E)
