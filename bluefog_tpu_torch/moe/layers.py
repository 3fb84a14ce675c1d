"""Routed-MoE layer primitives (counterpart of the serving half of
``bluefog_tpu/moe/layers.py``): the top-k softmax router and the
gate-weighted dropless combine on precomputed routing.  The router
statistics and the training sublayers come with MoE training."""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.expert import dropless_dispatch
from .dropless import grouped_ffn

__all__ = ["router_topk", "moe_dropless_combine"]


def router_topk(x: torch.Tensor, wr: torch.Tensor, *, top_k: int):
    """Softmax router: ``(logits, probs, topk_idx, topk_gate)`` for ``x
    [T, D]`` and ``wr [D, E]``.  For ``top_k > 1`` the kept gates are
    renormalized to sum to one.  On equal probabilities the lower expert
    index comes first, as ``lax.top_k`` orders them: the top k come from
    a descending sort that is stable in the index (``torch.topk`` promises
    no order among ties)."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k!r}")
    logits = x @ wr                                    # [T, E]
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt.values[:, :top_k], srt.indices[:, :top_k]
    if top_k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    return logits, probs, idx, gate


def moe_dropless_combine(
    x: torch.Tensor,              # [T, D]
    idx: torch.Tensor,            # [T, k] routed expert ids
    gate: torch.Tensor,           # [T, k] gates
    w1: torch.Tensor,             # [E, D, F]
    w2: torch.Tensor,             # [E, F, D]
    *,
    num_experts: int,
    tile: int = 8,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """The gate-weighted dropless grouped FFN on precomputed routing.
    Rows go out choice-major (``x`` tiled k times, ``idx.T`` flattened),
    so the tiles hold the rows the JAX function puts there.  The ids come
    from the router and lie in range, so this takes the unchecked
    dispatch and reads nothing back to the host."""
    T, D = x.shape
    k = idx.shape[1]
    x_rep = x.repeat(k, 1)                             # [k*T, D]
    flat_idx = idx.T.reshape(k * T)                    # choice-major

    def grouped(params, xt, tile_eid):
        return grouped_ffn(xt, tile_eid, *params, impl=impl)

    out = dropless_dispatch(x_rep, flat_idx, grouped, (w1, w2), num_experts,
                            tile)
    gates = gate.T[..., None].to(x.dtype)             # [k, T, 1]
    return (out.reshape(k, T, D) * gates).sum(0)
