"""Dropless expert dispatch (counterpart of
``bluefog_tpu/parallel/expert.py::moe_apply_dropless``) at an expert axis
of size 1.

There the JAX function's two ``all_to_all``s are identities: the wire
block ``recv`` is the expert-sorted, front-packed rows and the received
per-expert ``counts`` equal the local ``sizes``.  The rest is kept step
for step: regroup into the tile-padded buffer of
:func:`~bluefog_tpu_torch.moe.dropless.tile_layout` (rows past the block
total park on a trash row), run ``grouped_fn``, then invert every
permutation, so dispatch and combine with an identity ``grouped_fn`` are
the identity bit for bit.  An axis size above 1 raises "not yet ported".

Both functions carry gradients: the regroup and the inverse sort are
index writes into fresh zero buffers (``buf[slot] = recv``, ``y[order] =
...``), whose autograd transposes are the matching gathers, and the trash
row past the buffer is cut off before ``grouped_fn`` (as the JAX
function's ``[:n_pad]`` slice), so it takes no cotangent.
:func:`load_balancing_loss` is the JAX Switch-Transformer auxiliary loss.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..moe.dropless import dropless_rows, sort_by_expert, tile_layout

__all__ = ["moe_apply_dropless", "dropless_dispatch",
           "load_balancing_loss"]


def moe_apply_dropless(
    x: torch.Tensor,             # [T, D] (choice-tiled) rows
    expert_idx: torch.Tensor,    # [T] int: chosen expert per row
    grouped_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    expert_params: Any,
    *,
    axis: str = "expert",
    axis_size: int = 1,
    num_experts: Optional[int] = None,
    tile: int = 8,
) -> torch.Tensor:
    """Dropless MoE layer: stable sort by expert, grouped GEMM over the
    tile-padded buffer via ``grouped_fn(params, xt [n_tiles, tile, D],
    tile_eid [n_tiles])``, inverse permutation.  Out-of-range ids raise
    ``moe_routing_expert_idx_out_of_range`` (an eager check, which reads
    the ids back to the host)."""
    if axis_size != 1:
        raise ValueError(
            f"moe_apply_dropless over a '{axis}' axis of size {axis_size}: "
            "expert parallelism (ep > 1) is not yet ported to "
            "bluefog_tpu_torch")
    E = axis_size if num_experts is None else num_experts   # JAX default
    if not isinstance(E, (int, np.integer)) or E < 1:
        raise ValueError(
            f"moe num_experts={num_experts!r} must be a positive int")
    if expert_idx.numel():
        lo, hi = int(expert_idx.min()), int(expert_idx.max())
        if lo < 0 or hi >= E:
            raise ValueError(
                "moe_routing_expert_idx_out_of_range: expert_idx must lie "
                f"in [0, {E}), got min={lo} max={hi}; dropless dispatch "
                "would silently mis-route out-of-range rows")
    return dropless_dispatch(x, expert_idx, grouped_fn, expert_params, E,
                             tile)


def dropless_dispatch(x: torch.Tensor, expert_idx: torch.Tensor,
                      grouped_fn, expert_params, E: int,
                      tile: int) -> torch.Tensor:
    """:func:`moe_apply_dropless` without the range check: no value is
    read back to the host, so the serving hot path calls this."""
    T, D = x.shape
    safe_idx = torch.clamp(expert_idx, 0, E - 1)

    # -- source: stable sort by expert id (the one destination's rows are
    #    the whole, front-packed wire block)
    order, sizes, _rank = sort_by_expert(safe_idx, E)
    recv = x[order]
    counts = sizes                                    # [e_local]

    # -- destination: regroup the rows into the tile-padded buffer
    bounds = torch.cumsum(counts, 0)
    i = torch.arange(T, device=x.device)
    le = torch.searchsorted(bounds, i, right=True)
    valid = le < E                                    # i < block total
    le_c = torch.clamp(le, max=E - 1)
    lstart = bounds - counts
    grank = i - lstart[le_c]
    pad_start, tile_eid = tile_layout(counts, tile=tile, max_rows=T)
    n_pad = dropless_rows(T, E, tile)
    # invalid (beyond-count) rows park on a trash row past the buffer
    slot = torch.where(valid, pad_start[le_c] + grank,
                       torch.full_like(grank, n_pad))
    buf = torch.zeros((n_pad + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = recv
    xt = buf[:n_pad].reshape(n_pad // tile, tile, D)
    out = grouped_fn(expert_params, xt, tile_eid)
    if out.shape != xt.shape:
        raise ValueError("grouped_fn must preserve [n_tiles, tile, D] "
                         f"shape, got {tuple(out.shape)} for "
                         f"{tuple(xt.shape)}")
    o_pad = torch.cat([out.reshape(n_pad, D),
                       torch.zeros((1, D), dtype=out.dtype,
                                   device=out.device)])

    # -- home: invert the sort
    y = torch.zeros((T, D), dtype=out.dtype, device=out.device)
    y[order] = o_pad[slot]
    return y


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
