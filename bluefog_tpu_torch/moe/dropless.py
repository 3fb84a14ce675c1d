"""Dropless MoE building blocks: sort-based grouping and the grouped GEMM
(counterpart of ``bluefog_tpu/moe/dropless.py``).

Rows are stable-sorted by expert id into contiguous per-expert groups;
each group is padded up to a multiple of a small ``tile`` in a buffer
sized for the worst case (:func:`dropless_rows`), and ``tile_eid`` (one
expert id per tile) drives the grouped expert FFN.  Every size here comes
from static arguments, never from the data, so nothing on this path waits
for the device.  The tiles past the last group's pad hold only zero rows
(about half the buffer of an expert-parallel owner, sized for every
source sending it all its rows): :func:`mark_trash_tiles` gives them the
id ``-1``, which the grouped FFN skips and answers with zeros.

:func:`grouped_ffn` keeps the JAX ``impl`` token and
``BLUEFOG_MOE_GROUPED_IMPL`` with their error text, but they select
nothing: CUDA tensors always take the hand-written kernel K4
(:mod:`bluefog_tpu_torch.ops.grouped_ffn`) and CPU tensors its plain
version, :func:`grouped_ffn_xla`.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..ops import grouped_ffn as _gf
from ..ops.grouped_ffn import grouped_ffn_plain as grouped_ffn_xla

__all__ = ["dropless_rows", "tile_layout", "mark_trash_tiles",
           "sort_by_expert", "decode_tile", "grouped_ffn", "grouped_ffn_xla"]


def dropless_rows(max_rows: int, num_groups: int, tile: int) -> int:
    """Static row count of the tile-padded grouped buffer: ``max_rows``
    data rows plus at most ``tile - 1`` pad rows per group, rounded up to
    a whole number of tiles."""
    if not isinstance(tile, (int,)) or tile < 1:
        raise ValueError(f"moe_dropless_invalid_tile: group tile must be "
                         f"a positive static int, got {tile!r}")
    worst = max_rows + num_groups * (tile - 1)
    return ((worst + tile - 1) // tile) * tile


def decode_tile(max_rows: int, num_groups: int, cap: int = 8) -> int:
    """Decode-regime tile: the smallest power of two that could hold an
    even split of ``max_rows`` rows over ``num_groups`` expert groups,
    capped at ``cap``."""
    if max_rows < 1 or num_groups < 1 or cap < 1:
        raise ValueError(
            f"moe_dropless_invalid_tile: decode_tile needs positive "
            f"max_rows/num_groups/cap, got ({max_rows}, {num_groups}, "
            f"{cap})")
    want = -(-max_rows // num_groups)
    tile = 1
    while tile < want and tile < cap:
        tile *= 2
    return min(tile, cap)


def tile_layout(sizes: torch.Tensor, *, tile: int,
                max_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-padded layout of ragged groups: ``(pad_start [groups],
    tile_eid [n_tiles] int32)``.  Group g's rows start at ``pad_start[g]``
    (each group padded to a ``tile`` multiple); tiles past the last
    group's pad hold only zero rows and are clamped to the last group.
    ``sizes`` may carry leading dims (one layout per row of them, as the
    JAX function under ``vmap``)."""
    n_groups = sizes.shape[-1]
    psz = ((sizes + tile - 1) // tile) * tile
    bounds = torch.cumsum(psz, -1)                    # padded group ends
    pad_start = bounds - psz
    n_tiles = dropless_rows(max_rows, n_groups, tile) // tile
    starts = torch.arange(n_tiles, device=sizes.device,
                          dtype=bounds.dtype) * tile
    if sizes.ndim > 1:
        starts = starts.expand(sizes.shape[:-1] + (n_tiles,)).contiguous()
    tile_eid = torch.searchsorted(bounds, starts, right=True,
                                  out_int32=True)
    return pad_start, torch.clamp(tile_eid, max=n_groups - 1)


def mark_trash_tiles(sizes: torch.Tensor, tile_eid: torch.Tensor, *,
                     tile: int) -> torch.Tensor:
    """``tile_eid`` with ``-1`` on the tiles past the last group's pad
    (the clamped tail of :func:`tile_layout`, which holds only zero
    rows), computed on the device from ``sizes`` [..., groups]: the
    grouped FFN skips those tiles and writes zeros for them."""
    live = (((sizes + tile - 1) // tile).sum(-1))[..., None]
    t = torch.arange(tile_eid.shape[-1], device=tile_eid.device)
    return torch.where(t < live, tile_eid, torch.full_like(tile_eid, -1))


def sort_by_expert(expert_idx: torch.Tensor, num_experts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort of rows by expert id over the last dim: ``(order [...,
    N], sizes [..., E], rank [..., N])``.  The per-expert count is a
    ``scatter_add_`` of ones (``torch.bincount`` would read the largest
    id back to the host)."""
    order = torch.argsort(expert_idx, dim=-1, stable=True)
    eid_sorted = expert_idx.gather(-1, order).long()
    sizes = torch.zeros(expert_idx.shape[:-1] + (num_experts,),
                        dtype=torch.int64, device=expert_idx.device
                        ).scatter_add_(-1, expert_idx.long(),
                                       torch.ones_like(expert_idx,
                                                       dtype=torch.int64))
    group_start = torch.cumsum(sizes, -1) - sizes
    rank = torch.arange(order.shape[-1], device=order.device) \
        - group_start.gather(-1, eid_sorted)
    return order, sizes, rank


def grouped_ffn(xt: torch.Tensor, tile_eid: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, *, impl: Optional[str] = None,
                rows: Optional[int] = None) -> torch.Tensor:
    """The grouped GEMM behind one interface: ``impl`` (``"xla"``,
    ``"pallas"`` or ``None`` to read ``BLUEFOG_MOE_GROUPED_IMPL``) is
    validated as in JAX; the device picks the path.  ``rows``: the rows
    the live tiles may hold, when the caller knows it (the kernel's plan
    sizes its blocks by it; see :func:`~bluefog_tpu_torch.ops.
    grouped_ffn.ffn_plan`)."""
    if impl is None:
        impl = os.environ.get("BLUEFOG_MOE_GROUPED_IMPL", "xla")
    if impl not in ("xla", "pallas"):
        raise ValueError(f"moe_dropless_unknown_impl: grouped GEMM impl "
                         f"must be 'xla' or 'pallas', got {impl!r}")
    return _gf.grouped_ffn(xt, tile_eid, w1, w2, rows=rows)
