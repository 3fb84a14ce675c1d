"""Collectives over stacked ranks (counterpart of
``bluefog_tpu/ops/collectives.py``).

The JAX ops run inside ``shard_map`` with one block per device.  This is
the single-process *stacked* backend: the ranks live along dim 0 of every
tensor (the JAX API's ``[n_ranks, ...]`` layout), and a ``ppermute`` over
a round's ``(src, dst)`` pairs is a gather along dim 0 by the round's
``recv_src`` table that zero-fills ranks receiving nothing, as
``lax.ppermute`` does.  The weighted combine is plain torch; the wire
codecs are not ported yet (only the amax scaling the quantized KV store
shares with them).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..schedule import CommSchedule

__all__ = ["neighbor_allreduce", "allreduce", "allgather", "broadcast",
           "_amax_scale"]

_TINY = float(np.finfo(np.float32).tiny)


def _amax_scale(xf: torch.Tensor, qmax: float, blk: Optional[int]):
    """(scaled values ready to cast, riding scale(s)).  Per-buffer when
    ``blk`` is None, else one scale per row of the ``[n, blk]`` input.
    The scale is floored at the smallest normal f32: for a subnormal amax
    the division would underflow to 0 and ``xf / scale`` become inf, which
    e4m3fn (no inf) would turn into NaN.  With the floor, tiny payloads
    quantize to 0."""
    amax = (xf.abs().max() if blk is None
            else xf.abs().amax(dim=1, keepdim=True))
    scale = torch.where(amax > 0, torch.clamp(amax / qmax, min=_TINY),
                        torch.ones_like(amax))
    return xf / scale, scale.to(torch.float32)


def _table(row: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Per-rank table entries as a ``[n, 1, ...]`` column in x's dtype."""
    t = torch.as_tensor(np.asarray(row), device=x.device).to(x.dtype)
    return t.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _permute(send: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    """One round: rank d receives ``send[src[d]]``; ``src[d] < 0`` receives
    zeros."""
    idx = torch.as_tensor(np.clip(src, 0, None), dtype=torch.long,
                          device=send.device)
    recv = send.index_select(0, idx)
    if (src < 0).any():
        got = torch.as_tensor(src >= 0, device=send.device)
        recv = recv * got.reshape((-1,) + (1,) * (send.ndim - 1)).to(
            recv.dtype)
    return recv


def _check_ranks(x: torch.Tensor, n: int, what: str) -> None:
    if x.ndim < 1 or x.shape[0] != n:
        raise ValueError(f"{what} wants a stacked [n={n}, ...] tensor, got "
                         f"shape {tuple(x.shape)}")


def neighbor_allreduce(x: torch.Tensor, sched: CommSchedule, *,
                       wire: Optional[str] = None,
                       concurrent: Optional[bool] = None) -> torch.Tensor:
    """Weighted average of each rank's row with its in-neighbors' under
    ``sched``: ``self_weight * x + sum_r recv_weight[r] * permute_r(send_r)``
    with ``send_r = x * send_scale[r]`` under dst-weighting, rank by rank
    exactly the JAX op's combine.  ``concurrent`` is accepted: the rounds
    always combine in round order, so the result is the same either way.
    Wire codecs are not ported yet and raise."""
    if wire is not None:
        raise ValueError(f"wire codec {wire!r}: wire codecs are not yet "
                         "ported to bluefog_tpu_torch")
    _check_ranks(x, sched.size, "neighbor_allreduce")
    acc = x * _table(sched.self_weight, x)
    for r in range(sched.num_rounds):
        send = x
        if sched.uses_dst_weighting:
            send = x * _table(sched.send_scale[r], x)
        recv = _permute(send, sched.recv_src[r])
        acc = acc + recv * _table(sched.recv_weight[r], x)
    return acc


def allreduce(x: torch.Tensor, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the sum (or mean) over the ranks."""
    total = x.sum(dim=0, keepdim=True)
    if average:
        total = total / x.shape[0]
    return total.expand_as(x).clone()


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets all ranks' blocks concatenated along their dim 0:
    ``[n, d0, ...] -> [n, n * d0, ...]``."""
    n = x.shape[0]
    flat = x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))
    return flat.unsqueeze(0).expand((n,) + tuple(flat.shape)).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank gets root's block."""
    if not 0 <= root_rank < x.shape[0]:
        raise ValueError(f"root_rank {root_rank} out of range for "
                         f"{x.shape[0]} ranks")
    return x[root_rank:root_rank + 1].expand_as(x).clone()
