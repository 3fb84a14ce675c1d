"""Window (one-sided gossip) ops over stacked ranks (counterpart of
``bluefog_tpu/ops/windows.py:41-203``).

A window gives every rank its own tensor plus one mailbox per sorted
in-neighbor; ``win_put`` / ``win_accumulate`` / ``win_get`` move data into
those mailboxes and ``win_update`` combines them.  As in the JAX package
the ops are bounded-staleness buffered exchanges: a delivery lands in the
call that issues it, and ``win_update`` reads whatever the mailboxes
hold.  Here every rank is a row of dim 0, so a :class:`Window` is the
JAX window stacked: ``value [n, ...]`` and ``recv [n, K, ...]``
(``K = max(max_in_degree, 1)``), and a delivery round is the stacked
gather of :mod:`bluefog_tpu_torch.ops.collectives`, optionally through
a wire codec.  The ops are functional: they return a new window and
leave their inputs alone.

Not ported yet (ROADMAP queue 1, item 7): the step stamps,
``staleness_depth`` and ``async_mixing_matrices``, which only
``async_window_gossip`` reads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..schedule import CommSchedule
from .collectives import _check_ranks, _table, _wire_permute

__all__ = ["Window", "win_create", "win_put", "win_accumulate", "win_get",
           "win_update", "win_update_then_collect", "win_pull"]


class Window(NamedTuple):
    """Every rank's window: its own tensor and its in-neighbor mailboxes."""
    value: torch.Tensor       # [n, *shape]
    recv: torch.Tensor        # [n, max_in_degree, *shape]


def _slots(sched: CommSchedule) -> int:
    return max(sched.max_in_degree, 1)


def win_create(x: torch.Tensor, sched: CommSchedule, *,
               zero_init: bool = True) -> Window:
    """Allocate a window for the stacked ``x`` (reference:
    ``bf.win_create``).  ``zero_init`` zeroes the mailboxes; otherwise
    each rank's mailboxes start as copies of its own tensor."""
    _check_ranks(x, sched.size, "win_create")
    shape = (x.shape[0], _slots(sched)) + tuple(x.shape[1:])
    if zero_init:
        recv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    else:
        recv = x.unsqueeze(1).expand(shape).clone()
    return Window(value=x, recv=recv)


def _deliver(win: Window, x: torch.Tensor, sched: CommSchedule,
             accumulate: bool, apply_dst_scale: bool = True,
             wire: Optional[str] = None) -> Window:
    """Send ``x`` along every out-edge into the receivers' slot mailboxes:
    round ``r`` lands in slot ``recv_slot[r]`` of each rank that receives
    in it (set, or added with ``accumulate``)."""
    _check_ranks(x, sched.size, "window delivery")
    recv = win.recv.clone()
    for r in range(sched.num_rounds):
        send = x
        if apply_dst_scale and sched.uses_dst_weighting:
            send = x * _table(sched.send_scale[r], x)
        incoming = _wire_permute(wire, send, sched.recv_src[r])
        rows = np.flatnonzero(sched.recv_src[r] >= 0)
        if not rows.size:
            continue
        ri = torch.as_tensor(rows, device=x.device)
        si = torch.as_tensor(sched.recv_slot[r][rows].astype(np.int64),
                             device=x.device)
        got = incoming.index_select(0, ri)
        if accumulate:
            recv[ri, si] += got
        else:
            recv[ri, si] = got
    return Window(value=win.value, recv=recv)


def win_put(win: Window, x: torch.Tensor, sched: CommSchedule, *,
            wire: Optional[str] = None) -> Window:
    """Overwrite out-neighbors' mailboxes with ``x`` (reference: WinPut);
    dst-weighting scales per edge; ``wire`` compresses the moved bytes."""
    return _deliver(win, x, sched, accumulate=False, wire=wire)


def win_accumulate(win: Window, x: torch.Tensor, sched: CommSchedule, *,
                   wire: Optional[str] = None) -> Window:
    """Add ``x`` into out-neighbors' mailboxes (reference:
    WinAccumulate)."""
    return _deliver(win, x, sched, accumulate=True, wire=wire)


def win_get(win: Window, sched: CommSchedule, *,
            wire: Optional[str] = None) -> Window:
    """Fetch in-neighbors' window tensors into each rank's mailboxes
    (reference: WinGet): every rank sends its current ``value`` along its
    out-edges, without the dst scaling a put applies."""
    return _deliver(win, win.value, sched, accumulate=False,
                    apply_dst_scale=False, wire=wire)


def _combine(value: torch.Tensor, recv: torch.Tensor, self_weight,
             slot_weights) -> torch.Tensor:
    """``self_weight * value + sum_k slot_weight[k] * recv[:, k]`` per
    rank, the slots added in order (``tensordot`` over them in JAX)."""
    n, K = recv.shape[0], recv.shape[1]
    sw = _table(np.asarray(self_weight), value)
    w = np.asarray(slot_weights)                       # [K, n]
    dot = None
    for k in range(K):
        term = recv[:, k] * _table(w[k], value)
        dot = term if dot is None else dot + term
    return sw * value + dot


def win_update(win: Window, sched: CommSchedule, *,
               self_weight: Optional[np.ndarray] = None,
               slot_weights: Optional[np.ndarray] = None,
               reset: bool = False) -> Tuple[torch.Tensor, Window]:
    """Weighted combine of each rank's tensor and mailboxes (reference:
    ``win_update``).  The weights default to the schedule's (``[n]`` self
    and ``[K, n]`` slot tables may override them); ``reset`` zeroes the
    mailboxes after the combine.  Returns ``(combined, new_window)`` with
    the window's value set to the combined value."""
    combined = _combine(
        win.value, win.recv,
        sched.self_weight if self_weight is None else self_weight,
        sched.slot_weight if slot_weights is None else slot_weights)
    recv = torch.zeros_like(win.recv) if reset else win.recv
    return combined, Window(value=combined, recv=recv)


def win_update_then_collect(win: Window, sched: CommSchedule
                            ) -> Tuple[torch.Tensor, Window]:
    """Sum each rank's tensor and its real mailboxes, then clear them
    (reference: ``mpi_ops.py:1064-1080``): the push-sum collection."""
    K = _slots(sched)
    slot_ones = (np.arange(K)[:, None] < sched.in_degree[None, :]
                 ).astype(np.float32)
    return win_update(win, sched,
                      self_weight=np.ones(sched.size, dtype=np.float32),
                      slot_weights=slot_ones, reset=True)


def win_pull(x: torch.Tensor, sched: CommSchedule, *,
             wire: Optional[str] = None) -> torch.Tensor:
    """One-shot pull: each rank's in-neighbors' current tensors (through
    ``wire``), combined with the schedule's weights.  No window is
    allocated: each round's arrivals are weighted and added as they come
    (a real slot receives exactly one delivery a pull, and the slots past
    ``in_degree`` weigh 0), so the result is the weighted neighbor
    combine.  Ranks with no in-edges and self weight 1 keep their
    tensor."""
    _check_ranks(x, sched.size, "win_pull")
    acc = x * _table(sched.self_weight, x)
    for r in range(sched.num_rounds):
        incoming = _wire_permute(wire, x, sched.recv_src[r])
        acc = acc + incoming * _table(sched.recv_weight[r], x)
    return acc
