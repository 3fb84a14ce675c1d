"""The named-window API over stacked ranks (the port of
``bluefog_tpu/parallel/windows.py``, the reference's window surface
``bluefog/torch/mpi_ops.py:1008-1503``).

Windows are created by name; puts / accumulates / gets move data along
the topology's edges and ``win_update`` combines the mailboxes.  The
state is a host registry of stacked :class:`~bluefog_tpu_torch.ops.
windows.Window`\\ s (``value [n, ...]``, ``recv [n, K, ...]``; this
process's rows across processes), updated by the functional window ops,
each delivery a stacked gather through ``ops/collectives.py::_permute``.
The host keeps JAX's tables beside each window: the puts delivered a
mailbox since the last reset (``version``), the window's tick (one a
delivery op) and each mailbox's stamp (the tick of its latest
delivery).  ``win_mutex`` is a no-op, as in JAX: a delivery lands at a
fixed point of the call that issues it, so there is nothing to lock.
The associated-p channel gossips one scalar a rank through the same
mailboxes when it is turned on.  Each move is counted by the metrics
registry (``record_op``) and the flight ring, and passes the chaos hook
(``utils/chaos.py``: a plan may stall the move or NaN a rank's row of the
window).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import windows as wops
from ..schedule import CommSchedule, compile_from_weights
from ..utils import chaos as _chaos
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from . import context as _ctx

__all__ = [
    "win_create", "win_free", "win_put", "win_accumulate", "win_get",
    "win_update", "win_update_then_collect", "win_mutex", "get_win_version",
    "get_win_stamps", "win_staleness",
    "win_associated_p", "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p", "window_from_jax",
]


@dataclass
class _WindowEntry:
    window: wops.Window          # stacked: value [n, ...], recv [n, K, ...]
    sched: CommSchedule          # creation-time schedule (defines slots)
    version: np.ndarray          # [n, K] puts delivered per mailbox (host)
    stamp: np.ndarray = None     # [n, K] tick of each mailbox's last delivery
    tick: int = 0                # delivery ops dispatched on this window


_registry: Dict[str, _WindowEntry] = {}
_assoc_p: Dict[str, wops.Window] = {}    # associated-p channel per window
_assoc_p_enabled: bool = False


def _dst_schedule(base: CommSchedule, dst_weights) -> CommSchedule:
    """Delivery schedule of a put / accumulate with per-rank dst scaling
    (``dst_weights``: a dict or rank list a sender).  Mailbox slots are
    remapped onto the window's creation-time layout (``base.in_neighbors``),
    so a partial delivery lands in the slot ``win_update`` reads for its
    source."""
    n = base.size
    dst_list = []
    for d in dst_weights:
        if isinstance(d, dict):
            dst_list.append({int(k): float(v) for k, v in d.items()})
        else:
            dst_list.append({int(k): 1.0 for k in d})
    src_list: List[Dict[int, float]] = [dict() for _ in range(n)]
    for src, dsts in enumerate(dst_list):
        for dst in dsts:
            src_list[dst][src] = 1.0   # recv weights irrelevant for delivery
    sub = compile_from_weights(n, [0.0] * n, src_list, dst_list)

    recv_slot = sub.recv_slot.copy()
    for r in range(recv_slot.shape[0]):
        for dst in range(n):
            src = int(sub.recv_src[r, dst])
            if src < 0:
                continue
            if src not in base.in_neighbors[dst]:
                raise ValueError(
                    f"rank {src} -> {dst} is not an edge of the window's "
                    f"topology; dst_weights may only select existing edges")
            recv_slot[r, dst] = base.in_neighbors[dst].index(src)
    return dataclasses.replace(sub, recv_slot=recv_slot, key="")


def _slot_table_from_weights(base: CommSchedule,
                             neighbor_weights: Sequence[Dict[int, float]]
                             ) -> np.ndarray:
    """Per-rank ``{src: w}`` dicts -> a ``[max_in_degree, n]`` slot-weight
    table on the window's slot order (``base.in_neighbors``)."""
    n = base.size
    K = max(base.max_in_degree, 1)
    table = np.zeros((K, n), dtype=np.float32)
    for dst, weights in enumerate(neighbor_weights):
        for src, w in weights.items():
            if src not in base.in_neighbors[dst]:
                raise ValueError(
                    f"rank {dst}: {src} is not an in-neighbor in this window")
            table[base.in_neighbors[dst].index(src), dst] = float(w)
    return table


# ---------------------------------------------------------------------------
# Window lifecycle
# ---------------------------------------------------------------------------

def _check_rows(x, ctx) -> None:
    if x is None or x.ndim < 1 or x.shape[0] != ctx.rows:
        raise ValueError(
            f"expected distributed tensor with leading axis {ctx.rows}")


def win_create(tensor: torch.Tensor, name: str,
               zero_init: bool = False) -> bool:
    """Create a named window over a stacked tensor (reference:
    ``bf.win_create``); ``zero_init`` zeroes the mailboxes, else each
    starts as a copy of its rank's tensor."""
    ctx = _ctx.get_context()
    if tensor.ndim < 1 or tensor.shape[0] != ctx.rows:
        raise ValueError(
            f"window tensor must have leading rank axis {ctx.rows}, got "
            f"{tuple(tensor.shape)}")
    sched = _ctx.static_schedule()
    K = max(sched.max_in_degree, 1)
    _registry[name] = _WindowEntry(
        window=wops.win_create(tensor, sched, zero_init=zero_init),
        sched=sched, version=np.zeros((ctx.size, K), dtype=np.int64),
        stamp=np.zeros((ctx.size, K), dtype=np.int64))
    _assoc_p[name] = wops.win_create(
        torch.ones(ctx.rows, dtype=tensor.dtype, device=tensor.device),
        sched, zero_init=True)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window, or all (reference: ``bf.win_free``)."""
    if name is None:
        _registry.clear()
        _assoc_p.clear()
    else:
        _registry.pop(name, None)
        _assoc_p.pop(name, None)
    return True


def _entry(name: str) -> _WindowEntry:
    if name not in _registry:
        raise KeyError(f"no window named {name!r}; call win_create first")
    return _registry[name]


# ---------------------------------------------------------------------------
# Data movement
# ---------------------------------------------------------------------------

def _delivered_mask(sched: CommSchedule, slots: int) -> np.ndarray:
    """``[n, slots]`` bool: the mailboxes that receive under ``sched``."""
    n = sched.size
    mask = np.zeros((n, slots), dtype=bool)
    for r in range(sched.recv_src.shape[0]):
        for dst in range(n):
            if sched.recv_src[r, dst] >= 0:
                mask[dst, int(sched.recv_slot[r, dst])] = True
    return mask


def _move(kind: str, tensor, name: str, dst_weights, wire=None) -> None:
    ctx = _ctx.get_context()
    entry = _entry(name)
    _metrics.record_op("win_" + kind, () if tensor is None else (tensor,))
    _flight.record_op("win_" + kind)
    sched = (_dst_schedule(entry.sched, dst_weights)
             if dst_weights is not None else entry.sched)
    slots = entry.window.recv.shape[1]
    if max(sched.max_in_degree, 1) > slots:
        raise ValueError(
            f"window {name!r} has {slots} mailboxes but the "
            f"requested exchange needs {sched.max_in_degree}")
    op = {"put": wops.win_put, "acc": wops.win_accumulate}.get(kind)
    if kind == "get":
        entry.window = wops.win_get(entry.window, sched, wire=wire)
    else:
        _check_rows(tensor, ctx)
        entry.window = op(entry.window, tensor, sched, wire=wire)
    if _assoc_p_enabled and kind in ("put", "acc"):
        # the associated-p scalar rides the same channel, so x / p
        # de-biases a directed exchange
        pwin = _assoc_p[name]
        _assoc_p[name] = op(pwin, pwin.value, sched)
    # fault injection on the async-gossip path: same zero-cost gate as the
    # eager op API; chaos may stall this op or NaN the window payload
    if _chaos._plan is not None:
        entry.window = _chaos.on_eager_op("win_" + kind, entry.window)
    mask = _delivered_mask(sched, slots)
    entry.version += mask
    entry.tick += 1
    entry.stamp[mask] = entry.tick


def win_put(tensor: torch.Tensor, name: str, *, dst_weights=None,
            require_mutex: bool = False, wire: Optional[str] = None) -> None:
    """Deliver ``tensor`` into out-neighbors' mailboxes (reference:
    ``bf.win_put``); ``dst_weights`` selects and scales edges, ``wire``
    compresses the moved bytes."""
    _move("put", tensor, name, dst_weights, wire=wire)


def win_accumulate(tensor: torch.Tensor, name: str, *, dst_weights=None,
                   require_mutex: bool = False,
                   wire: Optional[str] = None) -> None:
    """Add ``tensor`` into out-neighbors' mailboxes (reference:
    ``bf.win_accumulate``)."""
    _move("acc", tensor, name, dst_weights, wire=wire)


def win_get(name: str, *, wire: Optional[str] = None) -> None:
    """Fetch in-neighbors' window tensors into this window's mailboxes
    (reference: ``bf.win_get``)."""
    _move("get", None, name, None, wire=wire)


# ---------------------------------------------------------------------------
# Combination
# ---------------------------------------------------------------------------

def win_update(name: str,
               self_weight: Optional[Union[float, Sequence[float]]] = None,
               neighbor_weights: Optional[Sequence[Dict[int, float]]] = None,
               reset: bool = False, clone: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    """Combine the window tensor and its mailboxes, set the window to the
    result and return it (reference: ``bf.win_update``).  The weights
    follow the creation schedule unless ``self_weight`` and per-rank
    ``neighbor_weights`` dicts (given together) override them; ``reset``
    zeroes the mailboxes and the versions."""
    ctx = _ctx.get_context()
    entry = _entry(name)
    sched = entry.sched
    sw_tab = slot_tab = None
    if (self_weight is None) != (neighbor_weights is None):
        raise ValueError(
            "self_weight and neighbor_weights must be presented at the same "
            "time")
    if self_weight is not None:
        n = ctx.size
        sw_tab = (np.full(n, float(self_weight), np.float32)
                  if np.isscalar(self_weight)
                  else np.asarray([float(w) for w in self_weight], np.float32))
        slot_tab = _slot_table_from_weights(sched, neighbor_weights)
    value, entry.window = wops.win_update(
        entry.window, sched, self_weight=sw_tab, slot_weights=slot_tab,
        reset=reset)
    if _assoc_p_enabled:
        _, _assoc_p[name] = wops.win_update(
            _assoc_p[name], sched, self_weight=sw_tab, slot_weights=slot_tab,
            reset=reset)
    if reset:
        entry.version[:] = 0
    return value


def win_update_then_collect(name: str,
                            require_mutex: bool = True) -> torch.Tensor:
    """Sum the mailboxes into the window tensor and clear them (reference:
    ``mpi_ops.py:1064-1080``)."""
    entry = _entry(name)
    value, entry.window = wops.win_update_then_collect(entry.window,
                                                       entry.sched)
    if _assoc_p_enabled:
        _, _assoc_p[name] = wops.win_update_then_collect(_assoc_p[name],
                                                         entry.sched)
    entry.version[:] = 0
    return value


# ---------------------------------------------------------------------------
# Mutex, versions, stamps, associated p
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def win_mutex(name: str, for_self: bool = False,
              ranks: Optional[List[int]] = None):
    """No-op (reference: distributed spin-lock windows): a delivery lands
    at a fixed point of the call that issues it."""
    yield


def get_win_version(name: str) -> np.ndarray:
    """``[n, max_in_degree]`` puts delivered a mailbox since the last
    reset (reference: version windows)."""
    return _entry(name).version.copy()


def get_win_stamps(name: str) -> np.ndarray:
    """``[n, max_in_degree]`` tick of each mailbox's latest delivery (0 =
    never); the window's tick advances once a put / accumulate / get."""
    return _entry(name).stamp.copy()


def win_staleness(name: str) -> np.ndarray:
    """``[n, max_in_degree]`` delivery ops since each real mailbox's
    latest delivery (``tick - stamp``); slots a schedule never delivers to
    report 0."""
    entry = _entry(name)
    real = _delivered_mask(entry.sched, entry.stamp.shape[1])
    return np.where(real, entry.tick - entry.stamp, 0)


def win_associated_p(name: str) -> torch.Tensor:
    """The push-sum associated-p scalar per rank (reference:
    ``bf.win_associated_p``); meaningful after
    :func:`turn_on_win_ops_with_associated_p`."""
    return _assoc_p[name].value


def turn_on_win_ops_with_associated_p() -> None:
    global _assoc_p_enabled
    _assoc_p_enabled = True


def turn_off_win_ops_with_associated_p() -> None:
    global _assoc_p_enabled
    _assoc_p_enabled = False


def window_from_jax(name: str, jentry, jassoc_p=None,
                    device=None) -> None:
    """Carry a JAX named window's registry entry (``bluefog_tpu.parallel.
    windows._registry[name]``, with ``_assoc_p[name]``) into this
    registry: the value, the mailboxes, the versions, the stamps, the
    tick, and the associated-p channel.  The schedule is the JAX entry's
    tables as the port's :class:`CommSchedule`."""
    def t(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)

    fields = {f.name: getattr(jentry.sched, f.name)
              for f in dataclasses.fields(CommSchedule)}
    sched = CommSchedule(**fields)
    _registry[name] = _WindowEntry(
        window=wops.Window(value=t(jentry.window.value),
                           recv=t(jentry.window.recv)),
        sched=sched, version=np.array(jentry.version, copy=True),
        stamp=np.array(jentry.stamp, copy=True), tick=int(jentry.tick))
    if jassoc_p is not None:
        _assoc_p[name] = wops.Window(value=t(jassoc_p.value),
                                     recv=t(jassoc_p.recv))
