"""Per-chip wire bytes of the port's own collectives (counterpart of
``bluefog_tpu/utils/hlo_bytes.py``'s :func:`wire_stats` and
:func:`stablehlo_wire_stats`).

The JAX package counts the collectives of a compiled (or lowered) XLA
program.  The port compiles no program, so it counts what its
collectives move while one call runs: :func:`ledger` arms a
:class:`Ledger` around the call, and every collective of
:mod:`bluefog_tpu_torch.ops.collectives` records itself in it.  Disarmed,
a collective pays one read of the module flag :data:`_armed`.

What is recorded, by the JAX op each collective stands for:

* a ``collective_permute`` for every round of rows that move between
  ranks (``_permute_rounds``: gossip, windows, the pipeline's ship,
  ZeRO-1's rotation, broadcast's tree), one per encoded array under a
  wire codec (bf16; int8 or fp8 codes plus their f32 scales; never the
  ``uint8`` bytes they travel as), and one for each ``ppermute`` over a
  peer dim;
* an ``all_reduce`` for each sum over the rank axis (``rank_sum`` /
  ``allreduce`` / ``rank_max``) and each ``psum`` / ``peer_sum`` /
  ``pmean`` over a peer dim, and for the composed trainer's gradient sums
  over its peers (the JAX ``psum`` / ``pmean`` outside AD);
* an ``all_gather`` for ``allgather``, an ``all_to_all`` for each
  ``all_to_all``.

Under autograd a ``psum``, ``ppermute``, ``all_to_all`` and a moved
round record their transpose again when their backward runs, as the JAX
gradient program holds each op's transpose.

Accounting, per chip, the rules of ``hlo_bytes``: a permute moves its
buffer once, an all-reduce its payload once (not a ring's 2(n-1)/n), an
all-gather ``out * (n-1) / n``, a reduce-scatter ``out * (n-1)``, an
all-to-all its whole buffer.  :meth:`Ledger.wire_stats` returns those
bytes by the HLO kind names; :meth:`Ledger.stablehlo_wire_stats`, as the
JAX function, each op's result payload split into cross-slice (DCN) and
intra-slice (ICI) traffic, with the dtypes each side moved.

A chip is a stacked row of the rank axis.  Where a row stacks several
chips (a replica's peers under gossip, a pipeline stage's tp x sp x ep
peers), the caller says how many, and each gets its share.  A move is
DCN when its source and destination chips lie in different replica
blocks (``chip // slice_size`` differs); a collective over a peer dim
never leaves its replica and is ICI.  Each figure is the busiest chip's.

**Static versus dynamic counts.** JAX counts each collective once per
*static occurrence* in the program; this ledger counts every call the
run makes.  A collective inside a ``lax.scan`` counts once in JAX but
once a trip here: the pipeline ticks (``bluefog_tpu/parallel/
pipeline.py``), the layer scan (``compose.py``), the MoE stage scan
(``moe/model.py``) and Ulysses' chunks (``ops/ulysses.py``).  So a
composed step's ICI bytes exceed JAX's by those trip counts, while its
DCN bytes (the gossip, once a step, outside any scan) are equal.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Ledger", "ledger", "replica", "paused", "HLO_KINDS",
           "dtype_name"]

#: The armed ledger, or None (the one flag a disarmed collective reads).
_armed: Optional["Ledger"] = None

#: StableHLO kind -> the compiled-HLO name ``wire_stats`` keys by.
HLO_KINDS = {"collective_permute": "collective-permute",
             "all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

_DTYPES = {torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
           torch.int16: "i16", torch.int8: "i8", torch.uint8: "ui8",
           torch.bool: "i1", torch.float8_e4m3fn: "f8E4M3FN",
           torch.float8_e5m2: "f8E5M2"}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by its StableHLO element type name."""
    return _DTYPES.get(dtype, str(dtype).replace("torch.", ""))


class _Event:
    """One logical collective: its kind, side, dtype, the bytes each
    charged chip pays (the wire accounting and the result payload), and
    the chips charged: explicit ids, a range ``(lo, hi)``, or every chip
    (None)."""
    __slots__ = ("kind", "side", "dtype", "wire", "result", "ids", "span")

    def __init__(self, kind, side, dtype, wire, result, ids=None,
                 span=None):
        self.kind, self.side, self.dtype = kind, side, dtype
        self.wire, self.result = int(wire), int(result)
        self.ids, self.span = ids, span


class Ledger:
    """The collectives one armed call made (see the module docstring).

    ``slice_size`` is the chips of one replica block (the JAX argument of
    ``stablehlo_wire_stats``); 1 makes every move between ranks DCN."""

    def __init__(self, slice_size: int = 1):
        if int(slice_size) < 1:
            raise ValueError(f"slice_size must be >= 1, got {slice_size}")
        self.slice_size = int(slice_size)
        self.events: List[_Event] = []
        self._scope: Optional[Tuple[int, int]] = None

    # -- recording (the collectives call these) ---------------------------
    def _base(self) -> int:
        return self._scope[0] if self._scope is not None else 0

    def uniform(self, kind: str, dtype: torch.dtype, per_chip: int, *,
                side: str = "ici", wire: Optional[int] = None) -> _Event:
        """A collective every chip of the current replica (of the world
        outside one) runs with ``per_chip`` bytes of result."""
        ev = _Event(kind, side, dtype_name(dtype),
                    per_chip if wire is None else wire, per_chip,
                    span=self._scope)
        self.events.append(ev)
        return ev

    def rank_reduce(self, kind: str, dtype: torch.dtype, per_chip: int,
                    chips: int, *, wire: Optional[int] = None) -> _Event:
        """A collective over the whole rank axis (``chips`` chips): DCN
        when they span more than one replica block."""
        side = "dcn" if chips > self.slice_size else "ici"
        return self.uniform(kind, dtype, per_chip, side=side, wire=wire)

    def moves(self, srcs: Sequence[np.ndarray], rows: int, first_row: int,
              chips_per_row: int, parts: Sequence[Tuple[torch.dtype, int]]
              ) -> List[_Event]:
        """Rounds of rows moved between ranks: row ``d`` (global
        ``first_row + d``) receives row ``src[d]`` of each round's table.
        Each row holds ``chips_per_row`` chips; ``parts`` are the arrays
        one row carries, ``(dtype, bytes)`` each.  One permute a round and
        array; the receiving chips pay."""
        c = max(int(chips_per_row), 1)
        base = self._base()
        out = []
        for src in srcs:
            src = np.asarray(src)
            mine = src[first_row:first_row + rows] if len(src) != rows \
                else src
            dst = np.arange(rows) + (first_row if len(src) != rows else 0)
            moved = (mine >= 0) & (mine != dst)
            if not moved.any():
                continue
            j = np.arange(c)
            dchips = (dst[moved][:, None] * c + j).reshape(-1) + base
            schips = (mine[moved][:, None] * c + j).reshape(-1) + base
            L = self.slice_size
            side = "dcn" if bool(((dchips // L) != (schips // L)).any()) \
                else "ici"
            for dtype, nbytes in parts:
                share = int(nbytes) // c
                ev = _Event("collective_permute", side, dtype_name(dtype),
                            share, share, ids=tuple(int(i) for i in dchips))
                self.events.append(ev)
                out.append(ev)
        return out

    def steps(self, k: int) -> List["Ledger"]:
        """The events of a call of ``k`` identical steps, cut into one
        ledger a step (each step's share of the call)."""
        k = int(k)
        if k < 1 or len(self.events) % k:
            raise ValueError(f"{len(self.events)} events are not {k} "
                             "steps of one sequence")
        m = len(self.events) // k
        out = []
        for i in range(k):
            led = Ledger(self.slice_size)
            led.events = self.events[i * m:(i + 1) * m]
            out.append(led)
        return out

    def again(self, events: Sequence[_Event]) -> None:
        """The same collectives once more (a transpose in a backward)."""
        for ev in events:
            self.events.append(_Event(ev.kind, ev.side, ev.dtype, ev.wire,
                                      ev.result, ev.ids, ev.span))

    # -- reading ----------------------------------------------------------
    def _chips(self, events) -> List[int]:
        ids = set()
        for ev in events:
            if ev.ids is not None:
                ids.update(ev.ids)
            elif ev.span is not None:
                ids.update(range(*ev.span))
        return sorted(ids) or [0]

    def _busiest(self, events, field: str) -> Dict[str, int]:
        """The busiest chip's bytes by kind (ties: the lowest chip)."""
        chips = self._chips(events)
        index = {c: i for i, c in enumerate(chips)}
        kinds = sorted({ev.kind for ev in events})
        table = np.zeros((len(chips), len(kinds)), dtype=np.int64)
        col = {k: i for i, k in enumerate(kinds)}
        for ev in events:
            b = getattr(ev, field)
            if ev.ids is not None:
                for c in ev.ids:
                    table[index[c], col[ev.kind]] += b
            elif ev.span is not None:
                lo, hi = ev.span
                rows = [index[c] for c in range(lo, hi)]
                table[rows, col[ev.kind]] += b
            else:
                table[:, col[ev.kind]] += b
        if not kinds:
            return {}
        top = int(np.argmax(table.sum(axis=1)))
        return {k: int(table[top, col[k]]) for k in kinds}

    def wire_stats(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """``(counts, bytes_)`` keyed by the compiled-HLO kind names, as
        ``hlo_bytes.wire_stats``: each kind's op count and the busiest
        chip's wire bytes in it."""
        counts: Dict[str, int] = {}
        for ev in self.events:
            k = HLO_KINDS[ev.kind]
            counts[k] = counts.get(k, 0) + 1
        bytes_ = {HLO_KINDS[k]: v
                  for k, v in self._busiest(self.events, "wire").items()}
        return counts, bytes_

    def total_wire_bytes(self) -> int:
        return int(sum(self.wire_stats()[1].values()))

    def stablehlo_wire_stats(self) -> dict:
        """The dict of ``hlo_bytes.stablehlo_wire_stats``: ``{"ici"|"dcn":
        {kind: {"count", "bytes"}}, "unknown": {}, "ici_bytes",
        "dcn_bytes", "ici_dtypes", "dcn_dtypes"}``, each side's bytes the
        busiest chip's result payloads on that side."""
        out = {"ici": {}, "dcn": {}, "unknown": {}}
        for side in ("ici", "dcn"):
            evs = [ev for ev in self.events if ev.side == side]
            busy = self._busiest(evs, "result")
            for ev in evs:
                slot = out[side].setdefault(ev.kind,
                                            {"count": 0, "bytes": 0})
                slot["count"] += 1
            for kind, b in busy.items():
                out[side][kind]["bytes"] = b
            out[side + "_bytes"] = int(sum(busy.values()))
            out[side + "_dtypes"] = sorted({ev.dtype for ev in evs})
        return {k: out[k] for k in ("ici", "dcn", "unknown", "ici_bytes",
                                    "dcn_bytes", "ici_dtypes", "dcn_dtypes")}


@contextlib.contextmanager
def ledger(slice_size: int = 1) -> Iterator[Ledger]:
    """Arm a fresh :class:`Ledger` around a call; the previous one (if
    any) is restored after."""
    global _armed
    prior, _armed = _armed, Ledger(slice_size)
    try:
        yield _armed
    finally:
        _armed = prior


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """No ledger armed inside (a probe beside the measured call, which
    the JAX program does not hold either)."""
    global _armed
    prior, _armed = _armed, None
    try:
        yield
    finally:
        _armed = prior


@contextlib.contextmanager
def replica(lo: int, hi: int) -> Iterator[None]:
    """While armed: the chips ``lo .. hi - 1`` are the replica the calls
    inside run (``optimizers.stacked_grads`` sets it a replica), so a
    collective over its peers charges them, and a move of its rows is
    offset to them."""
    led = _armed
    if led is None:
        yield
        return
    prior, led._scope = led._scope, (int(lo), int(hi))
    try:
        yield
    finally:
        led._scope = prior


class _Transpose(torch.autograd.Function):
    """``x`` unchanged; its backward records ``events`` again in the armed
    ledger (the transpose the JAX gradient program holds)."""

    @staticmethod
    def forward(ctx, x, events):
        ctx.events = events
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _armed is not None:
            _armed.again(ctx.events)
        return g, None


def transpose_on_backward(y: torch.Tensor, events) -> torch.Tensor:
    """``y``, tied so that its backward records ``events`` again; ``y``
    itself when nothing will backpropagate through it."""
    if events and torch.is_grad_enabled() and y.requires_grad:
        return _Transpose.apply(y, list(events))
    return y


def nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def peers(x: torch.Tensor, lead: int) -> int:
    """The chips stacked in ``x``'s first ``lead`` dims."""
    return int(np.prod(x.shape[:lead], dtype=np.int64)) if lead else 1
