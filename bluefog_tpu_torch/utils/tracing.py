"""Request-scoped tracing: Dapper-style spans with a flight-recorder cost
(the port's own copy of ``bluefog_tpu/utils/tracing.py``; it imports no
JAX and nothing of the JAX package).

The flight recorder answers "what did this *rank* just do"; the metrics
registry answers "is the fleet healthy".  Neither can answer the serving
question "where did *this request's* 180 ms go" — that needs spans keyed
by a trace id that follows one request across its lifecycle: admit →
queue-wait → prefill (prefix hit or cold) → each fused decode call →
spec-verify accept/reject → retire.  This module is that span store,
built to the same cost discipline as :mod:`.flight`:

* the hot path (:func:`add_span`) is one module-global bool check when
  disarmed, and one dict build + one GIL-atomic ``deque.append`` when
  armed — lock-free, no device state touched, donation and the retrace
  sentinel untouched; no device value is read, so a decode call gains no
  synchronization;
* the ring is bounded (default 65536 spans, oldest dropped and counted).

Clock model: span endpoints are ``time.monotonic()`` — the same clock
the serve scheduler stamps ``submitted_at``/``finished_at`` with, so a
request's span tree and its measured E2E latency are directly
comparable.  Each rank's bundle carries one ``(monotonic, wall)`` anchor
pair so ``tools/trace_report.py`` can place every rank's spans on a
shared wall-clock axis.

Arming: ``BLUEFOG_TRACE=<dir>`` (or :func:`configure`) arms recording
and directs :func:`flush` to ``<dir>/trace_rank<r>.trace.jsonl`` — one
self-describing JSONL bundle per rank (a ``meta`` line, then one line
per span), written atomically and flushed again at exit.  Producers:

* the serve scheduler threads request spans (``cat="serve"``) and tags
  each :class:`~bluefog_tpu_torch.serve.scheduler.Request` with its trace
  id;
* the serve engine wraps its calls (``cat="engine"``).
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .config import logger

__all__ = [
    "SCHEMA", "ENV_TRACE", "enabled", "configure", "maybe_enable_from_env",
    "new_trace", "add_span", "mark", "span", "spans", "dropped",
    "flush", "bundle_path", "capacity", "reset",
]

SCHEMA = "bluefog-trace-1"
ENV_TRACE = "BLUEFOG_TRACE"
DEFAULT_CAPACITY = 65536

_armed = False                   # the one hot-path gate
_dir: Optional[str] = None
_buf: deque = deque(maxlen=DEFAULT_CAPACITY)
_seq = itertools.count(1)
_last_seq = 0
_trace_seq = itertools.count(1)
_atexit_registered = False


def enabled() -> bool:
    """True when spans are being recorded."""
    return _armed


def capacity() -> int:
    return _buf.maxlen if _buf.maxlen is not None else 0


def configure(out_dir: Optional[str], capacity: Optional[int] = None) -> None:
    """Arm recording (``out_dir=None`` disarms without dropping spans).

    ``capacity`` resizes the span ring, keeping the newest spans."""
    global _armed, _dir, _buf, _atexit_registered
    if capacity is not None:
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        _buf = deque(_buf, maxlen=int(capacity))
    _dir = out_dir
    _armed = out_dir is not None
    if _armed and not _atexit_registered:
        import atexit
        atexit.register(_final_flush)
        _atexit_registered = True


def maybe_enable_from_env() -> bool:
    """Honor ``BLUEFOG_TRACE=<dir>`` at init (the tracing analogue of the
    flight/metrics/timeline env hooks).  Returns True when armed."""
    out_dir = os.environ.get(ENV_TRACE)
    if not out_dir:
        return False
    configure(out_dir)
    return True


# ---------------------------------------------------------------------------
# Recording (the lock-free hot path)
# ---------------------------------------------------------------------------

def new_trace(kind: str = "req", key: Optional[Any] = None) -> str:
    """Mint a process-unique trace id: ``"<kind>-r<rank>-<n>"``.

    Deterministic (a per-process counter, no RNG) so replays produce
    stable ids; ``key`` overrides the counter when the caller already
    has a natural id (the scheduler passes the request id)."""
    n = key if key is not None else next(_trace_seq)
    return f"{kind}-r{_rank()}-{n}"


def add_span(trace: str, name: str, t0: float, t1: float, *,
             cat: str = "", parent: Optional[int] = None,
             **attrs: Any) -> int:
    """Record one completed span; returns its span id (0 when disarmed).

    ``t0``/``t1`` are ``time.monotonic()`` endpoints measured by the
    caller — the recorder never injects its own clock reads into the
    middle of a hot loop.  Extra keyword attrs ride the span verbatim.
    """
    global _last_seq
    if not _armed:
        return 0
    sid = next(_seq)
    ev: Dict[str, Any] = {"kind": "span", "seq": sid, "trace": trace,
                          "span": sid, "name": name, "t0": t0, "t1": t1}
    if cat:
        ev["cat"] = cat
    if parent:
        ev["parent"] = parent
    if attrs:
        ev.update(attrs)
    _last_seq = sid
    _buf.append(ev)
    return sid


def mark(trace: str, name: str, *, cat: str = "",
         parent: Optional[int] = None, **attrs: Any) -> int:
    """Instant event (zero-duration span) at now."""
    t = time.monotonic()
    return add_span(trace, name, t, t, cat=cat, parent=parent, **attrs)


class span:
    """``with tracing.span(trace, "gossip", cat="train"): ...`` — times
    the block and records one span on exit (attrs may be added to
    ``.attrs`` inside the block).  Zero-cost shell when disarmed."""

    __slots__ = ("trace", "name", "cat", "parent", "attrs", "_t0", "id")

    def __init__(self, trace: str, name: str, *, cat: str = "",
                 parent: Optional[int] = None, **attrs: Any):
        self.trace, self.name, self.cat = trace, name, cat
        self.parent, self.attrs = parent, attrs
        self._t0 = 0.0
        self.id = 0

    def __enter__(self) -> "span":
        if _armed:
            self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if _armed:
            self.id = add_span(self.trace, self.name, self._t0,
                               time.monotonic(), cat=self.cat,
                               parent=self.parent, **self.attrs)


# ---------------------------------------------------------------------------
# Introspection + bundles
# ---------------------------------------------------------------------------

def spans() -> List[dict]:
    """Snapshot of the buffered spans, oldest first."""
    return list(_buf)


def dropped() -> int:
    return max(0, _last_seq - len(_buf))


def _rank() -> int:
    try:
        return int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
    except ValueError:
        return 0


def bundle_path(out_dir: Optional[str] = None) -> str:
    base = out_dir if out_dir is not None else (_dir or ".")
    return os.path.join(base, f"trace_rank{_rank()}.trace.jsonl")


def flush(path: Optional[str] = None) -> str:
    """Write the span ring as a per-rank JSONL bundle; returns the path.

    Line 1 is the ``meta`` record (schema, rank, the monotonic↔wall
    anchor the merger aligns ranks with, drop count); every further line
    is one span.  The whole file is rewritten atomically on each flush —
    the ring holds the newest spans either way.
    """
    if path is None:
        path = bundle_path()
    snap = list(_buf)
    meta = {"kind": "meta", "schema": SCHEMA, "rank": _rank(),
            "pid": os.getpid(), "mono": time.monotonic(),
            "wall": time.time(), "n_spans": len(snap),
            "dropped": max(0, _last_seq - len(snap))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for ev in snap:
            f.write(json.dumps(ev) + "\n")
    os.replace(tmp, path)
    return path


def _final_flush() -> None:
    if _armed:
        try:
            flush()
        except OSError:                                   # pragma: no cover
            logger.warning("trace flush at exit failed", exc_info=True)


def reset() -> None:
    """Test isolation: disarm and drop every buffered span."""
    global _armed, _dir, _buf, _seq, _last_seq, _trace_seq
    _armed = False
    _dir = None
    _buf = deque(maxlen=DEFAULT_CAPACITY)
    _seq = itertools.count(1)
    _last_seq = 0
    _trace_seq = itertools.count(1)
