"""Flight recorder: an always-on black box of the last N runtime events
(the port's own copy of ``bluefog_tpu/utils/flight.py``; it imports no
JAX and nothing of the JAX package).

Decentralized training fails *quietly* — with no global barrier, a dead,
hung, or diverging rank shows up only as slow consensus contraction long
after the root cause is gone.  The metrics registry says *that* the job is
unhealthy; this module reconstructs *what the last N steps looked like on
this rank* when it mattered: a per-rank, fixed-size, host-side ring buffer
continuously recording structured events (in the port: the serving
engine's warmup, replica failures, parks and restores, weight pulls and
heals, autoscale actions and tripwires), plus a ``dump()`` that writes
the buffer as a self-describing JSON bundle together with the process's
topology state, the registered blocks (the scheduler's ``serve``
block), the armed time-series tails and ``metrics_summary()``.

Cost discipline (the same contract as the chaos hooks, pinned by test):

* the hot path is one dict build + one ``deque.append`` — both GIL-atomic,
  so recording is lock-free and never blocks a step;
* nothing touches the device or the program cache — zero retraces, and
  buffer donation is untouched;
* the metrics registry and the context are read lazily (dump time
  only, and only when already loaded).  The port has no timeline yet, so
  a bundle's ``open_spans`` is None.

Dump-on-failure: :func:`maybe_enable_from_env` honors ``BLUEFOG_FLIGHT_DIR``
(bundle directory; also installs a SIGTERM handler, a ``sys.excepthook``
chain, and an atexit flush so a dying rank writes its bundle on the way
out) and ``BLUEFOG_FLIGHT_EVENTS`` (ring capacity, default 4096, 0
disables).  The bundle's schema is the JAX package's, so its
``tools/postmortem.py`` reads the port's bundles too.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .config import logger

__all__ = [
    "SCHEMA", "record", "record_op", "note_failure",
    "events", "last_event", "last_event_description",
    "dump", "configure", "capacity", "set_dump_dir", "dump_dir", "enabled",
    "maybe_enable_from_env", "install_crash_handlers", "reset",
]

SCHEMA = "bluefog-flight-1"
ENV_DIR = "BLUEFOG_FLIGHT_DIR"
ENV_EVENTS = "BLUEFOG_FLIGHT_EVENTS"
DEFAULT_CAPACITY = 4096

_buf: deque = deque(maxlen=DEFAULT_CAPACITY)
_seq = itertools.count(1)
_last_seq = 0                    # monotone high-water mark (dropped = it - len)
_op_calls: Dict[str, int] = {}   # per-op call index for "call 41" messages
_dump_dir: Optional[str] = None
_dump_reasons: List[str] = []
_dump_lock = threading.Lock()
_handlers_installed = False
_prev_excepthook = None
_prev_sigterm = None


# ---------------------------------------------------------------------------
# Recording (the lock-free hot path)
# ---------------------------------------------------------------------------

def record(kind: str, name: str = "", step: Optional[int] = None,
           **fields: Any) -> None:
    """Append one structured event to the ring buffer.

    ``deque.append`` on a bounded deque is atomic under the GIL, so this is
    safe from any thread without a lock; the oldest event is dropped once
    the buffer is full.  No-op when the capacity is 0.
    """
    global _last_seq
    if _buf.maxlen == 0:
        return
    ev: Dict[str, Any] = {"seq": next(_seq), "ts": time.time(), "kind": kind}
    if name:
        ev["name"] = name
    if step is not None:
        ev["step"] = step
    if fields:
        ev.update(fields)
    _last_seq = ev["seq"]
    _buf.append(ev)


def record_op(op_name: str) -> None:
    """One eager-op dispatch (``api._dispatch`` / window moves): records an
    ``op`` event carrying this op's 1-based call index."""
    if _buf.maxlen == 0:
        return
    n = _op_calls.get(op_name, 0) + 1
    _op_calls[op_name] = n
    record("op", name=op_name, call=n)


def note_failure(name: str, detail: str = "",
                 step: Optional[int] = None) -> Optional[str]:
    """Record a ``failure`` event and, when a dump directory is configured,
    flush the bundle immediately (the dump-on-failure entry point used by
    the watchdog timeout, the non-finite rollback, and the train-loop
    exception path).  Returns the bundle path when one was written."""
    record("failure", name=name, step=step, detail=detail[:500])
    if _dump_dir is not None:
        try:
            return dump(reason=name)
        except OSError as e:                              # pragma: no cover
            logger.warning("flight dump failed: %s", e)
    return None


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def events() -> List[dict]:
    """Snapshot of the buffered events, oldest first."""
    return list(_buf)


def last_event() -> Optional[dict]:
    """The most recent event, or None when the buffer is empty/disabled."""
    try:
        return _buf[-1]
    except IndexError:
        return None


def last_event_description(now: Optional[float] = None) -> Optional[str]:
    """Human-oriented "where was this rank last seen" line for watchdog
    messages: ``"neighbor_allreduce call 41, 12.3s ago"``.

    Skips the recorder's own meta events (``stall``/``dump``) — a second
    stall warning should still point at the op the rank was last seen in,
    not at the first warning."""
    ev = None
    for cand in reversed(_buf):
        if cand.get("kind") not in ("stall", "dump"):
            ev = cand
            break
    if ev is None:
        return None
    age = (time.time() if now is None else now) - ev.get("ts", 0.0)
    what = ev.get("name") or ev.get("kind", "?")
    if ev.get("kind") == "op" and "call" in ev:
        what = f"{what} call {ev['call']}"
    elif "step" in ev:
        what = f"{what} step {ev['step']}"
    return f"{what}, {age:.1f}s ago"


def capacity() -> int:
    return _buf.maxlen if _buf.maxlen is not None else 0


def configure(new_capacity: int) -> None:
    """Resize the ring (keeps the newest events; 0 disables recording)."""
    global _buf
    if new_capacity < 0:
        raise ValueError("flight capacity must be >= 0")
    _buf = deque(_buf, maxlen=int(new_capacity))


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------

def _rank() -> int:
    """This process's rank: the launcher bootstrap env, else 0 (the
    stacked ranks of one process share one recorder)."""
    try:
        return int(os.environ.get("BLUEFOG_PROCESS_ID", "0"))
    except ValueError:
        return 0


def _topology_block() -> Optional[dict]:
    """Topology and healed-schedule state, when the context is
    initialized.  Guarded on the modules already being loaded."""
    ctx_mod = sys.modules.get("bluefog_tpu_torch.parallel.context")
    if ctx_mod is None or not ctx_mod.is_initialized():
        return None
    out: dict = {}
    try:
        ctx = ctx_mod.get_context()
        out["size"] = ctx.size
        try:
            sched = ctx.static_schedule()
            out["in_neighbors"] = [list(map(int, s))
                                   for s in sched.in_neighbors]
        except RuntimeError:
            out["in_neighbors"] = None
        res = sys.modules.get("bluefog_tpu_torch.resilience")
        dead = tuple(res.dead_ranks()) if res is not None else ()
        retired = tuple(res.retired_ranks()) if res is not None else ()
        out["dead_ranks"] = list(dead)
        if retired:
            out["retired_ranks"] = list(retired)
        out["healed"] = bool(dead or retired)
    except Exception as e:                                # pragma: no cover
        return {"error": f"{type(e).__name__}: {e}"[:200]}
    return out


_TS_TAIL = 256          # points per armed metric embedded in a bundle


def _timeseries_block() -> Optional[dict]:
    """Tails of the armed history rings (:mod:`..utils.timeseries`) —
    postmortems carry the *trajectory* into the failure, not just last
    values.  Guarded on the module being loaded; bounded at the last
    ``_TS_TAIL`` points per metric so a bundle stays small.  Points are
    ``[monotonic_ts, value]``; the ``anchor`` pairs one monotonic instant
    with its wall time so tools can place points against the bundle's
    wall-clock ``ts`` and event timestamps."""
    ts_mod = sys.modules.get("bluefog_tpu_torch.utils.timeseries")
    if ts_mod is None:
        return None
    try:
        series = {}
        for name in ts_mod.armed_metrics():
            pts = ts_mod.history(name)[-_TS_TAIL:]
            if pts:
                series[name] = [[round(float(t), 6), float(v)]
                                for t, v in pts]
        if not series:
            return None
        return {"anchor": {"mono": time.monotonic(), "wall": time.time()},
                "series": series}
    except Exception:                                     # pragma: no cover
        return None


def _metrics_block() -> Optional[dict]:
    try:
        from . import metrics as _metrics
        return _metrics.metrics_summary()
    except Exception:                                     # pragma: no cover
        return None


def dump(path: Optional[str] = None, reason: str = "manual") -> str:
    """Write the bundle (events + process state) as JSON; returns the path.

    Default path is ``<dump_dir>/flight_rank<r>.json`` — one file per rank,
    overwritten on each dump (the ring holds the newest events either way;
    ``reasons`` keeps the dump history).  The write is atomic (tmp +
    rename) so a bundle is torn only by a hard kill mid-rename — and
    ``tools/postmortem.py`` tolerates torn bundles regardless.
    """
    with _dump_lock:
        _dump_reasons.append(reason)
        rank = _rank()
        if path is None:
            base = _dump_dir if _dump_dir is not None else "."
            path = os.path.join(base, f"flight_rank{rank}.json")
        bundle = {
            "schema": SCHEMA,
            "rank": rank,
            "pid": os.getpid(),
            "ts": time.time(),
            "reason": reason,
            "reasons": list(_dump_reasons),
            "capacity": capacity(),
            "n_events": len(_buf),
            "dropped": max(0, _last_seq - len(_buf)),
            "events": list(_buf),
            "topology": _topology_block(),
            "open_spans": None,                # no timeline in the port
            "metrics": _metrics_block(),
            "timeseries": _timeseries_block(),
        }
        for name, fn in list(_block_providers.items()):
            try:
                bundle[name] = fn()
            except Exception as e:                        # pragma: no cover
                # a sick provider must never lose the bundle it narrates
                bundle[name] = {"error": f"{type(e).__name__}: {e}"}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(bundle, f)
        os.replace(tmp, path)
    record("dump", name=reason, path=path)
    return path


# ---------------------------------------------------------------------------
# Extra bundle blocks
# ---------------------------------------------------------------------------
# Subsystems with state worth a postmortem but no business importing this
# module's internals (the serve scheduler's in-flight request ids, for one)
# register a provider; each dump calls it and embeds the returned dict as a
# top-level bundle key of the same name.

_block_providers: dict = {}

_RESERVED_BLOCKS = frozenset({
    "schema", "rank", "pid", "ts", "reason", "reasons", "capacity",
    "n_events", "dropped", "events", "topology", "open_spans", "metrics",
    "timeseries"})


def register_block(name: str, fn) -> None:
    """Register ``fn() -> dict`` to contribute bundle key ``name``."""
    if name in _RESERVED_BLOCKS:
        raise ValueError(f"block name {name!r} collides with a core "
                         "bundle key")
    _block_providers[name] = fn


def unregister_block(name: str) -> None:
    _block_providers.pop(name, None)


# ---------------------------------------------------------------------------
# Dump-on-failure plumbing
# ---------------------------------------------------------------------------

def set_dump_dir(path: Optional[str]) -> None:
    global _dump_dir
    _dump_dir = path


def dump_dir() -> Optional[str]:
    return _dump_dir


def enabled() -> bool:
    """True when failures auto-dump (a dump directory is configured)."""
    return _dump_dir is not None


def _excepthook(tp, val, tb):
    try:
        note_failure("exception", detail=f"{tp.__name__}: {val}")
    except Exception:                                     # pragma: no cover
        pass
    (_prev_excepthook or sys.__excepthook__)(tp, val, tb)


def _on_sigterm(signum, frame):
    try:
        record("signal", name="SIGTERM")
        dump(reason="sigterm")
    except Exception:                                     # pragma: no cover
        pass
    # a SIGTERM is often a spot-preemption advance notice: the trace ring
    # would otherwise only flush at atexit, which a follow-up SIGKILL skips
    try:
        from . import tracing as _tracing
        if _tracing.enabled():
            _tracing.flush()
    except Exception:                                     # pragma: no cover
        pass
    if callable(_prev_sigterm):
        _prev_sigterm(signum, frame)
        return
    # restore the default disposition and re-raise so the exit code still
    # says "terminated by SIGTERM" to the supervisor
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install_crash_handlers() -> bool:
    """Chain a flush into ``sys.excepthook``, SIGTERM, and atexit so the
    bundle survives the death of this process.  Idempotent; returns False
    when already installed or when no dump directory is configured."""
    global _handlers_installed, _prev_excepthook, _prev_sigterm
    if _handlers_installed or _dump_dir is None:
        return False
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
        _prev_sigterm = None if prev in (signal.SIG_DFL, signal.SIG_IGN) else prev
    except ValueError:
        pass                     # not the main thread: excepthook/atexit only
    import atexit
    atexit.register(_final_dump)
    _handlers_installed = True
    return True


def _final_dump() -> None:
    if _dump_dir is not None:
        try:
            dump(reason="exit")
        except OSError:                                   # pragma: no cover
            pass


def maybe_enable_from_env() -> bool:
    """Honor ``BLUEFOG_FLIGHT_EVENTS`` / ``BLUEFOG_FLIGHT_DIR`` at init
    (same pattern as the metrics and tracing env hooks).  Returns True
    when a dump directory was armed."""
    cap = os.environ.get(ENV_EVENTS)
    if cap:
        try:
            configure(int(cap))
        except ValueError:
            logger.warning("%s=%r is not an integer; keeping capacity %d",
                           ENV_EVENTS, cap, capacity())
    out_dir = os.environ.get(ENV_DIR)
    if not out_dir:
        return False
    set_dump_dir(out_dir)
    install_crash_handlers()
    return True


def reset() -> None:
    """Test isolation: clear the buffer/counters, disarm dumps, and restore
    any chained excepthook/SIGTERM handlers."""
    global _buf, _seq, _last_seq, _dump_dir, _handlers_installed
    global _prev_excepthook, _prev_sigterm
    _buf = deque(maxlen=DEFAULT_CAPACITY)
    _seq = itertools.count(1)
    _last_seq = 0
    _op_calls.clear()
    _dump_reasons.clear()
    _block_providers.clear()
    _dump_dir = None
    if _handlers_installed:
        if sys.excepthook is _excepthook:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
        try:
            if signal.getsignal(signal.SIGTERM) is _on_sigterm:
                signal.signal(signal.SIGTERM,
                              _prev_sigterm or signal.SIG_DFL)
        except ValueError:                                # pragma: no cover
            pass
        _handlers_installed = False
    _prev_excepthook = None
    _prev_sigterm = None
