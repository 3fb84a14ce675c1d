"""Timeline tracing: Chrome-trace activities plus a device trace (the
port's own copy of ``bluefog_tpu/utils/timeline.py``).

Counterpart of the reference's timeline (``common/timeline.{h,cc}``,
``basics.py:456-546``).  The host side is the reference's activity API:

* ``start_timeline(path)`` / ``stop_timeline()`` write
  ``<path>.activities.json`` (Chrome-tracing JSON of host activity spans,
  through the native ring-buffer writer when it loads, else a list) and,
  on the card, ``<path>.device_trace.json``: a ``torch.profiler`` trace
  with the CUDA activities, where the same span names appear as
  ``record_function`` ranges;
* ``timeline_start_activity`` / ``timeline_end_activity`` /
  ``timeline_context``, ``record_span`` (a finished span from any
  thread), ``op_span`` (one eager op call) and ``named_span`` (a phase of
  the train step: COMMUNICATE, ADAPT, GRADIENT, STATE_SYNC).

Every span is a no-op when the timeline is off: one module attribute
read.  ``BLUEFOG_TIMELINE`` (the output prefix) starts it at ``init``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .. import _native

__all__ = ["start_timeline", "stop_timeline", "timeline_start_activity",
           "timeline_end_activity", "timeline_context", "record_span",
           "op_span", "named_span", "maybe_start_from_env", "active",
           "native_active", "device_trace_path"]

ENV_VAR = "BLUEFOG_TIMELINE"

_lock = threading.Lock()
_events: List[dict] = []
_open_spans: Dict[str, list] = {}
_path_prefix: Optional[str] = None
_profiler = None                 # torch.profiler.profile while tracing
_device_trace: Optional[str] = None
_native_active = False
_atexit_registered = False


def active() -> bool:
    return _path_prefix is not None


def native_active() -> bool:
    """True while the native writer (not the Python list) takes spans."""
    return _native_active


def device_trace_path() -> Optional[str]:
    """The device trace the last :func:`stop_timeline` wrote (None when
    none was taken)."""
    return _device_trace


def _start_device_trace():
    import torch
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def start_timeline(path_prefix: str, with_device_trace: bool = True) -> bool:
    """Begin collecting a timeline (one file a process).  It flushes on
    :func:`stop_timeline`, on ``shutdown()``, or at interpreter exit.
    The device trace is taken when a card is present and
    ``with_device_trace``; a machine without one writes the activities
    only."""
    global _path_prefix, _profiler, _native_active, _atexit_registered
    global _device_trace
    with _lock:
        if _path_prefix is not None:
            return False
        _path_prefix = path_prefix
        _events.clear()
        _open_spans.clear()
        _device_trace = None
        if not _atexit_registered:
            import atexit
            atexit.register(stop_timeline)
            _atexit_registered = True
    out = path_prefix + ".activities.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    _native_active = _native.timeline_start(out)
    if with_device_trace:
        _profiler = _start_device_trace()
    return True


def stop_timeline() -> Optional[str]:
    """Flush the activity JSON (and the device trace) and return the
    activities path.  Spans still open are closed at the stop time, as
    the reference's writer drains its queue on shutdown."""
    global _path_prefix, _profiler, _native_active, _device_trace
    prof, _profiler = _profiler, None
    if prof is not None:
        prof.__exit__(None, None, None)
    dangling = []
    with _lock:
        if _path_prefix is None:
            return None
        prefix = _path_prefix
        out = prefix + ".activities.json"
        now = _now_us()
        pid = os.getpid()
        tid = threading.get_ident() % 1_000_000
        for tensor_name, spans in _open_spans.items():
            while spans:
                activity, t0, rf = spans.pop()
                dangling.append(rf)
                _emit(activity, tensor_name, t0, now - t0, pid, tid)
        _open_spans.clear()
        if _native_active:
            _native.timeline_stop()
            _native_active = False
        else:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "w") as f:
                json.dump({"traceEvents": _events, "displayTimeUnit": "ms"},
                          f)
        _path_prefix = None
    for rf in dangling:
        if rf is not None:
            rf.__exit__(None, None, None)
    if prof is not None:
        _device_trace = prefix + ".device_trace.json"
        prof.export_chrome_trace(_device_trace)
    return out


def _now_us() -> float:
    return time.perf_counter() * 1e6


def _emit(activity: str, tensor_name: str, t0: float, dur: float,
          pid: int, tid: int) -> None:
    """One complete span into the live writer (caller holds ``_lock``)."""
    if _native_active:
        _native.timeline_record(activity, tensor_name, "X", int(t0),
                                int(dur), pid, tid)
    else:
        _events.append({"name": activity, "cat": tensor_name, "ph": "X",
                        "ts": t0, "dur": dur, "pid": pid, "tid": tid})


def _range(label: str):
    """A ``record_function`` range, so the device trace carries the span
    name too (None when no device trace runs)."""
    if _profiler is None:
        return None
    import torch
    rf = torch.autograd.profiler.record_function(label)
    rf.__enter__()
    return rf


def timeline_start_activity(tensor_name: str,
                            activity_name: str = "ACTIVITY") -> bool:
    """Open a named span (reference: ``bf.timeline_start_activity``)."""
    if _path_prefix is None:
        return False
    rf = _range(f"{tensor_name}::{activity_name}")
    with _lock:
        _open_spans.setdefault(tensor_name, []).append(
            (activity_name, _now_us(), rf))
    return True


def timeline_end_activity(tensor_name: str) -> bool:
    """Close the innermost open span for ``tensor_name``."""
    if _path_prefix is None:
        return False
    with _lock:
        spans = _open_spans.get(tensor_name)
        if not spans:
            return False
        activity, t0, rf = spans.pop()
        _emit(activity, tensor_name, t0, _now_us() - t0, os.getpid(),
              threading.get_ident() % 1_000_000)
    if rf is not None:
        rf.__exit__(None, None, None)
    return True


def record_span(tensor_name: str, activity_name: str,
                start_us: float, dur_us: float) -> bool:
    """Record a finished span (no device range): for writers on threads
    that own no start/end pair, such as the stall watchdog.  Safe from any
    thread; a no-op when the timeline is off."""
    if _path_prefix is None:
        return False
    with _lock:
        if _path_prefix is None:
            return False
        _emit(activity_name, tensor_name, start_us, dur_us, os.getpid(),
              threading.get_ident() % 1_000_000)
    return True


@contextlib.contextmanager
def timeline_context(tensor_name: str, activity_name: str = "ACTIVITY"):
    """Span context manager (reference: ``bf.timeline_context``)."""
    timeline_start_activity(tensor_name, activity_name)
    try:
        yield
    finally:
        timeline_end_activity(tensor_name)


@contextlib.contextmanager
def op_span(tensor_name: str, activity_name: str = "COMMUNICATE"):
    """Host span for one eager op call (the op API's per-op activities,
    reference ``test/timeline_test.py:54-117``); the call's device time
    is in the device trace under the same name."""
    if _path_prefix is None:
        yield
    else:
        with timeline_context(tensor_name, activity_name):
            yield


@contextlib.contextmanager
def named_span(activity_name: str, tensor_name: str = "train_step"):
    """A phase of the train step.  The port runs its step eagerly, so the
    span covers the phase's host time on every call (JAX's fires once, at
    trace time, and labels the compiled program instead)."""
    if _path_prefix is None:
        yield
    else:
        with timeline_context(tensor_name, activity_name):
            yield


def maybe_start_from_env() -> bool:
    """Honor ``BLUEFOG_TIMELINE`` at init (reference: env_variable.rst)."""
    prefix = os.environ.get(ENV_VAR)
    if prefix:
        return start_timeline(prefix)
    return False
