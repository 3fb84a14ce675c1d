"""Stall detection for distributed steps (the port's own copy of
``bluefog_tpu/utils/watchdog.py``).

Counterpart of the reference's stalled-tensor watchdog
(``CheckForStalledTensors``, ``operations.cc:388-433``).  A stall here is
device work that never completes (a wedged kernel, a lost peer), so the
watchdog watches wall-clock completion: :func:`synchronize_with_watchdog`
waits for the work producing a result and logs an escalating warning
every ``interval`` seconds until it lands.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ..fusion import tree_flatten
from . import flight as _flight
from . import metrics as _metrics
from . import timeline as _tl
from .config import logger

__all__ = ["synchronize_with_watchdog", "DEFAULT_INTERVAL_S"]

DEFAULT_INTERVAL_S = 60.0   # reference: STALL_WARNING_TIME, operations.cc:47


def _block(x: Any) -> Any:
    """Wait until the device work producing ``x`` is done: an event on
    the current stream of each CUDA device ``x`` lives on, synchronized.
    CPU work is done when the call that made it returns."""
    import torch
    devices = {t.device for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()
    return x


def synchronize_with_watchdog(
    x: Any,
    interval: float = DEFAULT_INTERVAL_S,
    name: str = "step",
    timeout: Optional[float] = None,
) -> Any:
    """Wait for ``x`` (see :func:`_block`) and complain while waiting.

    Logs a warning every ``interval`` seconds until the work completes;
    returns ``x``.  Each warning increments
    ``bluefog_watchdog_stalls_total``, records a flight ``stall`` event and,
    when a timeline is active, a ``STALL`` span.

    ``timeout`` escalates to failure: after ``timeout`` seconds a
    :class:`TimeoutError` names the computation, the stall intervals
    elapsed and the last flight event, after the flight recorder has
    dumped its bundle.  Device work cannot be cancelled from Python: the
    blocked wait is abandoned on a daemon thread.  ``None`` keeps the
    warn-forever behavior.
    """
    done = threading.Event()
    t0 = time.monotonic()
    stalls = [0]                     # shared with the watch loop

    def watch():
        while not done.wait(interval):
            stalls[0] += 1
            waited = time.monotonic() - t0
            last = _flight.last_event_description()
            logger.warning(
                "%s has not completed after %.0f s — one or more devices/"
                "hosts may be stalled%s (reference: stalled-tensor warning)",
                name, waited,
                f"; last event: {last}" if last else "")
            _metrics.counter(
                "bluefog_watchdog_stalls_total",
                "watchdog stall-warning intervals elapsed").inc(name=name)
            _flight.record("stall", name=name, waited_s=waited)
            now_us = _tl._now_us()
            _tl.record_span(name, "STALL",
                            now_us - interval * 1e6, interval * 1e6)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    if timeout is None:
        try:
            return _block(x)
        finally:
            done.set()

    # Escalation path: block on a helper thread so this thread can give up.
    result: dict = {}
    finished = threading.Event()

    def block():
        try:
            result["value"] = _block(x)
        except BaseException as e:                 # surface on caller thread
            result["error"] = e
        finally:
            finished.set()

    blocker = threading.Thread(target=block, daemon=True)
    blocker.start()
    try:
        if not finished.wait(timeout):
            waited = time.monotonic() - t0
            _metrics.counter(
                "bluefog_watchdog_timeouts_total",
                "watchdog waits that hit their timeout").inc(name=name)
            last = _flight.last_event_description()
            msg = (
                f"{name} did not complete within {timeout:g} s (waited "
                f"{waited:.1f} s; {stalls[0]} stall-warning interval(s) of "
                f"{interval:g} s elapsed"
                + (f"; last event: {last}" if last else "")
                + ") — treating the computation as hung")
            # flush the black box before raising: the supervisor that
            # catches this may kill the process next
            _flight.note_failure("watchdog_timeout", detail=msg)
            raise TimeoutError(msg)
        if "error" in result:
            raise result["error"]
        return result["value"]
    finally:
        done.set()
