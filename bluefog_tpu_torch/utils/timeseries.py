"""Bounded in-process time series: metric history the control loops can read
(the port's own copy of ``bluefog_tpu/utils/timeseries.py``).

The registry (:mod:`.metrics`) keeps *current* values —
one float per labeled series — which is all a scrape needs but nothing a
control loop can score: the SLO burn-rate engine wants "how many of the
last five minutes' latencies breached the target", the re-tuner wants
"has step time regressed since the plan was applied", and the AutoScaler
wants a p99 *trend*, not a point.  This module attaches an opt-in,
bounded ring-buffer history to individual registry metrics:

* **arming is per metric** — :func:`arm` hooks one named metric; every
  subsequent update (``Counter.inc`` / ``Gauge.set`` /
  ``Histogram.observe``) also appends ``(monotonic_ts,
  value)`` to that metric's ring.  Unarmed metrics pay exactly one
  ``is None`` attribute check on their hot path — the same zero-cost
  contract as the flight recorder;
* **the ring is bounded** — ``deque(maxlen=capacity)`` (default 2048
  points, ``BLUEFOG_TS_WINDOW`` overrides), so an armed metric's memory
  is O(capacity) forever and the append is one GIL-atomic
  ``deque.append`` — lock-free, never blocks the hot path;
* **reads are windowed** — :func:`history` returns the ``(ts, value)``
  points inside a trailing wall-clock window; :func:`percentile`,
  :func:`mean`, :func:`rate`, and :func:`over_fraction` are the derived
  views the AutoScaler, and the SLO engine
  (:mod:`bluefog_tpu_torch.diagnostics`) score.

What gets appended: a Gauge appends the value it was set to, a Histogram
appends each raw observation, a Counter appends its new *cumulative
total* (so :func:`rate` is a first difference over the window).  All
timestamps are ``time.monotonic()`` — windows never jump under NTP.

Nothing here touches a device.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from .config import logger

__all__ = [
    "Ring", "arm", "disarm", "armed", "armed_metrics", "append",
    "history", "latest", "mean", "percentile", "rate", "over_fraction",
    "default_capacity", "reset",
]

ENV_WINDOW = "BLUEFOG_TS_WINDOW"
DEFAULT_CAPACITY = 2048

_rings: Dict[str, "Ring"] = {}


def default_capacity() -> int:
    """Ring capacity in points: ``BLUEFOG_TS_WINDOW`` or 2048."""
    raw = os.environ.get(ENV_WINDOW)
    if raw:
        try:
            cap = int(raw)
            if cap > 0:
                return cap
            logger.warning("%s=%r must be > 0; using %d",
                           ENV_WINDOW, raw, DEFAULT_CAPACITY)
        except ValueError:
            logger.warning("%s=%r is not an integer; using %d",
                           ENV_WINDOW, raw, DEFAULT_CAPACITY)
    return DEFAULT_CAPACITY


class Ring:
    """Bounded ``(monotonic_ts, value)`` history for one metric.

    ``append`` is the hot path: one tuple build + one ``deque.append``
    (GIL-atomic on a bounded deque), no lock.  Everything else snapshots
    the deque first.
    """

    __slots__ = ("name", "_buf")

    def __init__(self, name: str, capacity: Optional[int] = None):
        if capacity is None:
            capacity = default_capacity()
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.name = name
        self._buf: deque = deque(maxlen=int(capacity))

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def __len__(self) -> int:
        return len(self._buf)

    def append(self, value: float, ts: Optional[float] = None) -> None:
        self._buf.append((time.monotonic() if ts is None else ts,
                          float(value)))

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points inside the trailing ``window_s`` (all points when None),
        oldest first."""
        pts = list(self._buf)
        if window_s is None:
            return pts
        cut = (time.monotonic() if now is None else now) - float(window_s)
        return [p for p in pts if p[0] >= cut]

    def values(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[float]:
        return [v for _, v in self.points(window_s, now)]


# ---------------------------------------------------------------------------
# Arming (the metrics hook)
# ---------------------------------------------------------------------------

def arm(name: str, capacity: Optional[int] = None) -> Ring:
    """Attach a history ring to registry metric ``name``.

    The metric need not exist yet: the ring is installed now and
    re-attached automatically by the registry factory when the metric is
    (re)created (``reset_metrics`` in tests drops metric objects; the
    arm survives).  Idempotent — re-arming returns the existing ring.
    """
    ring = _rings.get(name)
    if ring is None:
        ring = Ring(name, capacity)
        _rings[name] = ring
    m = _metrics.get_metric(name)
    if m is not None:
        m._ts = ring
    return ring


def disarm(name: str) -> None:
    """Detach and drop the ring for ``name`` (history is discarded)."""
    _rings.pop(name, None)
    m = _metrics.get_metric(name)
    if m is not None:
        m._ts = None


def armed(name: str) -> bool:
    return name in _rings


def armed_metrics() -> Tuple[str, ...]:
    return tuple(sorted(_rings))


def _ring_for(name: str) -> Optional[Ring]:
    """Registry-factory callback: the ring to attach to a fresh metric
    object named ``name`` (None when unarmed)."""
    return _rings.get(name)


def append(name: str, value: float, ts: Optional[float] = None) -> bool:
    """Append directly to ``name``'s ring (for series that are not
    registry metrics — e.g. the AutoScaler's derived p99).  Arms the
    ring on first use.  Returns True when a point landed."""
    ring = _rings.get(name)
    if ring is None:
        ring = arm(name)
    ring.append(value, ts)
    return True


# ---------------------------------------------------------------------------
# Windowed reads
# ---------------------------------------------------------------------------

def history(name: str, window_s: Optional[float] = None,
            now: Optional[float] = None) -> List[Tuple[float, float]]:
    """``(monotonic_ts, value)`` points for ``name`` inside the trailing
    window, oldest first ([] when unarmed or empty)."""
    ring = _rings.get(name)
    return ring.points(window_s, now) if ring is not None else []


def latest(name: str) -> Optional[float]:
    ring = _rings.get(name)
    if ring is None:
        return None
    try:
        return ring._buf[-1][1]
    except IndexError:
        return None


def mean(name: str, window_s: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    xs = history(name, window_s, now)
    return sum(v for _, v in xs) / len(xs) if xs else None


def percentile(name: str, q: float, window_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[float]:
    """Exact q-th percentile (q in 0..100) over the windowed values."""
    xs = sorted(v for _, v in history(name, window_s, now))
    if not xs:
        return None
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def rate(name: str, window_s: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    """First difference per second over the window — the per-second rate
    of an armed (cumulative) Counter.  None with fewer than 2 points or
    zero elapsed time."""
    pts = history(name, window_s, now)
    if len(pts) < 2:
        return None
    (t0, v0), (t1, v1) = pts[0], pts[-1]
    if t1 <= t0:
        return None
    return (v1 - v0) / (t1 - t0)


def over_fraction(name: str, threshold: float,
                  window_s: Optional[float] = None,
                  now: Optional[float] = None) -> Optional[float]:
    """Fraction of windowed values strictly above ``threshold`` — the
    SLO engine's bad-event ratio.  None when the window is empty."""
    xs = history(name, window_s, now)
    if not xs:
        return None
    return sum(1 for _, v in xs if v > threshold) / len(xs)


def _clear_points() -> None:
    """Drop every ring's points but keep the arming (called by
    ``metrics.reset_metrics`` so history never leaks across registry
    resets)."""
    for ring in _rings.values():
        ring._buf.clear()


def reset() -> None:
    """Test isolation: drop every ring and detach from live metrics."""
    for name in list(_rings):
        m = _metrics.get_metric(name)
        if m is not None:
            m._ts = None
    _rings.clear()
