"""SLO burn rates and anomaly tripwires (the port's own copy of
:class:`SLOEngine` from ``bluefog_tpu/diagnostics.py``; it imports no JAX
and nothing of the JAX package).

Only the SLO engine is ported: it reads the time-series store and never
touches a device.  Its fleet-view leg scores nothing here, because the
port has no gossiped fleet view yet; that is what the JAX engine does
when no fleet view is armed.  The rest of the JAX module (the consensus
probes, peer health) waits for ROADMAP queue 1, item 8.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .utils import flight as _flight
from .utils import metrics as _metrics
from .utils import timeseries as _ts
from .utils.config import logger

__all__ = ["SLOEngine", "DEFAULT_SLO_WINDOWS"]


# ---------------------------------------------------------------------------
# SLO burn rates + anomaly tripwires (read the time-series store)
# ---------------------------------------------------------------------------

DEFAULT_SLO_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("5m", 300.0), ("1h", 3600.0))

_LAT = "bluefog_serve_token_latency_seconds"
_TTFT_HIT = "bluefog_serve_ttft_hit_seconds"
_TTFT_COLD = "bluefog_serve_ttft_cold_seconds"
_STEP = "bluefog_step_time_s"
_CONSENSUS = "bluefog_consensus_distance_max"
_QDEPTH = "bluefog_serve_queue_depth"
_REQ_OK = "bluefog_req_ok"


class SLOEngine:
    """Declared objectives scored as multi-window burn rates, plus anomaly
    tripwires over the same time-series.

    The Bluefog layering lesson (L2 negotiation sits above the collective
    layer) applied to serving: SLO logic lives *above* the engine and the
    scheduler, reading only the time-series store
    (:mod:`.utils.timeseries`) — it never touches device state,
    so arming it cannot retrace a warmed program or break donation.

    **Objectives** (env defaults, all overridable as ctor args):

    * latency — 99% of per-token latencies under ``BLUEFOG_SLO_P99_MS``
      (250 ms; the same knob the AutoScaler scales on),
    * TTFT — 99% of time-to-first-token under ``BLUEFOG_SLO_TTFT_MS``
      (500 ms; hit and cold prefills pooled),
    * availability — ``BLUEFOG_SLO_AVAILABILITY`` (0.99) of requests
      reach ``done`` rather than ``failed``.

    **Burn rate** (Google SRE workbook shape): the fraction of bad events
    in a trailing window divided by the objective's error budget — 1.0
    means "exactly on budget", 10 on the 5m window means "the monthly
    budget gone in hours".  Every :meth:`observe` publishes
    ``bluefog_slo_burn_rate{window=,slo=}`` gauges for each declared
    window (default 5m/1h, scalable via ``window_scale`` so tests and
    benches can compress time).

    **Tripwires** — anomaly detectors that fire a ``tripwire`` flight
    event + ``bluefog_tripwire_total{kind=}`` + a warn-once log:

    * ``step_time_regression`` — trailing step-time mean exceeds
      ``step_time_factor ×`` the banked baseline (the first
      ``step_baseline_n`` observations, or an explicit
      ``step_baseline_s`` from a bench artifact),
    * ``consensus_stall`` — consensus distance re-expanded to
      ``consensus_factor ×`` its windowed minimum instead of contracting,
    * ``queue_growth_idle`` — the admission queue holds work while
      nothing is in flight for ``idle_steps`` consecutive observes (a
      wedged scheduler: demand exists, no lane is burning it),
    * ``slo_fast_burn`` — any objective's burn rate on the *shortest*
      window exceeds ``burn_alert_threshold`` (default 10×: the SRE
      workbook's page-now condition — at that pace a month's budget is
      gone in about three days).

    Attach to a scheduler with ``sched.attach_slo(engine)`` (observe runs
    after every step), or call :meth:`observe` manually train-side.
    """

    def __init__(self, *, p99_ms: Optional[float] = None,
                 ttft_ms: Optional[float] = None,
                 availability: Optional[float] = None,
                 windows: Optional[Dict[str, float]] = None,
                 window_scale: float = 1.0,
                 step_time_factor: float = 2.0,
                 step_baseline_n: int = 20,
                 step_baseline_s: Optional[float] = None,
                 consensus_factor: float = 2.0,
                 consensus_min: float = 1e-6,
                 idle_steps: int = 3,
                 burn_alert_threshold: float = 10.0,
                 tripwire_cooldown: int = 50):
        from .utils.config import env_float
        if p99_ms is None:
            p99_ms = env_float("BLUEFOG_SLO_P99_MS", 250.0)
        if ttft_ms is None:
            ttft_ms = env_float("BLUEFOG_SLO_TTFT_MS", 500.0)
        if availability is None:
            availability = env_float("BLUEFOG_SLO_AVAILABILITY", 0.99)
        if p99_ms <= 0 or ttft_ms <= 0:
            raise ValueError("SLO latency targets must be > 0 ms")
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"availability target must be in (0, 1), got {availability}")
        if window_scale <= 0:
            raise ValueError(f"window_scale must be > 0, got {window_scale}")
        self.p99_s = float(p99_ms) / 1000.0
        self.ttft_s = float(ttft_ms) / 1000.0
        self.availability = float(availability)
        if windows is None:
            windows = dict(DEFAULT_SLO_WINDOWS)
        self.windows = {n: float(s) * float(window_scale)
                        for n, s in windows.items()}
        self.step_time_factor = float(step_time_factor)
        self.step_baseline_n = max(2, int(step_baseline_n))
        self.step_baseline_s = step_baseline_s
        self.consensus_factor = float(consensus_factor)
        self.consensus_min = float(consensus_min)
        self.idle_steps = max(1, int(idle_steps))
        self.burn_alert_threshold = float(burn_alert_threshold)
        self.tripwire_cooldown = max(1, int(tripwire_cooldown))
        # every signal the engine scores gets a history ring (idempotent)
        for name in (_LAT, _TTFT_HIT, _TTFT_COLD, _STEP, _CONSENSUS,
                     _QDEPTH, _REQ_OK):
            _ts.arm(name)
        self.last_burn: Dict[Tuple[str, str], Optional[float]] = {}
        self.fired: list = []
        self._observes = 0
        self._seen_done = 0
        self._seen_failed = 0
        self._idle_streak = 0
        self._last_fire: Dict[str, int] = {}
        self._warned: set = set()

    # -- burn rates ----------------------------------------------------

    def _bad_fraction(self, slo: str, window_s: float,
                      now: Optional[float]) -> Optional[float]:
        if slo == "p99":
            return _ts.over_fraction(_LAT, self.p99_s, window_s, now)
        if slo == "ttft":
            pts = (_ts.history(_TTFT_HIT, window_s, now)
                   + _ts.history(_TTFT_COLD, window_s, now))
            if not pts:
                return None
            return sum(1 for _, v in pts if v > self.ttft_s) / len(pts)
        if slo == "availability":
            ok = _ts.history(_REQ_OK, window_s, now)
            if not ok:
                return None
            return sum(1 for _, v in ok if v < 0.5) / len(ok)
        raise ValueError(f"unknown slo {slo!r}")

    def _budget(self, slo: str) -> float:
        # p99/ttft targets are "99% of events under the bound" by
        # construction; availability declares its own good-event target
        return (1.0 - self.availability) if slo == "availability" else 0.01

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[Tuple[str, str], Optional[float]]:
        """``{(window, slo): burn}`` over every declared window (None
        where the window holds no events yet).  Publishes the
        ``bluefog_slo_burn_rate{window=,slo=}`` gauges."""
        out: Dict[Tuple[str, str], Optional[float]] = {}
        g = _metrics.gauge(
            "bluefog_slo_burn_rate",
            "error-budget burn rate per declared SLO and trailing window")
        for wname, wsec in self.windows.items():
            for slo in ("p99", "ttft", "availability"):
                bad = self._bad_fraction(slo, wsec, now)
                burn = None if bad is None else bad / self._budget(slo)
                out[(wname, slo)] = burn
                if burn is not None:
                    g.set(burn, window=wname, slo=slo)
        self.last_burn = out
        return out

    def breached(self, threshold: float = 1.0
                 ) -> Dict[Tuple[str, str], float]:
        """Last-computed burn rates above ``threshold`` (budget being
        spent faster than earned)."""
        return {k: v for k, v in self.last_burn.items()
                if v is not None and v > threshold}

    # -- tripwires -----------------------------------------------------

    def _fire(self, kind: str, **detail) -> bool:
        last = self._last_fire.get(kind)
        if last is not None \
                and self._observes - last < self.tripwire_cooldown:
            return False
        self._last_fire[kind] = self._observes
        _metrics.counter("bluefog_tripwire_total",
                         "anomaly tripwires fired, by kind").inc(kind=kind)
        _flight.record("tripwire", name=kind, **detail)
        if kind not in self._warned:
            self._warned.add(kind)
            logger.warning("tripwire %s: %s", kind, detail)
        self.fired.append({"kind": kind, "observe": self._observes,
                           **detail})
        return True

    def _check_step_regression(self, now: Optional[float]) -> None:
        vals = [v for _, v in _ts.history(_STEP, None, now)]
        n = self.step_baseline_n
        baseline = self.step_baseline_s
        if baseline is None:
            if len(vals) < 2 * n:
                return                   # still banking the baseline
            baseline = sum(vals[:n]) / n
        elif not vals:
            return
        recent = vals[-min(n, len(vals)):]
        recent_mean = sum(recent) / len(recent)
        if baseline > 0 and recent_mean > self.step_time_factor * baseline:
            self._fire("step_time_regression",
                       baseline_s=round(baseline, 6),
                       recent_s=round(recent_mean, 6),
                       factor=round(recent_mean / baseline, 3))

    def _check_consensus_stall(self, now: Optional[float]) -> None:
        vals = [v for _, v in _ts.history(_CONSENSUS, None, now)]
        if len(vals) < 3:
            return
        lo = min(vals)
        latest = vals[-1]
        if latest > max(self.consensus_factor * lo, self.consensus_min) \
                and latest >= vals[0]:
            self._fire("consensus_stall",
                       min_distance=round(lo, 9),
                       latest_distance=round(latest, 9))

    def _check_fleet(self) -> None:
        """A breach anywhere is a breach everywhere: when a fleet view is
        armed, score the gossiped worst-of-fleet burn rate against the
        same page-now threshold the local signals use and fire the
        existing tripwire path with the origin rank attached — rank 0
        need not be the rank that saw the breach."""
        # the port has no fleet view (ROADMAP queue 1, item 10): this is
        # the JAX engine's behavior with none armed
        return

    def _check_queue_idle(self, sched) -> None:
        if sched.pending > 0 and sched.in_flight == 0:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        if self._idle_streak >= self.idle_steps:
            self._fire("queue_growth_idle", pending=sched.pending,
                       idle_observes=self._idle_streak)

    # -- the per-step entry point --------------------------------------

    def observe(self, sched=None, now: Optional[float] = None) -> dict:
        """Fold in one step: availability events from ``sched``'s terminal
        counts, burn-rate gauges over every window, tripwire checks.
        Returns ``{"burn_rates": ..., "tripwires": [fired-this-call]}``.
        """
        self._observes += 1
        n_before = len(self.fired)
        if sched is not None:
            done, failed = len(sched.completed), len(sched.failed)
            for _ in range(done - self._seen_done):
                _ts.append(_REQ_OK, 1.0, ts=now)
            for _ in range(failed - self._seen_failed):
                _ts.append(_REQ_OK, 0.0, ts=now)
            self._seen_done, self._seen_failed = done, failed
        burn = self.burn_rates(now)
        short = min(self.windows, key=self.windows.get) if self.windows \
            else None
        if short is not None:
            for slo in ("p99", "ttft", "availability"):
                rate = burn.get((short, slo))
                if rate is not None and rate > self.burn_alert_threshold:
                    self._fire("slo_fast_burn", slo=slo, window=short,
                               burn=round(rate, 3))
        self._check_fleet()
        self._check_step_regression(now)
        self._check_consensus_stall(now)
        if sched is not None:
            self._check_queue_idle(sched)
        return {"burn_rates": burn,
                "tripwires": list(self.fired[n_before:])}
