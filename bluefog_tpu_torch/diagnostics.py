"""Consensus-health probes and SLO burn rates (the port's own copy of
``bluefog_tpu/diagnostics.py``'s probes and :class:`SLOEngine`; it
imports no JAX and nothing of the JAX package).

The probes read stacked params (``[n, ...]`` leaves, this process's rows):

* **consensus distance** ``||x_i - mean(x)||`` per rank over the float
  leaves, flattened to one f32 vector a rank (the mean through the
  process group's sum, as JAX's ``psum``),
* **max neighbor disagreement** ``max_j ||x_i - x_j||`` over each rank's
  live in-neighbors, through the port's ``neighbor_allgather`` (trailing
  slots of low-degree ranks are zero-filled, so they are masked by
  in-degree and liveness),
* **window staleness**: per named window, the deliveries not yet
  consumed by a ``win_update``,
* the async strategy's **staleness depth** (:func:`observe_async_staleness`)
  and the per-rank **step-time** table with its straggler verdict.

``diagnose_consensus(params)`` is the one-shot probe; the train step's
``metrics_every_k`` runs it on the step's output params.  The gossiped
fleet-view carrier of the JAX probe has no counterpart here yet (ROADMAP
queue 1, item 10).  :func:`observe_step_time` moves the sleeps chaos
injected onto their target rank (the delay ledger of ``utils/chaos.py``).

Peer health (:func:`check_finite` and the table behind
:func:`unhealthy_ranks`) is the detection half of the resilience layer:
``resilience.py`` owns the response.

The SLO engine reads the time-series store and never touches a device.
Its fleet-view leg scores nothing here, because the port has no gossiped
fleet view yet; that is what the JAX engine does when no fleet view is
armed.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .fusion import tree_flatten
from .ops import collectives as _coll
from .parallel import context as _ctx
from .schedule import CommSchedule
from .utils import chaos as _chaos
from .utils import flight as _flight
from .utils import metrics as _metrics
from .utils import timeseries as _ts
from .utils.config import logger
from .utils.snapshot import live_tensors

__all__ = ["diagnose_consensus", "consensus_distance", "window_staleness",
           "observe_step_time", "last_step_times", "detect_stragglers",
           "observe_async_staleness", "check_finite",
           "observe_peer_finiteness", "record_peer_failure",
           "clear_peer_failures", "unhealthy_ranks", "peer_health",
           "reset_peer_health", "SLOEngine", "DEFAULT_SLO_WINDOWS"]


# ---------------------------------------------------------------------------
# Consensus probes
# ---------------------------------------------------------------------------

def _flat_f32(tree) -> torch.Tensor:
    """Each rank's float leaves as one f32 row, ``[rows, total]``
    (``[rows, 1]`` zeros when there are none)."""
    leaves = tree_flatten(tree)[0]
    rows = leaves[0].shape[0]
    parts = [x.reshape(rows, -1).to(torch.float32) for x in leaves
             if x.is_floating_point()]
    if not parts:
        return torch.zeros((rows, 1), dtype=torch.float32,
                           device=leaves[0].device)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _all_rows(t: torch.Tensor) -> np.ndarray:
    """A per-rank ``[rows]`` result over every process's rows, on the
    host (the JAX probe reads its distributed output whole)."""
    if _coll._procs()[0] > 1:
        t = _coll.allgather(t.reshape(-1, 1).contiguous())[0]
    return t.detach().cpu().numpy()


def _probe(params, sched: Optional[CommSchedule], n: int, dead: tuple,
           tvec: Optional[np.ndarray]):
    """(distance, disagreement[, own time, max in-neighbor time]) as
    ``[rows]`` tensors: the JAX probe program, rank by rank."""
    v = _flat_f32(params)
    rows, dev = v.shape[0], v.device
    alive = np.ones(n, np.float32)
    alive[list(dead)] = 0.0
    n_alive = float(alive.sum())
    me_alive = torch.as_tensor(_coll._local(alive, rows), device=dev)
    vbar = _coll.rank_sum(v * me_alive[:, None]) / n_alive
    dist = torch.sqrt(((v - vbar) ** 2).sum(dim=1)) * me_alive
    t_me = None
    payload = v
    if tvec is not None:
        t_me = torch.as_tensor(_coll._local(tvec, rows), device=dev)
        payload = torch.cat([v, t_me[:, None]], dim=1)
    nbr_tmax = t_me
    if sched is not None and sched.max_in_degree > 0:
        slots = max(sched.max_in_degree, 1)
        g = _coll.neighbor_allgather(payload[:, None], sched)
        g = g.reshape(rows, slots, payload.shape[1])
        if t_me is not None:
            g, gt = g[..., :-1], g[..., -1]
        diffs = torch.sqrt(((g - v[:, None, :]) ** 2).sum(dim=2))
        # slot k of rank d counts iff it is real and its source is alive
        slot_alive = np.zeros((n, slots), np.float32)
        for d in range(n):
            for k, src in enumerate(sched.in_neighbors[d]):
                slot_alive[d, k] = alive[src]
        valid = torch.as_tensor(_coll._local(slot_alive > 0, rows),
                                device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        disagree = torch.where(valid, diffs, zero).amax(dim=1) * me_alive
        if t_me is not None:
            nbr_tmax = torch.where(valid, gt, zero).amax(dim=1)
    else:
        disagree = torch.zeros(rows, dtype=torch.float32, device=dev)
    return dist, disagree, t_me, nbr_tmax


def consensus_distance(params: Any,
                       schedule: Optional[CommSchedule] = None) -> np.ndarray:
    """Per-rank ``||x_i - mean(x)||`` over the float leaves of stacked
    ``params``."""
    return diagnose_consensus(params, schedule=schedule,
                              record=False)["consensus_distance"]


def window_staleness() -> Dict[str, int]:
    """Unconsumed deliveries per named window (puts / accumulates since
    the last ``win_update``): ``{window_name: max_mailbox_depth}``."""
    from .parallel import windows as _win
    out = {}
    for name, entry in _win._registry.items():
        out[name] = int(entry.version.max()) if entry.version.size else 0
    return out


def diagnose_consensus(params: Any, *,
                       schedule: Optional[CommSchedule] = None,
                       dead_ranks: Sequence[int] = (),
                       record: bool = True,
                       step_times: Optional[Sequence[float]] = None,
                       ) -> Dict[str, Any]:
    """One health sample over stacked ``params``.

    Returns the consensus distance (per-rank array + max/mean), the max
    neighbor disagreement under ``schedule`` (default: the context's
    static schedule) and the window staleness.  ``dead_ranks`` restricts
    the probe to the survivors (the network mean excludes them; they
    report distance 0).  ``record=True`` publishes the scalars as gauges
    and a ``consensus`` flight event.  ``step_times`` (an ``[n]`` per-rank
    last-step wall-time vector) rides the same neighbor gather as one
    extra element a rank and adds ``step_time_s``, ``step_time_skew_s``,
    ``neighbor_step_time_max`` and ``straggler_ranks`` (and their gauges
    when recording)."""
    ctx = _ctx.get_context()
    if schedule is None:
        try:
            schedule = ctx.static_schedule()
        except RuntimeError:
            schedule = None
    dead = tuple(sorted(set(int(r) for r in dead_ranks)))
    if dead and len(dead) >= ctx.size:
        raise ValueError(f"all {ctx.size} ranks marked dead")
    with_time = step_times is not None
    t_host = None
    if with_time:
        t_host = np.asarray(step_times, np.float32).reshape(-1)
        if t_host.size != ctx.size:
            raise ValueError(
                f"step_times has {t_host.size} entries for {ctx.size} ranks")
    with torch.no_grad():
        d_t, g_t, te_t, nb_t = _probe(params, schedule, ctx.size, dead,
                                      t_host)
    dist = _all_rows(d_t)
    disagree = _all_rows(g_t)
    alive = [r for r in range(ctx.size) if r not in dead]
    staleness = window_staleness()
    out = {
        "consensus_distance": dist,
        "consensus_distance_max": float(dist.max()),
        "consensus_distance_mean": float(dist[alive].mean()),
        "neighbor_disagreement": disagree,
        "neighbor_disagreement_max": float(disagree.max()),
        "window_staleness": staleness,
    }
    if with_time:
        global _last_step_times
        t = _all_rows(te_t).reshape(-1)
        _last_step_times = t
        stragglers = detect_stragglers(t, dead_ranks=dead)
        out["step_time_s"] = t
        out["step_time_skew_s"] = float(t[alive].max() - t[alive].min())
        out["neighbor_step_time_max"] = _all_rows(nb_t).reshape(-1)
        out["straggler_ranks"] = stragglers
    if record:
        _metrics.gauge("bluefog_consensus_distance_max",
                       "max over ranks of ||x_i - mean(x)||"
                       ).set(out["consensus_distance_max"])
        _metrics.gauge("bluefog_consensus_distance_mean",
                       "mean over ranks of ||x_i - mean(x)||"
                       ).set(out["consensus_distance_mean"])
        _metrics.gauge("bluefog_neighbor_disagreement_max",
                       "max over ranks/edges of ||x_i - x_j||"
                       ).set(out["neighbor_disagreement_max"])
        if staleness:
            _metrics.gauge("bluefog_window_staleness_max",
                           "max unconsumed mailbox deliveries"
                           ).set(max(staleness.values()))
        if with_time:
            _metrics.gauge(
                "bluefog_step_time_skew",
                "max - min of per-rank last-step wall time (s)"
                ).set(out["step_time_skew_s"])
            _metrics.gauge(
                "bluefog_straggler_rank",
                "slowest rank when it qualifies as a straggler, else -1"
                ).set(float(out["straggler_ranks"][0])
                      if out["straggler_ranks"] else -1.0)
        ev = {"max": out["consensus_distance_max"],
              "mean": out["consensus_distance_mean"],
              "disagree": out["neighbor_disagreement_max"]}
        if with_time:
            ev["step_times"] = [round(float(x), 6) for x in t]
            ev["skew_s"] = out["step_time_skew_s"]
            ev["stragglers"] = list(out["straggler_ranks"])
        _flight.record("consensus", **ev)
    return out


def observe_async_staleness(state: Any,
                            record: bool = True) -> Optional[Dict[str, Any]]:
    """Staleness-depth sample from an async-gossip training state: when
    ``state.comm_state`` is an
    :class:`bluefog_tpu_torch.optimizers.AsyncGossipState`, its per-rank
    staleness depth (how many ticks stale the oldest neighbor
    contribution was at the last tick), local step counters and pending
    forced-sync flag.  A read of the step's output: no collective.
    Publishes the ``bluefog_async_staleness_steps`` /
    ``bluefog_async_forced_sync`` gauges.  None for any other state."""
    from .optimizers import AsyncGossipState
    cs = getattr(state, "comm_state", None)
    if not isinstance(cs, AsyncGossipState):
        return None
    depth = _all_rows(cs.depth).reshape(-1)
    local = _all_rows(cs.local_steps).reshape(-1)
    forced = bool(_all_rows(cs.force).reshape(-1).any())
    out = {
        "staleness_depth": depth,
        "staleness_depth_max": int(depth.max()) if depth.size else 0,
        "local_steps": local,
        "forced_sync_pending": forced,
    }
    if record:
        _metrics.gauge(
            "bluefog_async_staleness_steps",
            "max over ranks of async-gossip staleness depth (ticks)"
            ).set(out["staleness_depth_max"])
        _metrics.gauge(
            "bluefog_async_forced_sync",
            "1 when the staleness bound forces a fleet sync-up next tick"
            ).set(1.0 if forced else 0.0)
        _flight.record(
            "async_staleness", max=out["staleness_depth_max"],
            forced=forced, local_steps=[int(x) for x in local])
    return out


# ---------------------------------------------------------------------------
# Straggler detection (per-rank step times)
# ---------------------------------------------------------------------------

_last_step_times: Optional[np.ndarray] = None


def observe_step_time(duration_s: float,
                      size: Optional[int] = None) -> Optional[np.ndarray]:
    """Fold one host-measured step wall time into the per-rank table.

    The stacked ranks share one host clock, so per-rank attribution comes
    from the chaos ledger: sleep seconds injected by rank-targeted
    ``hang`` / ``throttle`` faults are subtracted from the shared baseline
    and re-added to their target rank, so an injected straggler looks
    like a real one to the detector.  Returns the ``[n]`` table (kept for
    :func:`detect_stragglers`), or None when neither ``size`` nor an
    initialized context gives the rank count."""
    global _last_step_times
    if size is None:
        if not _ctx.is_initialized():
            return None
        size = _ctx.get_context().size
    delays = _chaos.consume_step_delays()
    base = max(float(duration_s) - sum(delays.values()), 0.0)
    t = np.full(size, base, np.float32)
    for r, d in delays.items():
        if 0 <= r < size:
            t[r] += d
    _last_step_times = t
    return t


def last_step_times() -> Optional[np.ndarray]:
    """The most recent per-rank step-time table (observe/diagnose feed it)."""
    return _last_step_times


def detect_stragglers(step_times: Optional[Sequence[float]] = None, *,
                      factor: float = 2.0, min_skew_s: float = 0.0,
                      dead_ranks: Sequence[int] = ()) -> Tuple[int, ...]:
    """Ranks whose last step took ``> factor x`` the alive-rank median
    (and at least ``min_skew_s`` over it), slowest first; ``step_times``
    when given, else the last observed table."""
    t = (np.asarray(step_times, np.float64).reshape(-1)
         if step_times is not None else _last_step_times)
    if t is None or t.size == 0:
        return ()
    t = np.asarray(t, np.float64).reshape(-1)
    dead = {int(r) for r in dead_ranks}
    alive = [r for r in range(t.size) if r not in dead]
    if not alive:
        return ()
    med = float(np.median(t[alive]))
    out = [r for r in alive
           if t[r] > factor * med and t[r] - med > min_skew_s]
    return tuple(sorted(out, key=lambda r: -t[r]))


# ---------------------------------------------------------------------------
# Non-finite guard + peer-health tracking (the detection half of the
# resilience story: resilience.py owns the response)
# ---------------------------------------------------------------------------

def check_finite(tree: Any) -> np.ndarray:
    """Per-rank all-finite flag over the float leaves of a distributed
    tree (``[rows, ...]`` tensors; the optimizer state a step returns
    included): ``out[r]`` is False iff any float element of rank r's row
    is NaN or Inf.  One reduction a leaf on the device, folded into one
    ``[rows]`` vector, and one host read (every process's rows across
    processes)."""
    leaves = [x for x in live_tensors(tree)
              if x.ndim >= 1 and x.is_floating_point()]
    if not leaves:
        n = _ctx.get_context().size if _ctx.is_initialized() else 0
        return np.ones(n, bool)
    rows = leaves[0].shape[0]
    ok = torch.ones(rows, dtype=torch.bool, device=leaves[0].device)
    with torch.no_grad():
        for x in leaves:
            if x.shape[0] != rows:
                continue
            ok &= torch.isfinite(x.reshape(rows, -1)).all(dim=1).to(
                ok.device)
    return _all_rows(ok.to(torch.uint8)).reshape(-1).astype(bool)


# Host-side peer-health table: which ranks have produced non-finite output
# (and how persistently), plus explicitly reported failures (a RankKilled
# caught by the training loop, a watchdog timeout attributed to a peer).
_peer_lock = threading.Lock()
_peer_nonfinite_streak: Dict[int, int] = {}
_peer_last_bad_step: Dict[int, int] = {}
_peer_failed: set = set()


def observe_peer_finiteness(finite: np.ndarray,
                            step: Optional[int] = None) -> None:
    """Feed one :func:`check_finite` sample into the peer-health table."""
    with _peer_lock:
        for r, ok in enumerate(np.asarray(finite)):
            if bool(ok):
                _peer_nonfinite_streak[r] = 0
            else:
                _peer_nonfinite_streak[r] = _peer_nonfinite_streak.get(r, 0) + 1
                if step is not None:
                    _peer_last_bad_step[r] = int(step)
        bad = sum(1 for v in _peer_nonfinite_streak.values() if v > 0)
    _metrics.gauge("bluefog_peers_nonfinite",
                   "ranks whose latest sampled output was non-finite"
                   ).set(bad)


def record_peer_failure(rank: int) -> None:
    """Mark a rank as failed (killed, restarted, or timed out)."""
    with _peer_lock:
        _peer_failed.add(int(rank))
    _metrics.gauge("bluefog_peers_failed",
                   "ranks explicitly reported failed").set(len(_peer_failed))


def clear_peer_failures(ranks: Optional[Iterable[int]] = None) -> None:
    """Drop peer-failure records for ``ranks`` (all of them when None):
    the explicit failure mark, the non-finite streak and the last bad
    step, so a re-admitted rank (or a ``resilience.reset()``) does not
    keep :func:`unhealthy_ranks` reporting it."""
    with _peer_lock:
        if ranks is None:
            _peer_failed.clear()
            _peer_nonfinite_streak.clear()
            _peer_last_bad_step.clear()
        else:
            for r in ranks:
                _peer_failed.discard(int(r))
                _peer_nonfinite_streak.pop(int(r), None)
                _peer_last_bad_step.pop(int(r), None)
        n_failed = len(_peer_failed)
    _metrics.gauge("bluefog_peers_failed",
                   "ranks explicitly reported failed").set(n_failed)


def unhealthy_ranks(streak: int = 1) -> Tuple[int, ...]:
    """Ranks currently considered unhealthy: explicitly failed, or with at
    least ``streak`` consecutive non-finite samples."""
    with _peer_lock:
        bad = set(_peer_failed)
        bad.update(r for r, v in _peer_nonfinite_streak.items()
                   if v >= streak)
    return tuple(sorted(bad))


def peer_health() -> Dict[str, Any]:
    """Snapshot of the peer-health table (for dashboards and tests)."""
    with _peer_lock:
        return {
            "failed": tuple(sorted(_peer_failed)),
            "nonfinite_streak": dict(_peer_nonfinite_streak),
            "last_bad_step": dict(_peer_last_bad_step),
        }


def reset_peer_health() -> None:
    with _peer_lock:
        _peer_failed.clear()
        _peer_nonfinite_streak.clear()
        _peer_last_bad_step.clear()


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
