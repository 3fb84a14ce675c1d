"""In-band fleet observability: metric aggregation gossiped over the
topology (the port's own copy of ``bluefog_tpu/utils/fleetview.py``).

Each rank keeps a ``[n, 1+m]`` f32 *fleet table*: one row per rank, each
row ``[stamp, slot_0 .. slot_{m-1}]`` holding that rank's last snapshot
of the declared metric set (:data:`DEFAULT_SPEC`, or whatever
:func:`arm` was given).  Counters snapshot each rank's *contribution*
(so the fleet value is their **sum**), gauges snapshot the rank's
current value (the fleet value is the masked **mean** plus min/max),
histograms snapshot their mergeable bucket-count vector.

On every ``metrics_every_k`` consensus probe the table rides the probe's
existing masked ``neighbor_allgather`` (``diagnostics._probe``) as extra
f32 scalars — no additional collective.  Each rank merges its own table
with its live in-neighbors' by **per-row stamp argmax**: the freshest
copy of every row wins (ties go to the local copy).  A row floods the
graph one hop per probe, so after ``diameter(G)`` probes every rank holds
every other rank's latest snapshot — the *staleness bound* the
``fleet()`` contract declares.  Stamps are probe-round numbers, not wall
clocks.  Dead ranks neither refresh nor win merges, and :meth:`FleetView.fleet`
excludes them from every aggregate.

Cost contract: disarmed, the probe path pays exactly one :func:`active`
global read; armed, one ``[n, 1+m]`` numpy snapshot plus ``n * (1+m)``
extra f32 scalars a rank on the existing gather.

torch is never imported here: tools and launcher children read
:func:`active` views for free.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import metrics as _metrics
from .config import logger

__all__ = [
    "FleetView", "DEFAULT_SPEC", "SCHEMA", "ENV_EVERY",
    "arm", "disarm", "active", "reset", "maybe_arm_from_env",
    "fleet_every", "set_rank_override", "clear_rank_overrides",
]

SCHEMA = "bluefog-fleet-1"
ENV_EVERY = "BLUEFOG_FLEET_EVERY"

# The declared metric set a bare ``arm()`` gossips — the fleet_top
# dashboard's columns.  Every entry is (registry name, kind); counters
# ride as per-rank contributions (fleet value: sum), gauges as current
# values (fleet value: mean + min/max).  Histograms are supported
# (mergeable bucket vectors) but cost ``len(buckets)+2`` slots each, so
# the default spec stays scalar.
DEFAULT_SPEC: Tuple[Tuple[str, str], ...] = (
    ("bluefog_train_steps_total", "counter"),
    ("bluefog_op_bytes_total", "counter"),
    ("bluefog_retrace_after_warmup_total", "counter"),
    ("bluefog_tripwire_total", "counter"),
    ("bluefog_step_time_ewma_s", "gauge"),
    ("bluefog_consensus_distance_max", "gauge"),
    ("bluefog_async_staleness_steps", "gauge"),
    ("bluefog_serve_queue_depth", "gauge"),
    ("bluefog_serve_p99_s", "gauge"),
    ("bluefog_slo_burn_rate", "gauge"),
    ("bluefog_serve_hot_expert_fraction", "gauge"),
)

_KINDS = ("counter", "gauge", "histogram")


def _gauge_scalar(m) -> float:
    """One float for a (possibly labeled) gauge: the unlabeled value, else
    the max over its labeled series (``bluefog_slo_burn_rate{window=,slo=}``
    wants its worst burn carried), else NaN for "never set"."""
    vals = m.dump().get("values", {})
    if not vals:
        return float("nan")
    if "" in vals:
        return float(vals[""])
    return float(max(vals.values()))


def _graph_diameter(sched, dead: frozenset) -> int:
    """Directed diameter of the live subgraph (BFS from every live node
    along src->dst edges).  Unreachable pairs degrade to ``n`` — a
    conservative bound rather than a crash on a partitioned heal."""
    n = sched.size
    live = [r for r in range(n) if r not in dead]
    if len(live) <= 1:
        return 0
    out_edges: Dict[int, List[int]] = {r: [] for r in live}
    for dst in live:
        for src in sched.in_neighbors[dst]:
            if src in out_edges:
                out_edges[int(src)].append(dst)
    worst = 0
    for s in live:
        dist = {s: 0}
        q = deque([s])
        while q:
            u = q.popleft()
            for v in out_edges[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    q.append(v)
        if len(dist) < len(live):
            return n                       # partitioned: conservative bound
        worst = max(worst, max(dist.values()))
    return worst


class FleetView:
    """One rank-set's gossiped view of the whole fleet's declared metrics.

    Constructed by :func:`arm`; the probe channel drives it through
    :meth:`pre_probe` / :meth:`post_probe`, consumers read
    :meth:`fleet` (full table + aggregates + staleness) or
    :meth:`fleet_max` (one scalar, the control loops' fast path).
    """

    def __init__(self, n: int, spec: Sequence[Tuple[str, str]] = DEFAULT_SPEC,
                 *, every: Optional[int] = None,
                 local_ranks: Optional[Sequence[int]] = None):
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
        self.n = int(n)
        self.every = None if every is None else int(every)
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.local_ranks = (tuple(range(self.n)) if local_ranks is None
                            else tuple(int(r) for r in local_ranks))
        # counters are process-global in the registry; each local rank
        # contributes an equal share so the fleet-wide sum reproduces the
        # offline metrics_report merge (single process: share = 1/n)
        self._share = float(len(self.local_ranks))
        layout: List[Tuple[str, str, int, int, Optional[tuple]]] = []
        off = 0
        for name, kind in spec:
            if kind not in _KINDS:
                raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
            buckets = None
            width = 1
            if kind == "histogram":
                m = _metrics.get_metric(name)
                buckets = (m.buckets if isinstance(m, _metrics.Histogram)
                           else _metrics.DEFAULT_BUCKETS)
                if buckets[-1] != float("inf"):
                    buckets = tuple(buckets) + (float("inf"),)
                width = len(buckets) + 2   # per-bucket counts + count + sum
            layout.append((name, kind, off, width, buckets))
            off += width
        if not layout:
            raise ValueError("fleet spec must declare at least one metric")
        self.spec = tuple((name, kind) for name, kind, *_ in layout)
        self._layout = tuple(layout)
        self.m = off
        self.row_width = 1 + self.m        # [stamp, slots...]
        self.carrier_len = self.n * self.row_width
        # tables[i] is rank i's view; stamp -1 == "row never seen"
        self._tables = np.zeros((self.n, self.n, self.row_width), np.float32)
        self._tables[:, :, 0] = -1.0
        self._round = 0
        self._dead: frozenset = frozenset()
        self._schedule = None
        self._overrides: Dict[int, Dict[str, float]] = {}
        self._probe_monos: deque = deque(maxlen=16)
        self._lock = threading.Lock()

    # -- snapshot side (pre-gossip) ------------------------------------

    def _snapshot_slots(self, rank: int) -> np.ndarray:
        """Rank ``rank``'s fresh ``[m]`` contribution vector."""
        out = np.empty(self.m, np.float32)
        ovr = self._overrides.get(rank, {})
        for name, kind, off, width, buckets in self._layout:
            if name in ovr:
                out[off] = ovr[name]
                if width > 1:
                    out[off + 1:off + width] = 0.0
                continue
            m = _metrics.get_metric(name)
            if kind == "counter":
                out[off] = (m.total() / self._share
                            if isinstance(m, _metrics.Counter) else 0.0)
            elif kind == "gauge":
                out[off] = (_gauge_scalar(m)
                            if isinstance(m, _metrics.Gauge)
                            else float("nan"))
            else:
                if isinstance(m, _metrics.Histogram) \
                        and tuple(m.buckets) == buckets:
                    d = m.dump()
                    counts = [c for _, c in d["buckets"]]
                    out[off:off + width - 2] = \
                        np.asarray(counts, np.float32) / self._share
                    out[off + width - 2] = d["count"] / self._share
                    out[off + width - 1] = d["sum"] / self._share
                else:
                    out[off:off + width] = 0.0
        return out

    def pre_probe(self, dead: Sequence[int] = ()) -> np.ndarray:
        """Advance one gossip round: stamp + refresh every live local
        rank's own row, return the flattened ``[n, carrier_len]`` carrier
        (each rank's full table) for the probe collective."""
        deadset = {int(d) for d in dead}
        with self._lock:
            self._round += 1
            self._probe_monos.append(time.monotonic())
            for r in self.local_ranks:
                if r in deadset:
                    continue
                self._tables[r, r, 0] = float(self._round)
                self._tables[r, r, 1:] = self._snapshot_slots(r)
            return self._tables.reshape(self.n, self.carrier_len).copy()

    def post_probe(self, merged: np.ndarray, *, dead: Sequence[int] = (),
                   schedule=None) -> None:
        """Store the probe's merged carrier back and re-export the
        ``bluefog_fleet_*`` gauges from this host's view."""
        merged = np.asarray(merged, np.float32).reshape(
            self.n, self.n, self.row_width)
        with self._lock:
            self._tables = merged.copy()
            self._dead = frozenset(int(d) for d in dead)
            if schedule is not None:
                self._schedule = schedule
        self._publish()

    # -- read side ------------------------------------------------------

    def _cadence_s(self) -> Optional[float]:
        pts = list(self._probe_monos)
        if len(pts) < 2:
            return None
        return (pts[-1] - pts[0]) / (len(pts) - 1)

    def staleness_bound_rounds(self) -> Optional[int]:
        """The declared contract: every live row is at most
        ``diameter(live subgraph)`` probe rounds old once the table has
        flooded (None before a schedule was seen)."""
        sched = self._schedule
        if sched is None:
            return None
        return _graph_diameter(sched, self._dead)

    def fleet(self, rank: Optional[int] = None) -> Dict[str, Any]:
        """Rank ``rank``'s (default: first local rank's) view of the whole
        fleet: per-metric global value + per-rank table + staleness ages.

        All values are JSON-clean (NaN/inf -> None)."""
        if rank is None:
            rank = self.local_ranks[0]
        with self._lock:
            table = self._tables[int(rank)].copy()
            rnd = self._round
            dead = self._dead
        live = [r for r in range(self.n) if r not in dead]
        stamps = table[:, 0]
        seen = stamps >= 0.0
        ages = [int(rnd - stamps[r]) if seen[r] else None
                for r in range(self.n)]
        live_seen = [r for r in live if seen[r]]
        metrics: Dict[str, Any] = {}
        for name, kind, off, width, buckets in self._layout:
            col = 1 + off
            if kind == "histogram":
                counts = table[live_seen, col:col + width - 2].sum(axis=0)
                metrics[name] = {
                    "kind": kind,
                    "count": float(table[live_seen, col + width - 2].sum()),
                    "sum": float(table[live_seen, col + width - 1].sum()),
                    "buckets": [[b if b != float("inf") else "+Inf",
                                 float(c)]
                                for b, c in zip(buckets, counts)],
                }
                continue
            per = {r: (None if math.isnan(float(table[r, col]))
                       else float(table[r, col]))
                   for r in live_seen}
            vals = [v for v in per.values() if v is not None]
            if kind == "counter":
                glob = float(np.sum(np.asarray(vals, np.float64))) \
                    if vals else None
                metrics[name] = {"kind": kind, "global": glob,
                                 "per_rank": per}
            else:
                metrics[name] = {
                    "kind": kind,
                    "global": sum(vals) / len(vals) if vals else None,
                    "min": min(vals) if vals else None,
                    "max": max(vals) if vals else None,
                    "per_rank": per,
                }
        bound = self.staleness_bound_rounds()
        cadence = self._cadence_s()
        live_ages = [a for r, a in enumerate(ages) if r in live_seen]
        max_age = max(live_ages) if live_ages else None
        return {
            "schema": SCHEMA,
            "rank": int(rank),
            "n": self.n,
            "round": rnd,
            "live_ranks": live,
            "dead_ranks": sorted(dead),
            "seen_ranks": live_seen,
            "staleness": {
                "rounds_per_rank": ages,
                "rounds_max": max_age,
                "bound_rounds": bound,
                "probe_cadence_s": cadence,
                "age_s_est": (None if max_age is None or cadence is None
                              else max_age * cadence),
            },
            "metrics": metrics,
        }

    def fleet_max(self, name: str,
                  rank: Optional[int] = None
                  ) -> Tuple[Optional[float], Optional[int]]:
        """``(max value, argmax rank)`` of one declared scalar metric over
        the live, seen rows — the control loops' O(n) fast path.
        ``(None, None)`` when nothing has flooded yet or ``name`` is not
        in the spec."""
        entry = next((e for e in self._layout if e[0] == name), None)
        if entry is None or entry[1] == "histogram":
            return None, None
        col = 1 + entry[2]
        if rank is None:
            rank = self.local_ranks[0]
        with self._lock:
            table = self._tables[int(rank)]
            dead = self._dead
            vals = [(float(table[r, col]), r) for r in range(self.n)
                    if r not in dead and table[r, 0] >= 0.0
                    and not math.isnan(float(table[r, col]))]
        if not vals:
            return None, None
        best = max(vals)
        return best[0], best[1]

    # -- export side ----------------------------------------------------

    def _publish(self) -> None:
        """Re-export the fleet aggregates as ``bluefog_fleet_*`` gauges
        (bounded cardinality: one gauge per declared scalar metric plus
        the staleness/membership pair; the per-rank table is /fleet's)."""
        f = self.fleet()
        for name, doc in f["metrics"].items():
            if doc["kind"] == "histogram" or doc.get("global") is None:
                continue
            suffix = name[len("bluefog_"):] if name.startswith("bluefog_") \
                else name
            _metrics.gauge(
                f"bluefog_fleet_{suffix}",
                f"fleet-wide {doc['kind']} aggregate of {name} "
                "(gossiped over the topology)").set(doc["global"])
        st = f["staleness"]
        if st["rounds_max"] is not None:
            _metrics.gauge(
                "bluefog_fleet_staleness_rounds_max",
                "oldest live row in this rank's fleet table, in probe "
                "rounds").set(float(st["rounds_max"]))
        _metrics.gauge(
            "bluefog_fleet_live_ranks",
            "live ranks in the gossiped fleet view").set(
                float(len(f["live_ranks"])))

    # -- test / injection hooks -----------------------------------------

    def set_rank_override(self, rank: int, name: str, value: float) -> None:
        """Pin rank ``rank``'s next snapshots of ``name`` to ``value``
        (the per-rank attribution hook: chaos drills inject a breach on a
        specific rank; single-process estates give ranks distinct
        step-time/queue signals)."""
        self._overrides.setdefault(int(rank), {})[name] = float(value)

    def clear_rank_overrides(self, rank: Optional[int] = None) -> None:
        if rank is None:
            self._overrides.clear()
        else:
            self._overrides.pop(int(rank), None)


# ---------------------------------------------------------------------------
# Module-level arming (the diagnostics probe reads `active()` — one global
# load on the disarmed path, same contract as flight/tracing)
# ---------------------------------------------------------------------------

_active: Optional[FleetView] = None


def active() -> Optional[FleetView]:
    """The armed view, or None — THE disarmed hot-path check."""
    return _active


def arm(spec: Sequence[Tuple[str, str]] = DEFAULT_SPEC, *,
        n: Optional[int] = None, every: Optional[int] = None,
        local_ranks: Optional[Sequence[int]] = None) -> FleetView:
    """Arm fleet gossip for an ``n``-rank fleet (default: the initialized
    context's size).  Subsequent consensus probes carry the table;
    re-arming replaces the view (fresh tables, round 0)."""
    global _active
    if n is None:
        from ..parallel import context as _ctx
        c = _ctx.get_context()
        n = c.size
        if local_ranks is None and c.world > 1:
            local_ranks = range(c.first_rank, c.first_rank + c.rows)
    fv = FleetView(int(n), spec, every=every, local_ranks=local_ranks)
    _active = fv
    logger.info("fleet view armed: n=%d, %d metrics, carrier %d f32%s",
                fv.n, len(fv.spec), fv.carrier_len,
                f", every={fv.every}" if fv.every else "")
    return fv


def disarm() -> None:
    global _active
    _active = None


def reset() -> None:
    """Test isolation: drop the armed view and any overrides."""
    disarm()


def maybe_arm_from_env(n: int, local_ranks: Optional[Sequence[int]] = None
                       ) -> Optional[FleetView]:
    """Honor ``BLUEFOG_FLEET_EVERY`` at init (the fleet analogue of
    metrics' ``BLUEFOG_METRICS_PORT`` hook): a positive integer arms the
    default spec and doubles as the default probe cadence for train steps
    built without an explicit ``metrics_every_k``.  ``local_ranks``: the
    ranks this process holds (default: all of them)."""
    import os
    raw = os.environ.get(ENV_EVERY)
    if not raw:
        return None
    try:
        every = int(raw)
        if every < 1:
            raise ValueError
    except ValueError:
        logger.warning("%s=%r must be a positive integer; fleet view "
                       "stays disarmed", ENV_EVERY, raw)
        return None
    return arm(n=n, every=every, local_ranks=local_ranks)


def fleet_every() -> Optional[int]:
    """The armed view's declared probe cadence (None when disarmed or
    armed without one)."""
    fv = _active
    return fv.every if fv is not None else None


def set_rank_override(rank: int, name: str, value: float) -> None:
    """Module-level convenience for :meth:`FleetView.set_rank_override`."""
    fv = _active
    if fv is None:
        raise RuntimeError("fleet view is not armed")
    fv.set_rank_override(rank, name, value)


def clear_rank_overrides(rank: Optional[int] = None) -> None:
    fv = _active
    if fv is not None:
        fv.clear_rank_overrides(rank)
