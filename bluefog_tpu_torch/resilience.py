"""Topology healing, elastic membership, and skip-and-rollback (the
port's own copy of ``bluefog_tpu/resilience.py``).

The reference runtime has no answer to a dead peer: a rank that stops
responding wedges every neighbor collective that names it (the timeline
just shows the survivors parked in ``MPI_NEIGHBOR_ALLREDUCE`` forever),
and a NaN-ed tensor propagates through the mixing matrix to every rank
within a graph diameter of steps.  Elastic-Horovod-style recovery — drop
the dead worker, rebuild the communicator, continue — is the behavior this
module ports to the compiled-schedule world, in *both* directions:

* **Healing** (:func:`heal_schedule` / :func:`heal_topology` /
  :func:`mark_rank_dead`): rebuild the weight tables with the dead ranks
  excluded.  Every edge out of a dead rank is removed and its mixing mass
  is folded into the *receiver's* self weight, so each surviving column of
  W still sums to 1 — the healed matrix remains column-stochastic and the
  survivors keep contracting toward *their* average.  Dead ranks become
  isolated self-loops (weight 1): their rows stay in the stacked tensors
  (the rank count is fixed at ``init``) but neither send nor receive
  mass.
* **Elastic membership** (:func:`admit_rank` / :func:`retire_rank` /
  :func:`join_rank` / :func:`advance_membership`): the inverse surgery.
  Admission regenerates the schedules from the pristine full-membership
  baseline, moving the self-loop mass their neighbors accumulated back
  onto the restored in-edges; a joining rank bootstraps its parameters by
  a one-shot weighted gossip pull from ≥2 live in-neighbors
  (:func:`bootstrap_params`) and can enter the mixing matrix at reduced
  weight that ramps to nominal over ``warmup_steps``.  Retirement runs
  announce → drain-one-round → unit-self-loop so the leaver's state is
  pushed to its neighbors before the edges close.
* **Recovery** (:func:`guard_step` / :class:`GuardedStep`): wrap the train
  step with a sampled non-finite guard over its *outputs* and a host-side
  ring buffer of last-known-good snapshots; a non-finite step is skipped
  and a good state restored instead of poisoning the gossip.  Repeated
  failures walk backward through the ring, one snapshot per rollback.

Every membership change (heal, admit, retire) recompiles the schedule
tables.  JAX also calls ``mark_steady_state(False)`` there, a note to its
retrace sentinel (a changed schedule is a new XLA program); the port
compiles no programs and has no sentinel, so that note does not apply.

* **Mesh regrowth** (:func:`regrow_world` / :func:`commit_regrow`):
  re-form the world at a new rank count over the context's ``reinit``,
  carry the survivors' rows through host memory and pull the joiners'
  from their neighbors, each phase under a deadline with bounded
  retries; a failed phase rolls back to the retained old world
  (:class:`RegrowAborted`).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, \
    Sequence, Tuple

import numpy as np
import networkx as nx

import torch

from . import diagnostics as _diag
from . import topology as topo_util
from .parallel import context as _mesh
from .schedule import CommSchedule, compile_from_weights
from .utils import chaos as _chaos
from .utils import flight as _flight
from .utils import metrics as _metrics
from .utils.config import logger
from .utils.snapshot import (live_tensors, map_tensors, restore_into,
                             snapshot, snapshot_tensors, unfold)

__all__ = [
    "heal_topology", "heal_schedule", "heal_dynamic_schedules",
    "membership_schedule", "schedule_weight_matrix",
    "mark_rank_dead", "admit_rank", "retire_rank", "advance_membership",
    "bootstrap_params", "join_rank", "chaos_join",
    "dead_ranks", "retired_ranks", "live_ranks", "reset",
    "GuardedStep", "guard_step",
    "RegrowAborted", "RegrowHandle", "regrow_world", "commit_regrow",
    "regrow_pending", "regrow_join", "REGROW_PHASES",
]

_DEAD_HELP = "ranks currently marked dead and healed around"
_LIVE_HELP = "ranks currently participating in the gossip"
_MEMBERSHIP_HELP = "membership transitions applied (dead / join / retire)"


def _normalize_dead(dead: Iterable[int], size: int) -> Tuple[int, ...]:
    out = tuple(sorted(set(int(r) for r in dead)))
    for r in out:
        if not (0 <= r < size):
            raise ValueError(f"dead rank {r} out of range for size {size}")
    if len(out) >= size:
        raise ValueError(f"cannot mark all {size} ranks dead")
    return out


def schedule_weight_matrix(sched: CommSchedule) -> np.ndarray:
    """Dense ``W[src, dst]`` equivalent of a compiled schedule's tables."""
    n = sched.size
    W = np.zeros((n, n), dtype=np.float64)
    for dst in range(n):
        W[dst, dst] = float(sched.self_weight[dst])
        for slot, src in enumerate(sched.in_neighbors[dst]):
            W[src, dst] = float(sched.slot_weight[slot, dst])
    return W


def heal_topology(topo: nx.DiGraph, dead: Iterable[int]) -> nx.DiGraph:
    """Healed copy of a *weighted* topology with ``dead`` ranks excluded.

    For each surviving destination the mass of its dead in-edges moves into
    its self-loop (column sums are preserved); dead ranks keep only a
    unit self-loop.  Note this operates on the graph's mixing weights — for
    a topology used unweighted (uniform ``1/(in_degree+1)`` averaging),
    heal the compiled schedule instead (:func:`heal_schedule`), which sees
    the weights actually in effect.
    """
    W = topo_util.to_weight_matrix(topo).astype(np.float64)
    n = W.shape[0]
    dead = _normalize_dead(dead, n)
    for dst in range(n):
        if dst in dead:
            continue
        W[dst, dst] += sum(W[d, dst] for d in dead)
    for d in dead:
        W[d, :] = 0.0
        W[:, d] = 0.0
        W[d, d] = 1.0
    return topo_util._graph_from_matrix(W)


_warned_send_scales = False


def _warn_dropped_send_scales(sched: CommSchedule) -> None:
    """One-time warning when healing drops dst-weighting (send scales)."""
    global _warned_send_scales
    if _warned_send_scales or not sched.uses_dst_weighting:
        return
    affected = sorted({
        int(src)
        for r, round_edges in enumerate(sched.rounds)
        for (src, _dst) in round_edges
        if abs(float(sched.send_scale[r, src]) - 1.0) > 1e-12})
    if not affected:
        return
    _warned_send_scales = True
    logger.warning(
        "healing drops dst-weighting: send scales on ranks %s are "
        "discarded — push-sum style mass splitting is not preserved "
        "across a membership change (this is reported once)", affected)


def membership_schedule(sched: CommSchedule, *,
                        inactive: Iterable[int] = (),
                        draining: Iterable[int] = (),
                        entry_scale: Optional[Mapping[int, float]] = None,
                        ) -> CommSchedule:
    """Recompile a schedule for a membership state.

    Pure function over a (pristine) schedule — the live registry's
    :func:`admit_rank` / :func:`retire_rank` regenerate the context's
    schedules through here rather than un-healing incrementally, which is
    equivalent because healing composes (heal(heal(W, a), b) == heal(W,
    a|b)) and keeps admission exact: restored in-edges get back *exactly*
    the weight the pristine matrix gave them.

    ``inactive`` ranks (dead or fully retired) are carved out both ways:
    no in-edges, no out-edges, unit self-loop, with their out-edge mass
    folded into each receiver's self weight.  ``draining`` ranks stop
    *receiving* (unit self-loop column) but their out-edges survive, so
    the state they hold is pushed to their neighbors for one more round
    before :func:`advance_membership` finalizes the retirement.
    ``entry_scale`` maps a warming-up rank to ``alpha in (0, 1]``: its
    out-edges carry ``alpha * w`` with the remaining ``(1 - alpha) * w``
    folded into the receiver's self weight.  Every column of the result
    sums to 1 by construction (:func:`schedule.columns_stochastic`).
    """
    n = sched.size
    inactive_set = set(int(r) for r in inactive)
    draining_set = set(int(r) for r in draining) - inactive_set
    scale = {int(r): float(a) for r, a in (entry_scale or {}).items()}
    for r in list(inactive_set | draining_set) + list(scale):
        if not (0 <= r < n):
            raise ValueError(f"rank {r} out of range for size {n}")
    for r, a in scale.items():
        if not (0.0 < a <= 1.0):
            raise ValueError(f"entry scale for rank {r} must be in (0, 1], "
                             f"got {a}")
    if len(inactive_set) >= n:
        raise ValueError(f"cannot mark all {n} ranks dead")
    _warn_dropped_send_scales(sched)

    self_w: List[float] = [float(w) for w in sched.self_weight]
    src_w: List[Dict[int, float]] = []
    for dst in range(n):
        table: Dict[int, float] = {}
        if dst in inactive_set or dst in draining_set:
            # stops receiving; a draining dst keeps sending (handled below
            # from the receivers' side), an inactive one does not
            src_w.append(table)
            self_w[dst] = 1.0
            continue
        for slot, src in enumerate(sched.in_neighbors[dst]):
            w = float(sched.slot_weight[slot, dst])
            if src in inactive_set:
                self_w[dst] += w      # fold dead mass into the self-loop
            elif src in scale:
                alpha = scale[src]
                table[src] = w * alpha
                self_w[dst] += w * (1.0 - alpha)
            else:
                table[src] = w
        src_w.append(table)
    return compile_from_weights(n, self_w, src_w)


def heal_schedule(sched: CommSchedule, dead: Iterable[int]) -> CommSchedule:
    """Recompile a schedule with ``dead`` ranks carved out.

    Reconstructs the per-rank ``{src: weight}`` tables from the schedule's
    slot layout, drops every edge touching a dead rank (folding dead-source
    mass into the receiver's self weight), and runs the result back through
    :func:`bluefog_tpu_torch.schedule.compile_from_weights`.  Any dst-weighting
    (send scales) is intentionally dropped — push-sum style mass splitting
    is not meaningful once the recipient set changed — and reported by a
    one-time warning naming the affected sender ranks.
    """
    dead = _normalize_dead(dead, sched.size)
    return membership_schedule(sched, inactive=dead)


def heal_dynamic_schedules(schedules: Sequence[CommSchedule],
                           dead: Iterable[int]) -> List[CommSchedule]:
    """Heal every schedule of a dynamic (periodic) topology."""
    dead = tuple(dead)
    return [heal_schedule(s, dead) for s in schedules]


# ---------------------------------------------------------------------------
# Process-level membership registry: mark_rank_dead is the entry point the
# training loop calls when it catches a RankKilled / watchdog timeout /
# persistent non-finite peer; admit_rank / retire_rank are the elastic
# inverse.  All surgery regenerates the context's schedules from a pristine
# full-membership baseline captured the first time a membership op touches
# an installed topology.
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_dead: set = set()
_retired: set = set()
_draining: set = set()
_warmup: Dict[int, List[int]] = {}       # rank -> [num, den]; alpha = num/den
# {"sched", "dyn", "installed_key", "installed_dyn_keys"} — see
# _refresh_pristine
_pristine: Optional[Dict[str, Any]] = None


def dead_ranks() -> Tuple[int, ...]:
    with _lock:
        return tuple(sorted(_dead))


def retired_ranks() -> Tuple[int, ...]:
    """Ranks retired or currently draining toward retirement."""
    with _lock:
        return tuple(sorted(_retired | _draining))


def live_ranks() -> Tuple[int, ...]:
    """Ranks currently participating in the gossip (draining counts: a
    draining rank still sends for one more round)."""
    ctx = _mesh.get_context()
    with _lock:
        gone = _dead | _retired
    return tuple(r for r in range(ctx.size) if r not in gone)


def _refresh_pristine(ctx) -> None:
    """Adopt the context's *current* schedules as the full-membership
    baseline unless they are schedules this module itself installed.

    Admission restores edges from this baseline; a topology the user
    replaces after surgery becomes the new baseline automatically (its
    content key matches neither the pristine nor the last-installed one).
    """
    global _pristine
    if ctx.topology is None:
        return
    cur = ctx.static_schedule()
    p = _pristine
    if p is None or cur.key not in (p["installed_key"], p["sched"].key):
        _pristine = p = {"sched": cur, "dyn": None,
                         "installed_key": None, "installed_dyn_keys": None}
    dyn = list(ctx.dynamic_schedules) if ctx.dynamic_schedules else None
    if dyn is not None:
        keys = tuple(s.key for s in dyn)
        known = (p["installed_dyn_keys"],
                 tuple(s.key for s in p["dyn"]) if p["dyn"] else None)
        if keys not in known:
            p["dyn"] = dyn
            p["installed_dyn_keys"] = None
    elif p["installed_dyn_keys"] is not None:
        # the user cleared the dynamic topology since our last install
        p["dyn"] = None
        p["installed_dyn_keys"] = None


def _membership_state() -> Tuple[frozenset, frozenset, Dict[int, float]]:
    with _lock:
        inactive = frozenset(_dead | _retired)
        draining = frozenset(_draining) - inactive
        scale = {r: num / den for r, (num, den) in _warmup.items()
                 if r not in inactive}
    return inactive, draining, scale


def _update_membership_gauges(size: int) -> None:
    with _lock:
        n_dead = len(_dead)
        n_gone = len(_dead | _retired)
    _metrics.gauge("bluefog_dead_ranks", _DEAD_HELP).set(n_dead)
    _metrics.gauge("bluefog_live_ranks", _LIVE_HELP).set(size - n_gone)


def _count_membership(change: str, n: int = 1) -> None:
    c = _metrics.counter("bluefog_membership_changes_total", _MEMBERSHIP_HELP)
    for _ in range(n):
        c.inc(change=change)


def _fault_span(label: str) -> None:
    from .utils import timeline as _tl
    _tl.record_span(label, "FAULT", _tl._now_us(), 1.0)


def _apply_membership(ctx) -> None:
    """Regenerate the context's static + dynamic schedules from the
    pristine baseline for the current membership state."""
    p = _pristine
    if p is not None:
        inactive, draining, scale = _membership_state()
        healed = membership_schedule(p["sched"], inactive=inactive,
                                     draining=draining, entry_scale=scale)
        # graph view kept consistent with the regenerated tables so
        # in_neighbor_ranks()/load_topology() reflect the surgery
        ctx.topology = topo_util._graph_from_matrix(
            schedule_weight_matrix(healed))
        ctx.topology_weighted = True
        ctx._sched = healed
        p["installed_key"] = healed.key
        if p["dyn"]:
            dyn = [membership_schedule(s, inactive=inactive,
                                       draining=draining, entry_scale=scale)
                   for s in p["dyn"]]
            ctx.dynamic_schedules = dyn
            p["installed_dyn_keys"] = tuple(s.key for s in dyn)
    _update_membership_gauges(ctx.size)


def mark_rank_dead(*ranks: int) -> Tuple[int, ...]:
    """Declare ranks dead and heal the live context around them.

    Recompiles the context's static schedule (and any dynamic schedule
    list) with the dead ranks excluded, updates the context topology to the
    healed graph and feeds the peer-health table.  Returns the full set of
    dead ranks.  Idempotent.
    """
    ctx = _mesh.get_context()
    _refresh_pristine(ctx)
    with _lock:
        new = set(int(r) for r in ranks) - _dead
        merged = _normalize_dead(_dead | new, ctx.size)
        if len(set(merged) | _retired | _draining) >= ctx.size:
            raise ValueError(
                f"cannot mark all {ctx.size} ranks dead or retired")
        if not new:
            return merged
        _dead.update(new)
        for r in new:                 # a warming or draining rank can die
            _warmup.pop(r, None)
            _draining.discard(r)
    for r in sorted(new):
        _diag.record_peer_failure(r)
    _apply_membership(ctx)
    _count_membership("dead", len(new))
    _flight.record("heal", name="mark_rank_dead",
                   new=sorted(new), dead=list(merged))
    _fault_span(f"resilience:heal:{','.join(map(str, sorted(new)))}")
    return merged


def admit_rank(*ranks: int, warmup_steps: int = 0) -> Tuple[int, ...]:
    """Re-admit ranks into the gossip — the inverse of :func:`mark_rank_dead`.

    Regenerates the context's static + dynamic schedules from the pristine
    full-membership baseline with the admitted ranks' edges restored: the
    self-loop mass their neighbors accumulated while healed moves back onto
    the restored in-edges, so every column of W stays stochastic.  With
    ``warmup_steps > 0`` the admitted ranks enter at reduced out-edge
    weight ``1 / (warmup_steps + 1)`` that ramps to nominal on each
    :func:`advance_membership` tick, keeping consensus contraction smooth
    while the newcomer's freshly-bootstrapped state settles.  Peer-health
    failure records for the admitted ranks are cleared.  Returns the live
    ranks.  Idempotent for already-live ranks.
    """
    if warmup_steps < 0:
        raise ValueError("warmup_steps must be >= 0")
    ctx = _mesh.get_context()
    _refresh_pristine(ctx)
    with _lock:
        req = set(int(r) for r in ranks)
        for r in req:
            if not (0 <= r < ctx.size):
                raise ValueError(
                    f"rank {r} out of range for size {ctx.size}")
        joined = req & (_dead | _retired | _draining)
        _dead.difference_update(req)
        _retired.difference_update(req)
        _draining.difference_update(req)
        for r in joined:
            if warmup_steps:
                _warmup[r] = [1, warmup_steps + 1]
            else:
                _warmup.pop(r, None)
    live = live_ranks()
    if not joined:
        return live
    _diag.clear_peer_failures(sorted(joined))
    _apply_membership(ctx)
    _count_membership("join", len(joined))
    _flight.record("join", name="admit_rank", new=sorted(joined),
                   live=list(live), warmup_steps=int(warmup_steps))
    _fault_span(f"resilience:join:{','.join(map(str, sorted(joined)))}")
    return live


def retire_rank(*ranks: int, drain: bool = True) -> Tuple[int, ...]:
    """Gracefully remove ranks from the gossip.

    With ``drain=True`` (the announce → drain → leave protocol) a retiring
    rank first enters a *draining* round: its column becomes a unit
    self-loop (it stops receiving) but its out-edges survive, so the state
    it holds is pushed to its neighbors for one more mixing round rather
    than lost.  The next :func:`advance_membership` call finalizes the
    retirement — unit self-loop both ways, exactly like a healed-around
    dead rank but intentional (no peer-failure record).  ``drain=False``
    (or a rank that is already dead) retires immediately.  Returns all
    retired-or-draining ranks.  Idempotent.
    """
    ctx = _mesh.get_context()
    _refresh_pristine(ctx)
    with _lock:
        req = set(int(r) for r in ranks)
        for r in req:
            if not (0 <= r < ctx.size):
                raise ValueError(
                    f"rank {r} out of range for size {ctx.size}")
        new = req - _retired - _draining
        if not new:
            return tuple(sorted(_retired | _draining))
        if len(_dead | _retired | _draining | new) >= ctx.size:
            raise ValueError(
                f"cannot retire the last live rank of {ctx.size}")
        already_dead = new & _dead
        _dead.difference_update(already_dead)
        for r in new:
            _warmup.pop(r, None)
        if drain:
            _retired.update(already_dead)
            _draining.update(new - already_dead)
        else:
            _retired.update(new)
        out = tuple(sorted(_retired | _draining))
    _apply_membership(ctx)
    _count_membership("retire", len(new))
    _flight.record("retire", name="announce" if drain else "leave",
                   ranks=sorted(new), drain=bool(drain))
    _fault_span(f"resilience:retire:{','.join(map(str, sorted(new)))}")
    return out


def advance_membership() -> Dict[str, Any]:
    """One membership tick — call once per train step while a transition
    is in flight.

    Finalizes draining retirements (their one drain round has run) and
    advances admission warmup ramps toward nominal weight; recompiles the
    context's schedules only when something actually moved, so calling it
    every step in steady state is free.  Returns ``{"changed", "retired",
    "warming"}`` — ``warming`` maps still-ramping ranks to their current
    entry weight fraction.
    """
    ctx = _mesh.get_context()
    with _lock:
        finalized = tuple(sorted(_draining))
        _retired.update(_draining)
        _draining.clear()
        advanced = False
        for r, ramp in list(_warmup.items()):
            ramp[0] += 1
            advanced = True
            if ramp[0] >= ramp[1]:
                del _warmup[r]
        warming = {r: num / den for r, (num, den) in _warmup.items()}
        changed = bool(finalized) or advanced
    if changed:
        _apply_membership(ctx)
        if finalized:
            _flight.record("retire", name="drained", ranks=list(finalized))
    return {"changed": changed, "retired": finalized, "warming": warming}


def bootstrap_params(params: Any, rank: int, *, min_neighbors: int = 2,
                     donors: Optional[Iterable[int]] = None) -> Any:
    """Seed a joining rank's shard by a one-shot weighted gossip pull.

    Averages the current parameters of ``rank``'s live in-neighbors (its
    in-edges in the pristine topology, minus dead/retired/draining ranks)
    into ``rank``'s row of every float distributed leaf; all other rows
    pass through untouched (every other rank's pull column is an identity
    self-loop); the pull is the op API's ``neighbor_allreduce``.  No checkpoint round-trip: the donors' *live* state is the
    bootstrap.  At least ``min_neighbors`` donors are required so one
    straggling peer can't seed the newcomer with a stale epoch alone.
    Returns the pulled tree; call before :func:`admit_rank` so the
    newcomer holds a sane shard by the time its out-edges open.
    """
    ctx = _mesh.get_context()
    _refresh_pristine(ctx)
    if _pristine is None:
        raise RuntimeError(
            "no topology installed; cannot derive bootstrap donors")
    rank = int(rank)
    n = ctx.size
    if not (0 <= rank < n):
        raise ValueError(f"rank {rank} out of range for size {n}")
    with _lock:
        unavailable = _dead | _retired | _draining
    if donors is None:
        donor_list = [int(s) for s in _pristine["sched"].in_neighbors[rank]
                      if s not in unavailable and int(s) != rank]
    else:
        donor_list = sorted(set(int(d) for d in donors))
        bad = [d for d in donor_list
               if d in unavailable or d == rank or not (0 <= d < n)]
        if bad:
            raise ValueError(f"donors {bad} are not live peers of {rank}")
    if len(donor_list) < min_neighbors:
        raise RuntimeError(
            f"rank {rank} has {len(donor_list)} live in-neighbor(s) "
            f"({sorted(donor_list)}) but bootstrap requires >= "
            f"{min_neighbors} so one straggling peer cannot seed it alone")

    # one-shot pull schedule: identity everywhere except the joiner's
    # column, which averages its donors (column-stochastic by construction)
    w = 1.0 / len(donor_list)
    self_w = [1.0] * n
    self_w[rank] = 0.0
    src_w: List[Dict[int, float]] = [{} for _ in range(n)]
    src_w[rank] = {d: w for d in donor_list}
    pull = compile_from_weights(n, self_w, src_w)

    from . import api as _api
    from .fusion import tree_map

    def pull_leaf(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
                and leaf.shape[0] == ctx.rows
                and leaf.is_floating_point()):
            return _api.neighbor_allreduce(leaf, schedule=pull)
        return leaf

    out = tree_map(pull_leaf, params)
    _flight.record("join", name="bootstrap", rank=rank,
                   donors=list(donor_list))
    return out


def join_rank(rank: int, params: Any = None, *, warmup_steps: int = 0,
              min_neighbors: int = 2) -> Any:
    """Full join protocol: neighbor-pull bootstrap, then admission.

    Convenience composition of :func:`bootstrap_params` (when ``params``
    is given) and :func:`admit_rank` — the bootstrap pull runs *before*
    the rank's out-edges open, so no peer ever mixes in the pre-bootstrap
    garbage shard.  Returns the (possibly pulled) params tree.
    """
    if params is not None:
        params = bootstrap_params(params, rank, min_neighbors=min_neighbors)
    admit_rank(rank, warmup_steps=warmup_steps)
    return params


def chaos_join(out: Any, rank: int, *, warmup_steps: int = 0,
               min_neighbors: int = 2) -> Any:
    """Chaos-plan hook: enact a seeded ``join`` fault on a step's outputs.

    No-op for a rank that is already live; otherwise runs the real join
    protocol (:func:`join_rank`) against the train-step output tree so
    membership churn injected by ``BLUEFOG_CHAOS`` exercises exactly the
    production path.  The port's step output holds live tensors the step
    updates in place (params, optimizer state, loss): every floating
    ``[rows, ...]`` tensor among them is pulled, as JAX's pull maps over
    the whole output tree, and written back in place.
    """
    rank = int(rank)
    with _lock:
        already_live = (rank not in _dead and rank not in _retired
                        and rank not in _draining)
    if already_live:
        return out
    rows = _mesh.get_context().rows
    live = [t for t in live_tensors(out)
            if t.ndim >= 1 and t.shape[0] == rows and t.is_floating_point()]
    pulled = join_rank(rank, live, warmup_steps=warmup_steps,
                       min_neighbors=min_neighbors)
    with torch.no_grad():
        for a, b in zip(live, pulled):
            if a is not b:
                a.copy_(b)
    return out


def reset() -> None:
    """Forget all membership state — dead, retired, draining, and warmup —
    and the pristine baseline (does not un-heal an already-healed context;
    call ``set_topology`` to reinstall a full topology).  Peer-failure
    records this module created via :func:`mark_rank_dead` are cleared
    too, so ``diagnostics.unhealthy_ranks()`` does not stay poisoned
    across a reset."""
    global _pristine, _warned_send_scales, _regrow_pending
    with _lock:
        forgotten = tuple(sorted(_dead))
        _dead.clear()
        _retired.clear()
        _draining.clear()
        _warmup.clear()
        _pristine = None
        _warned_send_scales = False
        _regrow_pending = None
        _regrow_status.clear()
    if forgotten:
        _diag.clear_peer_failures(forgotten)
    _metrics.gauge("bluefog_dead_ranks", _DEAD_HELP).set(0)
    if _mesh.is_initialized():
        _metrics.gauge("bluefog_live_ranks", _LIVE_HELP).set(
            _mesh.get_context().size)


# ---------------------------------------------------------------------------
# Skip-and-rollback guard
# ---------------------------------------------------------------------------

class GuardedStep:
    """Wrap a train step with a non-finite guard and a last-good ring buffer.

    Every ``check_every_k``-th call the step's *outputs* go through
    :func:`bluefog_tpu_torch.diagnostics.check_finite` (per-rank all-finite
    flags: one reduction on the device, one host read).  Finite outputs
    are snapshotted to host memory (``depth`` most recent): a completed
    device-to-host copy into pinned buffers, never a view, because the
    port's step updates its params and optimizer state in place and the
    next call would overwrite a view.  A non-finite step is *skipped*: the
    newest good snapshot is copied back into the live output tensors
    (``copy_``; the optimizer's state in place; step counters rebuilt), so
    the references the caller holds stay valid and hold the good state.
    The restored snapshot is consumed: consecutive failures walk backward
    through the ring one snapshot at a time, and the guard raises with the
    rollback depth once the ring is exhausted.  Ranks in
    :func:`dead_ranks` are excluded from the verdict (a healed-around
    rank's stale row may be anything).
    """

    def __init__(self, fn: Callable, *, check_every_k: int = 1,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._fn = fn
        self._k = max(1, int(check_every_k))
        self._depth = int(depth)
        self._ring: List[Any] = []
        self.calls = 0
        self.nonfinite_steps = 0
        self.rollbacks = 0

    # -- snapshots --------------------------------------------------------
    def _snapshot(self, out) -> None:
        # the oldest snapshot leaves the ring: its buffers take this one
        spare = (snapshot_tensors(self._ring.pop(0))
                 if len(self._ring) >= self._depth else [])
        snap = snapshot(out, torch.cuda.is_available(), spare)
        if any(t.is_cuda for t in live_tensors(out)):
            torch.cuda.synchronize()       # the copies have landed
        self._ring.append(snap)

    def _restore(self, out):
        if not self._ring:
            return None
        restored = restore_into(out, self._ring[-1])
        if any(t.is_cuda for t in live_tensors(out)):
            torch.cuda.synchronize()       # the snapshot is free to reuse
        return restored

    def last_good(self):
        """The newest good snapshot, on the host (or None)."""
        return self._ring[-1] if self._ring else None

    # -- the step ---------------------------------------------------------
    def __call__(self, *args, **kwargs):
        try:
            out = self._fn(*args, **kwargs)
        except _chaos.RankKilled as e:
            if e.rank is not None:
                _diag.record_peer_failure(e.rank)
            raise
        self.calls += 1
        if self.calls % self._k:
            return out
        finite = np.asarray(_diag.check_finite(out))
        _diag.observe_peer_finiteness(finite, step=self.calls)
        alive = np.ones(finite.shape[0], dtype=bool)
        dead = [r for r in dead_ranks() if r < finite.shape[0]]
        alive[dead] = False
        if bool(finite[alive].all()):
            self._snapshot(out)
            return out
        # non-finite on a live rank: skip this step, restore last good
        self.nonfinite_steps += 1
        bad = [int(r) for r in np.nonzero(~finite & alive)[0]]
        _metrics.counter(
            "bluefog_nonfinite_steps_total",
            "train steps whose outputs failed the finite guard").inc()
        # dump-on-failure: the poisoned step is about to be rolled back —
        # capture the run-up (which ops/steps/faults preceded it) now
        _flight.note_failure(
            "nonfinite", detail=f"ranks {bad} failed the finite guard",
            step=self.calls)
        from .utils import timeline as _tl
        _tl.record_span(
            f"resilience:nonfinite:ranks={','.join(map(str, bad))}",
            "FAULT", _tl._now_us(), 1.0)
        restored = self._restore(out)
        if restored is None:
            depth = (f"after {self.rollbacks} rollback(s), snapshot ring "
                     "exhausted" if self.rollbacks else
                     "with no good snapshot to roll back to "
                     "(guard installed after the blow-up?)")
            raise FloatingPointError(
                f"non-finite step outputs on ranks {bad} at call "
                f"{self.calls} {depth}")
        # consume the restored snapshot: if the *next* check fails too,
        # roll back one snapshot deeper instead of replaying this one
        self._ring.pop()
        self.rollbacks += 1
        _flight.record("rollback", name="guard_step", step=self.calls,
                       ring_left=len(self._ring))
        return restored


def guard_step(fn: Callable, *, check_every_k: int = 1,
               depth: int = 2) -> GuardedStep:
    """Convenience wrapper: ``guard_step(step_fn)(params, opt, batch)``.

    Composes with the optimizer factories' instrumented steps — guard the
    *outermost* callable so rollback sees exactly what the training loop
    sees.  ``check_every_k`` amortizes the probe the same way
    ``metrics_every_k`` does.
    """
    return GuardedStep(fn, check_every_k=check_every_k, depth=depth)


# ---------------------------------------------------------------------------
# Mesh regrowth: checkpoint-free world re-bootstrap
# ---------------------------------------------------------------------------
# Elastic membership (admit/retire above) works inside the world formed at
# init: its rank count is fixed there.  regrow_world is the jump across that
# boundary — quiesce, re-form the world at N+K ranks (context.reinit), carry
# the survivors' state across in host memory, and neighbor-pull-bootstrap
# the joiners on the NEW world.  No checkpoint round-trip anywhere.  Every
# phase gets a deadline + bounded retry with exponential backoff, and a
# failed phase rolls the process back to the old world (which is retained
# until the new world's first step commits).

#: regrow protocol phases, in execution order
REGROW_PHASES = ("quiesce", "handshake", "snapshot", "reinit", "carry",
                 "joiner_pull")

_DEFAULT_REGROW_TIMEOUT = 30.0
_DEFAULT_REGROW_RETRIES = 2

_regrow_pending: Optional[Dict[str, Any]] = None
_regrow_status: Dict[str, Any] = {}


class RegrowAborted(RuntimeError):
    """A mesh regrowth failed and was rolled back to the old world.

    ``phase`` names the protocol phase that exhausted its deadline/retry
    budget (or was killed), ``rank`` the blamed rank when a chaos kill
    named one.  The process is back on the pre-regrowth context, carving,
    schedules and membership registry: training and serving continue on
    the old world — catching this exception IS the degraded-but-alive
    path.
    """

    def __init__(self, phase: str, reason: str,
                 rank: Optional[int] = None):
        self.phase = phase
        self.reason = reason
        self.rank = rank
        super().__init__(
            f"mesh regrowth aborted in phase {phase!r}: {reason}"
            + (f" (blamed rank {rank})" if rank is not None else ""))


class RegrowHandle:
    """A regrowth that succeeded but is not yet committed.

    The old world (context, compose carving and membership registry)
    stays retained until :meth:`commit` — call it after the new world's
    *first* train/serve step completes, so a blow-up on the very first
    post-regrowth step still has a world to fall back to.
    ``bytes_carried`` counts the tensor bytes the carry phase moved onto
    the new world.
    """

    def __init__(self, *, world_before: int, world_after: int,
                 coordinator: int, joiners: Tuple[int, ...],
                 duration_s: float, bytes_carried: int = 0):
        self.world_before = world_before
        self.world_after = world_after
        self.coordinator = coordinator
        self.joiners = joiners
        self.duration_s = duration_s
        self.bytes_carried = bytes_carried

    @property
    def committed(self) -> bool:
        return not regrow_pending()

    def commit(self) -> bool:
        return commit_regrow()

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        state = "committed" if self.committed else "pending"
        return (f"RegrowHandle({self.world_before}->{self.world_after}, "
                f"coordinator={self.coordinator}, {state})")


def _regrow_flight_block() -> Dict[str, Any]:
    """The ``regrow`` bundle block ``tools/postmortem.py`` surfaces in the
    verdict timeline (world sizes, coordinator, duration, aborts)."""
    return dict(_regrow_status)


def _publish_regrow(status: Dict[str, Any]) -> None:
    _regrow_status.clear()
    _regrow_status.update(status)


def _regrow_timeout() -> float:
    import os
    env = os.environ.get("BLUEFOG_REGROW_TIMEOUT", "").strip()
    if env:
        t = float(env)
        if t <= 0:
            raise ValueError(
                f"BLUEFOG_REGROW_TIMEOUT must be > 0, got {env!r}")
        return t
    return _DEFAULT_REGROW_TIMEOUT


class _PhaseRunner:
    """Deadline + bounded-retry executor for one regrow protocol phase.

    Every attempt first gives the chaos plan its shot
    (:func:`bluefog_tpu_torch.utils.chaos.on_regrow_phase` — may kill the
    coordinator/joiner or wedge the phase), then runs the phase body and
    checks the elapsed time against the deadline.  A ``RankKilled`` is
    never retried (the victim is gone; the caller aborts and rolls back);
    any other failure — including a blown deadline — retries after
    ``backoff * 2**(attempt-1)`` seconds up to ``retries`` times.
    """

    def __init__(self, *, status: Dict[str, Any], timeout: float,
                 retries: int, backoff: float, coordinator: int,
                 joiners: Tuple[int, ...]):
        self.status = status
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.backoff = float(backoff)
        self.coordinator = coordinator
        self.joiners = joiners
        self.phase = REGROW_PHASES[0]

    def run(self, phase: str, fn: Callable[[], Any]) -> Any:
        import time as _time
        self.phase = phase
        attempts = self.retries + 1
        for attempt in range(1, attempts + 1):
            t0 = _time.monotonic()
            try:
                _chaos.on_regrow_phase(
                    phase, attempt, coordinator=self.coordinator,
                    joiners=self.joiners)
                out = fn()
                elapsed = _time.monotonic() - t0
                if elapsed > self.timeout:
                    raise TimeoutError(
                        f"phase {phase!r} attempt {attempt} took "
                        f"{elapsed:.3f} s (deadline {self.timeout:.3f} s)")
            except _chaos.RankKilled:
                raise              # the victim is gone: abort, don't retry
            except Exception as e:
                elapsed = _time.monotonic() - t0
                self.status["failed_attempts"] += 1
                _flight.record(
                    "regrow", name="phase_retry", phase=phase,
                    attempt=attempt, elapsed_s=round(elapsed, 6),
                    error=f"{type(e).__name__}: {e}")
                _publish_regrow(self.status)
                if attempt >= attempts:
                    raise
                _time.sleep(self.backoff * (2 ** (attempt - 1)))
                continue
            self.status["phases"].append(
                {"phase": phase, "attempt": attempt,
                 "elapsed_s": round(elapsed, 6)})
            _publish_regrow(self.status)
            _flight.record("regrow", name="phase", phase=phase,
                           attempt=attempt, elapsed_s=round(elapsed, 6))
            return out
        raise AssertionError("unreachable")     # pragma: no cover


def _snapshot_registry() -> Dict[str, Any]:
    # the pristine baseline is copied (its keys are rebound in place by
    # _refresh_pristine/_apply_membership) so an aborted regrow that
    # touched it cannot poison the rollback capsule
    with _lock:
        return {"dead": set(_dead), "retired": set(_retired),
                "draining": set(_draining),
                "warmup": {r: list(v) for r, v in _warmup.items()},
                "pristine": dict(_pristine) if _pristine is not None
                else None}


def _restore_registry(snap: Dict[str, Any]) -> None:
    # every value is re-copied out of the snapshot so the snapshot itself
    # stays pristine: a second abort restoring from the same capsule gets
    # exactly the same state as the first
    global _pristine
    with _lock:
        _dead.clear()
        _dead.update(snap["dead"])
        _retired.clear()
        _retired.update(snap["retired"])
        _draining.clear()
        _draining.update(snap["draining"])
        _warmup.clear()
        _warmup.update({r: list(v) for r, v in snap["warmup"].items()})
        _pristine = (dict(snap["pristine"])
                     if snap["pristine"] is not None else None)


def _host_snapshot(tree: Any, ctx) -> Tuple[Any, List[torch.device]]:
    """A host copy of ``tree`` that references no device tensor
    (:func:`bluefog_tpu_torch.utils.snapshot.snapshot`: containers
    rebuilt, an optimizer as its per-parameter state list, pinned copies
    from a card), with each tensor's device in the copy's order.  Across
    processes every leaf with this process's ``rows`` on dim 0 is
    gathered whole, ``[size, ...]``, so the carry can lay the survivors'
    rows out over any new process layout."""
    unfolded = unfold(tree)
    devices: List[torch.device] = []
    map_tensors(lambda t: devices.append(t.device), unfolded)
    if ctx.world > 1:
        import torch.distributed as dist

        def whole(t):
            if t.ndim >= 1 and t.shape[0] == ctx.rows:
                parts = [torch.empty_like(t) for _ in range(ctx.world)]
                dist.all_gather(parts, t.contiguous())
                return torch.cat(parts)
            return t

        unfolded = map_tensors(whole, unfolded)
    snap = snapshot(unfolded, pin=ctx.device.type == "cuda")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return snap, devices


def _carry_state(snap: Tuple[Any, List[torch.device]], old_n: int,
                 new_n: int, new_ctx, old_world: int = 1
                 ) -> Tuple[Any, int]:
    """Lay a host snapshot out on the regrown world.

    Tensors with a leading rank axis (``shape[0] == old_n``) are extended
    (grow) or truncated (shrink) to ``new_n`` rows — survivor rows byte
    for byte the snapshot's, joiner rows seeded from rank 0's row as a
    finite placeholder the neighbor-pull bootstrap then overwrites — and
    this process's block of them lands on the context's device.  Every
    other tensor is copied back to the device it came from; plain values
    pass through.  Every process that holds the snapshot lays its own
    block out from it; a new world with more processes than
    ``old_world`` has joiner processes that hold none, and process 0
    sends each of them its block (:func:`regrow_join` receives it).
    Returns ``(tree, bytes moved onto the devices)``."""
    host, devices = snap
    dev = new_ctx.device
    rows, first = new_ctx.rows, new_ctx.first_rank
    joiner_procs = range(old_world, new_ctx.world)
    at = iter(devices)
    moved = [0]

    def block(t, start, keep):
        # rows [start, start + rows) of the laid-out tensor straight from
        # the (pinned) host copy: survivor rows, then joiner rows seeded
        # from row 0
        out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=dev)
        hi = min(start + rows, keep)
        if hi > start:
            out[:hi - start].copy_(t[start:hi], non_blocking=True)
        lo = max(start, keep)
        if start + rows > lo:
            out[lo - start:].copy_(t[0].expand_as(out[lo - start:]),
                                   non_blocking=True)
        return out

    def carry(t):
        home = next(at)
        if t.ndim >= 1 and t.shape[0] == old_n:
            keep = min(old_n, new_n)
            out = block(t, first, keep)
            if joiner_procs and new_ctx.process == 0:
                import torch.distributed as dist
                for p in joiner_procs:
                    dist.send(block(t, p * rows, keep), dst=p)
        else:
            out = t.to(home, copy=True)
        moved[0] += out.numel() * out.element_size()
        return out

    tree = map_tensors(carry, host)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return tree, moved[0]


def _abort_rollback(capsule: Dict[str, Any], attempts: int = 3) -> None:
    """Reinstall the retained old world from the abort capsule.

    The rollback window is itself preemptible: a second spot reclaim (or
    any async exception) can land between re-installing the old context
    and restoring the membership registry, splitting the pair.  Each
    attempt therefore re-runs BOTH halves from the capsule — which no
    restore ever mutates — so a retry after a mid-rollback failure
    converges on exactly the pre-regrow world instead of a hybrid.
    """
    last: Optional[Exception] = None
    for attempt in range(1, attempts + 1):
        try:
            _mesh._install(capsule["ctx"], capsule["compose"])
            _restore_registry(capsule["registry"])
            return
        except Exception as exc:     # second preemption mid-rollback
            last = exc
            _flight.record("regrow", name="rollback_retry", attempt=attempt,
                           error=f"{type(exc).__name__}: {exc}")
    raise RuntimeError(
        f"regrow rollback failed {attempts} times; the retained world "
        "may be inconsistent") from last


def _pull_joiners(out: Any, joiners: Sequence[int], min_neighbors: int,
                  warmup_steps: int, new_ctx) -> Any:
    """The joiner-pull phase's body: bootstrap each joiner by live
    neighbor gossip on the new world, then open its out-edges (optionally
    ramped)."""
    if out is not None:
        for j in joiners:
            out = bootstrap_params(out, j, min_neighbors=min_neighbors)
    if warmup_steps:
        _refresh_pristine(new_ctx)
        with _lock:
            for j in joiners:
                _warmup[j] = [1, warmup_steps + 1]
        _apply_membership(new_ctx)
    return out


def regrow_world(target: int, params: Any = None, *,
                 coordinator: Optional[int] = None,
                 timeout: Optional[float] = None,
                 retries: int = _DEFAULT_REGROW_RETRIES,
                 backoff: float = 0.05,
                 min_neighbors: int = 2,
                 warmup_steps: int = 0,
                 topology_fn: Optional[Callable[[], nx.DiGraph]] = None,
                 processes: Optional[int] = None,
                 ) -> Tuple[Any, RegrowHandle]:
    """Re-bootstrap the world at ``target`` ranks — no checkpoint files.

    The coordinator (lowest live rank by default) drives the protocol::

        quiesce ──► handshake ──► snapshot ──► reinit ──► carry ──► joiner_pull
        (device      (coordinator  (state to    (new world  (rows onto (bootstrap_
         drained)     election +    host mem)    + carving   the new    params per
                      validation)                + registry) world)     joiner)

    Each phase runs under a deadline (``timeout``, default the
    ``BLUEFOG_REGROW_TIMEOUT`` env var or 30 s) with ``retries`` bounded
    retries and exponential backoff.  Any exhausted phase — or a chaos
    ``kill_coordinator`` / ``kill_joiner`` — rolls the process back to the
    old world (context, carving, membership registry) and raises
    :class:`RegrowAborted`; survivors keep training/serving on the old
    world.  On success the old world is *retained* until
    :func:`commit_regrow` (call it after the new world's first step), and
    ``(new_params, handle)`` is returned: survivor rows of ``params`` are
    carried losslessly through host memory, joiner rows are seeded by the
    neighbor pull (:func:`bootstrap_params`) running on the new world.
    Previously-dead ranks stay healed around in the new world.

    ``params`` may hold a whole train state: the carried tree has the
    host snapshot's form (an optimizer becomes its per-parameter state
    list, a dataclass a dict; see ``utils/snapshot.py``), every tensor on
    the new world's device, and a trainer built at the new size takes it
    through ``restore_into``.  The caller's tensors are not touched, so
    the old world's state stays usable after an abort.

    ``warmup_steps > 0`` opens the joiners' out-edges at reduced weight
    that ramps to nominal over :func:`advance_membership` ticks, exactly
    like an elastic re-admission.  ``processes`` re-forms the process
    group at that many processes (see ``context.reinit``); joiner
    processes enter through :func:`regrow_join`.
    """
    global _regrow_pending
    import time as _time

    ctx = _mesh.get_context()
    if _regrow_pending is not None:
        raise RuntimeError(
            "a regrowth is already pending; call commit_regrow() after "
            "the new world's first step before regrowing again")
    target = int(target)
    old_n = ctx.size
    if target < 2:
        raise ValueError(f"regrow target must be >= 2, got {target}")
    if target == old_n:
        raise ValueError(
            f"regrow target {target} equals the current world size")
    if warmup_steps < 0:
        raise ValueError("warmup_steps must be >= 0")
    if timeout is None:
        timeout = _regrow_timeout()
    joiners = tuple(range(old_n, target)) if target > old_n else ()
    if coordinator is None:
        coordinator = min(live_ranks())
    coordinator = int(coordinator)
    if not (0 <= coordinator < old_n):
        raise ValueError(
            f"coordinator rank {coordinator} out of range for "
            f"world size {old_n}")
    procs = ctx.world if processes is None else int(processes)

    capsule = {"ctx": ctx, "compose": _mesh.get_compose(),
               "registry": _snapshot_registry()}
    status: Dict[str, Any] = {
        "world_before": old_n, "world_after": target,
        "coordinator": coordinator, "joiners": list(joiners),
        "committed": False, "failed_attempts": 0, "aborts": 0,
        "phases": [], "duration_s": None,
    }
    _flight.register_block("regrow", _regrow_flight_block)
    _publish_regrow(status)
    _flight.record("regrow", name="begin", world_before=old_n,
                   world_after=target, coordinator=coordinator,
                   joiners=list(joiners))
    runner = _PhaseRunner(status=status, timeout=timeout, retries=retries,
                          backoff=backoff, coordinator=coordinator,
                          joiners=joiners)
    carried = [0]
    t_start = _time.monotonic()
    try:
        # 1. quiesce: the step barrier — the device's queued work drains
        # before the world is torn down under it
        def _quiesce():
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
        runner.run("quiesce", _quiesce)

        # 2. handshake: the elected coordinator validates the target
        # against the new process layout before anything is torn down
        def _handshake():
            if target % procs:
                raise ValueError(
                    f"regrow target {target} is not a whole number of "
                    f"ranks for each of the {procs} processes")
            return coordinator
        runner.run("handshake", _handshake)

        # 3. snapshot: the carried state to host memory (no device tensor
        # referenced past this point)
        snap = runner.run(
            "snapshot",
            (lambda: _host_snapshot(params, ctx)) if params is not None
            else (lambda: None))

        # 4. reinit: tear down + re-form world/carving/registry at target
        new_ctx = runner.run(
            "reinit",
            lambda: _mesh.reinit(target, topology_fn=topology_fn,
                                 processes=procs))

        # previously-dead ranks stay healed around in the new world
        carried_dead = sorted(r for r in capsule["registry"]["dead"]
                              if r < target)
        if carried_dead:
            mark_rank_dead(*carried_dead)

        # 5. carry: survivors' rows onto the new world
        new_params = None
        if params is not None:
            def _carry():
                tree, nbytes = _carry_state(snap, old_n, target, new_ctx,
                                            old_world=ctx.world)
                carried[0] = nbytes
                return tree
            new_params = runner.run("carry", _carry)

        # 6. joiner pull: bootstrap each joiner by live neighbor gossip
        # on the NEW world, then open its out-edges (optionally ramped)
        if joiners:
            new_params = runner.run(
                "joiner_pull",
                lambda: _pull_joiners(new_params, joiners, min_neighbors,
                                      warmup_steps, new_ctx))
    except Exception as exc:
        status["aborts"] += 1
        rank = getattr(exc, "rank", None)
        try:
            _abort_rollback(capsule)
        finally:
            # bookkeeping runs even if the rollback itself blew up, so
            # the abort is never invisible to the flight recorder
            _publish_regrow(status)
            _flight.record("regrow", name="abort", phase=runner.phase,
                           world_before=old_n, world_after=target,
                           coordinator=coordinator, rank=rank,
                           error=f"{type(exc).__name__}: {exc}")
            _fault_span(f"resilience:regrow_abort:{runner.phase}")
        raise RegrowAborted(
            runner.phase, f"{type(exc).__name__}: {exc}",
            rank=rank) from exc

    duration = _time.monotonic() - t_start
    status["duration_s"] = round(duration, 6)
    _regrow_pending = {"capsule": capsule, "status": status}
    _publish_regrow(status)
    _update_membership_gauges(target)
    _count_membership("regrow")
    _flight.record("regrow", name="regrown", world_before=old_n,
                   world_after=target, coordinator=coordinator,
                   joiners=list(joiners), duration_s=round(duration, 6))
    handle = RegrowHandle(
        world_before=old_n, world_after=target, coordinator=coordinator,
        joiners=joiners, duration_s=duration, bytes_carried=carried[0])
    return new_params, handle


def regrow_join(template: Any, world_before: int, *,
                min_neighbors: int = 2) -> Any:
    """The joiner process's side of a regrowth that adds processes: run
    in a process the supervisor spawned into the new world (its
    ``context.init`` already formed the new process group), while the
    survivors run :func:`regrow_world`.  ``template`` is a tree of the
    carried state's form with this process's rows (a freshly initialized
    state; ``utils/snapshot.py::unfold`` gives a live state that form);
    its row tensors are replaced by the block of carried rows process 0
    sends, then the joiner pull runs with the survivors.  Returns the
    joiner's state."""
    ctx = _mesh.get_context()
    old_n, new_n = int(world_before), ctx.size
    if not old_n < new_n:
        raise ValueError(f"a joiner enters a world that grows, not "
                         f"{old_n} -> {new_n} ranks")
    import torch.distributed as dist
    rows = ctx.rows

    def receive(t):
        if t.ndim >= 1 and t.shape[0] == rows:
            out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=ctx.device)
            dist.recv(out, src=0)
            return out
        return t

    tree = map_tensors(receive, unfold(template))
    return _pull_joiners(tree, tuple(range(old_n, new_n)), min_neighbors,
                         0, ctx)


def commit_regrow() -> bool:
    """Release the old world after a successful regrowth.

    Call after the new world's first train/serve step completes: until
    then the pre-regrowth context, carving and registry snapshot are
    retained so a first-step blow-up can still roll back by hand.
    Returns True if a pending regrowth was committed, False when none was
    pending.  Idempotent.
    """
    global _regrow_pending
    if _regrow_pending is None:
        return False
    status = _regrow_pending["status"]
    _regrow_pending = None
    status["committed"] = True
    _publish_regrow(status)
    _flight.record("regrow", name="commit",
                   world_before=status["world_before"],
                   world_after=status["world_after"],
                   coordinator=status["coordinator"],
                   duration_s=status["duration_s"])
    return True


def regrow_pending() -> bool:
    """True while a regrowth awaits :func:`commit_regrow`."""
    return _regrow_pending is not None
