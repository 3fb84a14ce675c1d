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

Mesh regrowth (``regrow_world``, ``commit_regrow``, ``RegrowHandle``,
``RegrowAborted``) needs the context's ``reinit`` and raises until ROADMAP
queue 1, item 10 ports it.
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
from .utils.snapshot import (live_tensors, restore_into, snapshot,
                             snapshot_tensors)

__all__ = [
    "heal_topology", "heal_schedule", "heal_dynamic_schedules",
    "membership_schedule", "schedule_weight_matrix",
    "mark_rank_dead", "admit_rank", "retire_rank", "advance_membership",
    "bootstrap_params", "join_rank", "chaos_join",
    "dead_ranks", "retired_ranks", "live_ranks", "reset",
    "GuardedStep", "guard_step",
    "RegrowAborted", "RegrowHandle", "regrow_world", "commit_regrow",
    "regrow_pending", "REGROW_PHASES",
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
    global _pristine, _warned_send_scales
    with _lock:
        forgotten = tuple(sorted(_dead))
        _dead.clear()
        _retired.clear()
        _draining.clear()
        _warmup.clear()
        _pristine = None
        _warned_send_scales = False
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
# Mesh regrowth: needs the context's reinit (ROADMAP queue 1, item 10)
# ---------------------------------------------------------------------------

#: regrow protocol phases, in execution order (JAX's)
REGROW_PHASES = ("quiesce", "handshake", "snapshot", "reinit", "carry",
                 "joiner_pull")

_REGROW_REFUSAL = (
    "mesh regrowth re-forms the context at a new rank count, which needs "
    "the context's reinit; neither is ported yet (ROADMAP queue 1, item "
    "10: launcher, autotune, elastic, fleet)")


class RegrowAborted(RuntimeError):
    """A mesh regrowth failed and was rolled back to the old world (JAX's
    exception; nothing raises it until ``regrow_world`` is ported)."""

    def __init__(self, phase: str, reason: str,
                 rank: Optional[int] = None):
        self.phase = phase
        self.reason = reason
        self.rank = rank
        super().__init__(
            f"mesh regrowth aborted in phase {phase!r}: {reason}"
            + (f" (blamed rank {rank})" if rank is not None else ""))


class RegrowHandle:
    """A regrowth that succeeded but is not yet committed (refused until
    ROADMAP queue 1, item 10)."""

    def __init__(self, *args, **kwargs):
        raise ValueError(_REGROW_REFUSAL)


def regrow_world(target: int, params: Any = None, **kwargs):
    """Re-form the world at ``target`` ranks: refused until the context's
    ``reinit`` is ported (ROADMAP queue 1, item 10)."""
    raise ValueError(_REGROW_REFUSAL)


def commit_regrow() -> bool:
    """Commit a pending regrowth: refused until ``regrow_world`` is ported
    (ROADMAP queue 1, item 10)."""
    raise ValueError(_REGROW_REFUSAL)


def regrow_pending() -> bool:
    """Whether a regrowth awaits its commit: refused until
    ``regrow_world`` is ported (ROADMAP queue 1, item 10)."""
    raise ValueError(_REGROW_REFUSAL)
