"""Candidate enumeration for :func:`bluefog_tpu_torch.autotune.autotune`
(the port's own copy of ``bluefog_tpu/autotune/candidates.py``, which
imports the JAX strategy registry; every key, audit and reason text is the
same).

A candidate is one point in the knob space {algorithm x topology x wire
codec x schedule weighting x fused-k x delayed x concurrent}.  Enumeration
collapses the axes an algorithm is indifferent to (the registry's
:class:`~bluefog_tpu_torch.optimizers.StrategySpec` flags), so ``allreduce``
never multiplies by topologies and ``push_sum`` never multiplies by wire
codecs, and it filters contract-violating combinations *before* anything
compiles — each rejection carries the same reason string the constructor
would raise at runtime (``strategy_constraint_violation``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..optimizers import (
    STRATEGIES, push_schedule, strategy_constraint_violation,
)
from ..schedule import CommSchedule, compile_from_weights, compile_topology
from .. import topology as topo_util


class Candidate(NamedTuple):
    """One configuration the tuner can score, reject, or pick."""
    algorithm: str
    topology: Optional[dict]        # JSON spec (topology_from_spec) or None
    wire: Optional[str]
    weights: Optional[str]          # "recv" | "push" | "dst" | None
    fused_k: int
    delayed: bool
    concurrent: Optional[bool]

    @property
    def key(self) -> str:
        """Deterministic identity string (sort tie-break + audit handle)."""
        topo = _topo_key(self.topology)
        return (f"{self.algorithm}|topo={topo}|wire={self.wire}"
                f"|weights={self.weights}|k={self.fused_k}"
                f"|delayed={int(self.delayed)}|concurrent={self.concurrent}")

    @property
    def compile_group(self) -> tuple:
        """Candidates sharing a group compile to identical per-step wire
        bytes: ``fused_k`` scales a whole call, not a step, and ``delayed``
        / ``concurrent`` rearrange dataflow without changing payloads."""
        return (self.algorithm, _topo_key(self.topology), self.wire,
                self.weights)

    def config(self) -> dict:
        """JSON-serializable knob dict (what the plan stores)."""
        return {
            "algorithm": self.algorithm, "topology": self.topology,
            "wire": self.wire, "weights": self.weights,
            "fused_k": self.fused_k, "delayed": self.delayed,
            "concurrent": self.concurrent,
        }


class CarvingCandidate(NamedTuple):
    """One ``(dp, pp, tp, sp, ep)`` mesh carving the carving tuner can
    score, reject, or pick (``tune_carving``).  The expert axis rides the
    same contract :func:`~bluefog_tpu_torch.parallel.compose.compose_parallelism`
    enforces eagerly: ``ep > 1`` requires a composed carving with the total
    expert count declared and divisible."""
    dp: int
    pp: int
    tp: int
    sp: int
    ep: int

    @property
    def n_chips(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    @property
    def slice_size(self) -> int:
        """Devices per DP replica — the intra-slice (ICI) budget."""
        return self.pp * self.tp * self.sp * self.ep

    @property
    def key(self) -> str:
        return (f"carve|dp={self.dp}|pp={self.pp}|tp={self.tp}"
                f"|sp={self.sp}|ep={self.ep}")

    def config(self) -> dict:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp,
                "sp": self.sp, "ep": self.ep}


def carving_violation(carve: CarvingCandidate, n_chips: int,
                      num_experts: Optional[int],
                      require_gossip: bool = True) -> Optional[str]:
    """The carving contract as audit-ready reason strings (None = legal).

    Mirrors ``compose_parallelism``'s eager validation so a rejected
    carving never reaches a compile, plus the tuner-level rule that the
    gossip-DP axis must exist — a dp=1 carving has nothing decentralized
    to tune."""
    if carve.n_chips != n_chips:
        return (f"carving_size_mismatch: dp*pp*tp*sp*ep = {carve.n_chips} "
                f"!= device count ({n_chips})")
    if require_gossip and carve.dp < 2:
        return ("carving_no_gossip_axis: dp=1 leaves no gossip-DP "
                "replicas; the decentralized contract (and any wire "
                "codec) needs dp >= 2")
    if carve.ep > 1:
        if num_experts is None:
            return ("moe_carving_requires_num_experts: ep>1 carves an "
                    "expert axis, which only exists on a composed MoE "
                    "carving with the total expert count declared")
        if num_experts % carve.ep:
            return (f"moe_carving_experts_not_divisible: num_experts "
                    f"({num_experts}) % ep ({carve.ep}) != 0")
    return None


def _factorizations(n: int, k: int):
    """All ordered k-tuples of positive ints with product n."""
    if k == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, k - 1):
                yield (d,) + rest


def enumerate_carvings(
    n_chips: int,
    *,
    num_experts: Optional[int] = None,
    require_gossip: bool = True,
    max_pp: Optional[int] = None,
    max_tp: Optional[int] = None,
    max_sp: Optional[int] = None,
    max_ep: Optional[int] = None,
) -> Tuple[List[CarvingCandidate], List[dict]]:
    """Enumerate ``(accepted, rejected)`` 5-axis carvings of n_chips.

    Every ordered factorization ``dp*pp*tp*sp*ep == n_chips`` is
    considered; contract violations land in ``rejected`` as
    ``{"key", "config", "reason"}`` audit entries (same shape as
    :func:`enumerate_candidates`'s).  The ``max_*`` bounds *prune* the
    combinatorial space silently (they are search hints, not contracts) —
    pass them to keep the lowered-candidate count sane on big meshes."""
    if not isinstance(n_chips, (int,)) or n_chips < 1:
        raise ValueError(f"n_chips={n_chips!r} must be a positive int")
    accepted: List[CarvingCandidate] = []
    rejected: List[dict] = []
    bounds = (None, max_pp, max_tp, max_sp, max_ep)
    for axes in _factorizations(n_chips, 5):
        if any(b is not None and v > b for v, b in zip(axes, bounds)):
            continue
        cand = CarvingCandidate(*axes)
        reason = carving_violation(cand, n_chips, num_experts,
                                   require_gossip=require_gossip)
        if reason is None:
            accepted.append(cand)
        else:
            rejected.append({"key": cand.key, "config": cand.config(),
                             "reason": reason})
    return accepted, rejected


def _topo_key(spec: Optional[dict]) -> str:
    if spec is None:
        return "none"
    if spec["family"] == "two_level":
        return (f"two_level[{spec['num_machines']}x{spec['local_size']},"
                f"{spec.get('intra', 'dense')}/{spec.get('inter', 'exp2')}]")
    return f"{spec['family']}[{spec['size']}]"


def two_level_split(n: int) -> Optional[Tuple[int, int]]:
    """Deterministic ``(num_machines, local_size)`` auto-hierarchy for n
    ranks: local = the largest divisor of n that is <= sqrt(n) (so the
    dense intra level stays the small one), or None when n is prime/tiny."""
    best = None
    d = 2
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    if best is None:
        return None
    return n // best, best


def default_topologies(n: int) -> List[dict]:
    """The searched topology family: flat Exp2, ring, and (when n admits a
    nontrivial split) the composed two-level auto-hierarchy."""
    topos = [{"family": "exp2", "size": n}, {"family": "ring", "size": n}]
    split = two_level_split(n)
    if split is not None and n >= 4:
        m, l = split
        topos.append({"family": "two_level", "num_machines": m,
                      "local_size": l, "intra": "dense", "inter": "exp2"})
    return topos


def schedule_for(spec: Optional[dict], weights: Optional[str],
                 n: int) -> Optional[CommSchedule]:
    """Compile the schedule a candidate's (topology, weighting) implies.

    ``"recv"`` is the standard weighted gossip schedule, ``"push"`` the
    column-stochastic push family, ``"dst"`` a sender-side-scaled schedule
    (recv weights uniform, send scales ``1/(outdeg+1)``) — the weighting
    family whose contract interactions (push_sum, choco wire codecs) the
    tuner must surface rather than silently avoid.
    """
    if spec is None or weights is None:
        return None
    topo = topo_util.topology_from_spec(spec)
    if weights == "recv":
        return compile_topology(topo, weighted=True)
    if weights == "push":
        return push_schedule(topo, n)
    if weights == "dst":
        keep = [1.0 / (len(topo_util.GetInNeighbors(topo, r)) + 1.0)
                for r in range(n)]
        src = [{s: keep[r] for s in topo_util.GetInNeighbors(topo, r)}
               for r in range(n)]
        dst = [{d: 1.0 / (len(topo_util.GetOutNeighbors(topo, r)) + 1.0)
                for d in topo_util.GetOutNeighbors(topo, r)}
               for r in range(n)]
        return compile_from_weights(n, keep, src, dst)
    raise ValueError(f"unknown weighting {weights!r}")


def _weights_for(name: str) -> Tuple[Optional[str], ...]:
    """The weighting axis enumerated per algorithm.  Deliberately includes
    the contract-violating pairings (push_sum x dst, choco x dst x bf16) so
    they show up as *audited rejections*, not silent omissions."""
    spec = STRATEGIES[name]
    if not spec.uses_schedule:
        return (None,)
    if name == "push_sum":
        return ("push", "dst")
    if name == "async_window_gossip":
        # same contract family as push_sum: column-stochastic push weights
        # required, dst-weighting enumerated to surface the audited rejection
        return ("push", "dst")
    if name == "choco":
        return ("recv", "dst")
    return spec.weights


def enumerate_candidates(
    n: int,
    *,
    algorithms: Optional[Sequence[str]] = None,
    topologies: Optional[Sequence[dict]] = None,
    wires: Optional[Sequence[Optional[str]]] = None,
    fused_k: Sequence[int] = (1, 4),
    include_delayed: bool = True,
    include_concurrent: bool = True,
) -> Tuple[List[Candidate], List[dict]]:
    """Enumerate ``(accepted, rejected)`` candidates for an n-rank mesh.

    ``rejected`` entries are ``{"key", "config", "reason"}`` dicts — the
    plan's audit trail — produced by the same
    :func:`~bluefog_tpu_torch.optimizers.strategy_constraint_violation` metadata
    the constructors enforce, so no rejected candidate ever reaches a
    compile.
    """
    algorithms = tuple(algorithms) if algorithms else tuple(STRATEGIES)
    for a in algorithms:
        if a not in STRATEGIES:
            raise ValueError(f"unknown algorithm {a!r}: one of "
                             f"{sorted(STRATEGIES)}")
    topologies = list(topologies) if topologies else default_topologies(n)
    base_wires = list(wires) if wires is not None else [None, "bf16"]
    sched_cache: Dict[tuple, CommSchedule] = {}
    accepted: List[Candidate] = []
    rejected: List[dict] = []

    for name in algorithms:
        spec = STRATEGIES[name]
        topos = topologies if spec.uses_schedule else [None]
        if name == "choco":
            # choco owns its codec (int8 default); bf16 is enumerated so
            # the dst-weighting commutation rule surfaces in the audit
            wire_axis: List[Optional[str]] = ["int8", "bf16"]
        elif spec.wire_aware:
            wire_axis = base_wires
        else:
            wire_axis = [None]
        delayed_axis = ([False, True]
                        if include_delayed and name in ("neighbor_cta",
                                                        "neighbor_atc")
                        else [False])
        conc_axis = ([None, True]
                     if include_concurrent and spec.concurrent_aware
                     else [None])
        for topo in topos:
            for w in _weights_for(name):
                sk = (_topo_key(topo), w)
                if spec.uses_schedule and sk not in sched_cache:
                    sched_cache[sk] = schedule_for(topo, w, n)
                sched = sched_cache.get(sk)
                for wire in wire_axis:
                    for k in fused_k:
                        for delayed in delayed_axis:
                            for conc in conc_axis:
                                cand = Candidate(name, topo, wire, w,
                                                 int(k), delayed, conc)
                                reason = strategy_constraint_violation(
                                    name, schedule=sched, wire=wire,
                                    delayed=delayed,
                                    overlap=delayed)
                                if reason is None:
                                    accepted.append(cand)
                                else:
                                    rejected.append({
                                        "key": cand.key,
                                        "config": cand.config(),
                                        "reason": reason})
    return accepted, rejected
