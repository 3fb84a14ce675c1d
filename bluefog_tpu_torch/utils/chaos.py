"""Deterministic fault injection for the decentralized runtime (the
port's own copy of ``bluefog_tpu/utils/chaos.py``: the same grammar, error
texts and seeded draws, so one plan gives the same fault sequence in
both packages).

The robustness counterpart of the reference's *accidental* failure modes
(SURVEY.md §5: a hung MPI rank, a NaN-ed tensor, a preempted host): instead
of waiting for production to produce them, a **chaos plan** injects them on
purpose, deterministically, so the healing/rollback/restart machinery in
:mod:`bluefog_tpu_torch.resilience` and the launcher can be exercised — and its
telemetry asserted — in CI.

A plan is a seeded list of faults parsed from the ``BLUEFOG_CHAOS`` env var
(or built programmatically).  Grammar — ``;``-separated clauses, each
``kind:key=value,...``::

    BLUEFOG_CHAOS="seed=42;kill:step=30,rank=3;nan:step=10,rank=2"
    BLUEFOG_CHAOS="hang:step=5,t=2.5;throttle:from=7,until=20,t=0.05"
    BLUEFOG_CHAOS="nan:op=neighbor_allreduce,call=3,rank=1;kill:p=0.001"
    BLUEFOG_CHAOS="kill:step=4,rank=3;join:step=12,rank=3,warmup=2"

Fault kinds (reference failure modes they emulate):

- ``kill``     — raise :class:`RankKilled` (a dead rank / preempted host).
  In a launcher child the uncaught exception exits the process non-zero,
  which is exactly what ``bfrun-tpu --restart-limit`` supervises.
- ``hang``     — sleep ``t`` seconds once (a wedged link / stuck host;
  the watchdog's ``timeout=`` escalation is the detector).
- ``throttle`` — sleep ``t`` seconds every step in ``[from, until]`` (a
  straggler).
- ``nan``      — corrupt rank ``rank``'s payload row to NaN (a numerics
  blow-up; the non-finite guard + rollback in ``resilience`` is the
  detector/response).
- ``join``     — re-admit rank ``rank`` through the full elastic join
  protocol (``resilience.chaos_join``: neighbor-pull bootstrap of the
  step outputs, then ``admit_rank`` with ``warmup=`` ramp steps), so
  membership churn is seeded-deterministic and testable.  No-op if the
  rank is already live.
- ``kill_coordinator`` / ``kill_joiner`` / ``hang_reinit`` — hostile
  scale events for the mesh-regrowth protocol
  (``resilience.regrow_world``): kill the elected coordinator during a
  coordinator-driven phase, kill a joining rank mid-bootstrap, or wedge
  the re-init phase for ``t`` seconds.  Matched by ``step=`` / ``p=``
  against the per-phase *attempt* counter via :func:`on_regrow_phase`;
  the expected outcome is a clean abort that leaves the old world
  training/serving.
- ``preempt``  — a spot/preemptible reclaim with real spot semantics:
  ``grace=`` seconds of advance notice before the hard kill (a
  ``preempt_notice`` flight event fires immediately; the launcher's
  trace replay turns it into SIGTERM + a grace window before SIGKILL),
  ``zone=`` correlated victims (zone z of the plan-level ``zones=Z``
  split owns the contiguous rank block ``[z*n/Z, (z+1)*n/Z)`` — a
  reclaim takes the whole zone down together, like a real availability
  zone), and ``regrant=`` seconds the capacity stays reclaimed before
  the provider re-grants it.  Raises :class:`RankPreempted` (a
  :class:`RankKilled` subclass, default exit code 143 = SIGTERM) so
  every existing kill path — launcher supervision, regrow no-retry —
  handles it, while postmortems blame "preempted", not "killed".
  ``preempt:step=4,zone=1,grace=2,regrant=30`` with ``zones=2``
  preempts the upper half of the fleet at step 4.

Matching sites: faults with ``op=``/``call=`` match eager op dispatches
(``api.py`` / ``parallel/windows.py``); all others match the train-step
wrapper's call counter (``optimizers._InstrumentedStep``).  ``step``/``call``
are 1-based.  ``p=`` arms a fault probabilistically per step with a
seed-derived draw, so the *same* plan produces the *same* fault sequence on
every rank and every rerun — chaos runs are reproducible by construction.

Zero overhead when unset: the hook sites check the module-level ``_plan``
attribute inline and do nothing else when no plan is installed — no parsing,
no matching, no allocation on the step path.  torch / the metrics registry /
the timeline are imported lazily so launcher children can import this module
cheaply.

The port's ranks are rows of stacked tensors (``[n, ...]``, rank on dim 0).
Launched as several processes, each holds a block of rows: a
rank-targeted fault fires only in the process whose block holds
``fault.rank``, and a ``nan`` fault writes NaN into that row there, in
place.  The train step updates its params and state in place, so the
corrupted step output is the live state the next call reads, as JAX's
next call reads its corrupted output.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Fault", "ChaosPlan", "RankKilled", "RankPreempted",
    "install", "uninstall", "active", "current_plan",
    "maybe_install_from_env", "on_train_step", "corrupt_train_output",
    "apply_membership", "on_eager_op", "on_regrow_phase",
    "consume_step_delays", "zone_victims",
]

ENV_VAR = "BLUEFOG_CHAOS"
DEFAULT_KILL_CODE = 43
#: 128 + SIGTERM: what a spot victim's exit status reads after the grace
#: window — supervisors distinguish a reclaim from a crash by this code
DEFAULT_PREEMPT_CODE = 143

_KINDS = ("kill", "hang", "throttle", "nan", "join",
          "kill_coordinator", "kill_joiner", "hang_reinit", "preempt")

#: Fault kinds that fire inside the mesh-regrowth protocol (matched by
#: :func:`on_regrow_phase` against the per-phase attempt counter, never by
#: the train-step / eager-op hooks).  ``kill_coordinator`` kills the
#: elected coordinator during a coordinator-driven phase (quiesce /
#: handshake / reinit), ``kill_joiner`` kills a joining rank during its
#: bootstrap pull, ``hang_reinit`` wedges the re-init phase for ``t``
#: seconds (the deadline + retry machinery is the detector).
_REGROW_KINDS = ("kill_coordinator", "kill_joiner", "hang_reinit")

#: regrow phases each regrow fault kind can fire in
_REGROW_PHASES = {
    "kill_coordinator": ("quiesce", "handshake", "reinit"),
    "kill_joiner": ("joiner_pull",),
    "hang_reinit": ("reinit",),
}


class RankKilled(RuntimeError):
    """A chaos ``kill`` fault fired: the targeted rank is dead.

    In a multi-process job the uncaught exception takes the process down
    (non-zero exit — the launcher's restart supervisor picks it up); in a
    single process of stacked ranks the training loop catches it and hands
    ``rank`` to :func:`bluefog_tpu_torch.resilience.mark_rank_dead`.
    """

    def __init__(self, rank: Optional[int], step: int,
                 code: int = DEFAULT_KILL_CODE):
        self.rank = rank
        self.step = step
        self.code = code
        super().__init__(
            f"chaos: rank {'*' if rank is None else rank} killed at "
            f"step {step} (exit code {code})")


def zone_victims(zone: int, size: int, zones: int) -> Tuple[int, ...]:
    """Ranks a zone-correlated preemption reclaims together.

    Zone ``z`` of ``zones`` owns the contiguous block
    ``[z*size/zones, (z+1)*size/zones)`` — contiguous because a real zone
    is a physical slice/datacenter block, and the hierarchical machine
    grouping keeps each slice's chips contiguous on the rank axis.
    """
    z, zn = int(zone), max(1, int(zones))
    if not (0 <= z < zn):
        raise ValueError(f"zone {z} out of range for zones={zn}")
    return tuple(range(z * size // zn, (z + 1) * size // zn))


class RankPreempted(RankKilled):
    """A chaos ``preempt`` fault fired: the victim ranks lost their spot
    capacity.  ``ranks`` is the full correlated victim set (one rank for a
    ``rank=`` fault, a whole contiguous zone block for ``zone=``);
    ``grace`` is the advance-notice window in seconds the victims got to
    drain, ``regrant`` how long the capacity stays reclaimed before the
    provider re-grants it.  Training loops catch this and shrink via
    :func:`bluefog_tpu_torch.resilience.regrow_world` (ROADMAP queue 1,
    item 10), then regrow when the re-grant lands.
    """

    def __init__(self, ranks: Tuple[int, ...], step: int, *,
                 zone: Optional[int] = None, grace: float = 0.0,
                 regrant: float = 0.0, code: int = DEFAULT_PREEMPT_CODE):
        self.ranks = tuple(int(r) for r in ranks)
        self.zone = zone
        self.grace = float(grace)
        self.regrant = float(regrant)
        first = self.ranks[0] if self.ranks else None
        RuntimeError.__init__(
            self,
            f"chaos: rank(s) {list(self.ranks)} preempted at step {step}"
            + (f" (zone {zone})" if zone is not None else "")
            + f" with {self.grace:g} s grace (exit code {code})")
        self.rank = first
        self.step = step
        self.code = code


@dataclass(frozen=True)
class Fault:
    """One fault clause.  ``step`` doubles as the throttle window start."""
    kind: str
    step: Optional[int] = None       # train-step index (1-based)
    until: Optional[int] = None      # throttle window end (inclusive)
    call: Optional[int] = None       # eager-op call index (1-based, per op)
    op: Optional[str] = None         # eager op name ("*" matches any op)
    rank: Optional[int] = None       # target rank (None = caller decides)
    t: float = 0.0                   # hang/throttle sleep seconds
    p: Optional[float] = None        # seeded per-step probability
    code: int = DEFAULT_KILL_CODE    # kill exit code
    warmup: int = 0                  # join entry-weight ramp steps
    zone: Optional[int] = None       # preempt: correlated-victim zone id
    grace: float = 0.0               # preempt: advance-notice seconds
    regrant: float = 0.0             # preempt: capacity re-grant delay (s)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown chaos fault kind {self.kind!r} (expected one of "
                f"{_KINDS})")
        if self.kind in ("hang", "throttle", "hang_reinit") and self.t <= 0:
            raise ValueError(f"{self.kind} fault needs t=<seconds> > 0")
        if self.kind in ("nan", "join") and self.rank is None:
            raise ValueError(f"{self.kind} fault needs rank=<target rank>")
        if self.kind == "preempt":
            if self.rank is None and self.zone is None:
                raise ValueError(
                    "preempt fault needs rank=<victim> or zone=<zone id>")
            if self.rank is not None and self.zone is not None:
                raise ValueError(
                    "preempt fault takes rank= OR zone=, not both")
            if self.grace < 0 or self.regrant < 0:
                raise ValueError("preempt grace/regrant must be >= 0")
            if self.op is not None or self.call is not None:
                raise ValueError(
                    "preempt faults match train steps, not eager ops "
                    "(no op=/call=)")
        elif self.zone is not None or self.grace or self.regrant:
            raise ValueError(
                f"zone=/grace=/regrant= only apply to preempt faults, "
                f"not {self.kind}")
        if self.kind == "join" and (self.op is not None
                                    or self.call is not None):
            raise ValueError(
                "join faults match train steps, not eager ops (no op=/call=)")
        if self.kind in _REGROW_KINDS and (self.op is not None
                                           or self.call is not None):
            raise ValueError(
                f"{self.kind} faults match regrow-phase attempts, not "
                "eager ops (no op=/call=)")
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {self.warmup}")
        if (self.step is None and self.call is None and self.p is None
                and self.op is None):
            raise ValueError(
                f"{self.kind} fault needs a trigger: step=, call=/op=, or p=")
        if self.p is not None and not (0.0 < self.p <= 1.0):
            raise ValueError(f"p must be in (0, 1], got {self.p}")

    @property
    def is_op_fault(self) -> bool:
        return self.op is not None or self.call is not None


class ChaosPlan:
    """A seeded, immutable fault list plus the mutable match counters."""

    def __init__(self, faults: List[Fault], seed: int = 0, zones: int = 1):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)
        self.zones = max(1, int(zones))
        for f in self.faults:
            if f.kind == "preempt" and f.zone is not None:
                if not (0 <= f.zone < self.zones):
                    raise ValueError(
                        f"preempt zone {f.zone} out of range for plan-level "
                        f"zones={self.zones} (add a 'zones=Z' clause)")
        self._op_calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- parsing ----------------------------------------------------------
    _INT_KEYS = ("step", "until", "call", "rank", "code", "warmup", "zone")
    _FLOAT_KEYS = ("t", "p", "grace", "regrant")

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Parse the ``BLUEFOG_CHAOS`` grammar (see module docstring)."""
        seed = 0
        zones = 1
        faults: List[Fault] = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if ":" not in clause:
                key, _, val = clause.partition("=")
                if key.strip() not in ("seed", "zones") or not val:
                    raise ValueError(
                        f"bad chaos clause {clause!r}: expected 'seed=N', "
                        "'zones=Z', or 'kind:key=value,...'")
                if key.strip() == "seed":
                    seed = int(val)
                else:
                    zones = int(val)
                continue
            kind, _, body = clause.partition(":")
            kw: dict = {}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                key, sep, val = item.partition("=")
                if not sep:
                    raise ValueError(
                        f"bad chaos parameter {item!r} in {clause!r} "
                        "(expected key=value)")
                key = key.strip()
                if key == "from":           # throttle window start
                    key = "step"
                if key in cls._INT_KEYS:
                    kw[key] = int(val)
                elif key in cls._FLOAT_KEYS:
                    kw[key] = float(val)
                elif key == "op":
                    kw[key] = val.strip()
                else:
                    raise ValueError(
                        f"unknown chaos parameter {key!r} in {clause!r}")
            faults.append(Fault(kind=kind.strip(), **kw))
        return cls(faults, seed=seed, zones=zones)

    # -- matching ---------------------------------------------------------
    def _draw(self, fault_index: int, fault: Fault, tick: int) -> bool:
        """Seed-derived Bernoulli draw — identical across ranks and reruns."""
        r = random.Random(
            f"{self.seed}:{fault_index}:{fault.kind}:{tick}").random()
        return r < fault.p  # type: ignore[operator]

    def match_regrow(self, phase: str, attempt: int) -> List[Fault]:
        """Regrow faults armed for this protocol phase + attempt.  The
        attempt counter plays the role ``step`` plays for train-step
        faults: ``kill_coordinator:step=1`` fires on the first attempt of
        a coordinator phase, ``hang_reinit:p=1.0,t=2`` wedges every
        re-init attempt until the deadline budget aborts the regrowth."""
        out = []
        for i, f in enumerate(self.faults):
            if f.kind not in _REGROW_KINDS:
                continue
            if phase not in _REGROW_PHASES[f.kind]:
                continue
            if f.step is not None and f.step == attempt:
                out.append(f)
            elif (f.step is None and f.p is not None
                  and self._draw(i, f, attempt)):
                out.append(f)
        return out

    def match_step(self, step: int) -> List[Fault]:
        out = []
        for i, f in enumerate(self.faults):
            if f.is_op_fault or f.kind in _REGROW_KINDS:
                continue
            if f.kind == "throttle":
                start = f.step if f.step is not None else 1
                if start <= step <= (f.until if f.until is not None
                                     else float("inf")):
                    out.append(f)
                continue
            if f.step is not None and f.step == step:
                out.append(f)
            elif f.step is None and f.p is not None and self._draw(i, f, step):
                out.append(f)
        return out

    def bump_op(self, op_name: str) -> int:
        with self._lock:
            n = self._op_calls.get(op_name, 0) + 1
            self._op_calls[op_name] = n
            return n

    def match_op(self, op_name: str, call: int) -> List[Fault]:
        out = []
        for i, f in enumerate(self.faults):
            if not f.is_op_fault:
                continue
            if f.op not in (None, "*", op_name):
                continue
            if f.call is not None and f.call != call:
                continue
            if f.call is None and f.p is not None:
                if not self._draw(i, f, call):
                    continue
            elif f.call is None and f.p is None:
                continue          # op= alone with neither call= nor p=
            out.append(f)
        return out


# ---------------------------------------------------------------------------
# Module plan slot (the zero-overhead gate: hook sites read this attribute)
# ---------------------------------------------------------------------------

_plan: Optional[ChaosPlan] = None


def install(plan) -> ChaosPlan:
    """Install a :class:`ChaosPlan` (or a grammar string) process-wide."""
    global _plan
    if isinstance(plan, str):
        plan = ChaosPlan.parse(plan)
    if not isinstance(plan, ChaosPlan):
        raise TypeError(f"expected ChaosPlan or spec string, got {plan!r}")
    _plan = plan
    return plan


def uninstall() -> None:
    global _plan
    _plan = None
    with _delay_lock:
        _step_delays.clear()


def active() -> bool:
    return _plan is not None


def current_plan() -> Optional[ChaosPlan]:
    return _plan


def maybe_install_from_env() -> bool:
    """Honor ``BLUEFOG_CHAOS`` at init (no-op when unset or already armed)."""
    spec = os.environ.get(ENV_VAR)
    if not spec or _plan is not None:
        return False
    install(spec)
    return True


# ---------------------------------------------------------------------------
# Telemetry (lazy imports: launcher children import this module cheaply)
# ---------------------------------------------------------------------------

def _record_fault(fault: Fault, site: str, dur_s: float = 0.0,
                  tick: Optional[int] = None,
                  rank: Optional[int] = None, **extra) -> None:
    try:
        from . import flight as _flight
        _flight.record("chaos", name=f"{fault.kind}:{site}", step=tick,
                       rank=fault.rank if rank is None else rank, t=fault.t,
                       **extra)
    except Exception:                                      # pragma: no cover
        pass
    try:
        from . import metrics as _metrics
        _metrics.counter(
            "bluefog_faults_injected_total",
            "chaos faults injected, by kind").inc(kind=fault.kind)
    except Exception:                                      # pragma: no cover
        return
    # a span only while a timeline is live (record_span is a no-op else)
    from . import timeline as _tl
    now_us = _tl._now_us()
    _tl.record_span(f"chaos:{site}", "FAULT",
                    now_us - dur_s * 1e6, max(dur_s * 1e6, 1.0))


def _context():
    """The live context when one is initialized (the module is imported
    only if something else loaded it), else None."""
    import sys as _sys
    mod = _sys.modules.get("bluefog_tpu_torch.parallel.context")
    if mod is None or not mod.is_initialized():
        return None
    return mod.get_context()


def _world_size() -> int:
    """Fleet size a zone maps onto: the live context's global rank count
    (1 before init)."""
    ctx = _context()
    return ctx.size if ctx is not None else 1


def _local_block() -> Optional[Tuple[int, int]]:
    """``(first_rank, rows)`` of this process when the ranks are split
    over several processes, else None (every rank lives here)."""
    ctx = _context()
    if ctx is None or ctx.world <= 1:
        return None
    return ctx.first_rank, ctx.rows


def _owns(rank: Optional[int]) -> bool:
    """Whether this process holds ``rank``'s row (an untargeted fault
    fires everywhere)."""
    block = _local_block()
    if block is None or rank is None:
        return True
    return block[0] <= rank < block[0] + block[1]


def _ambient_rank() -> Optional[int]:
    """This process's first rank when the ranks are split over several
    processes, else None (every rank lives here, so every fault fires
    in-process)."""
    block = _local_block()
    return None if block is None else block[0]


# Per-rank injected-delay ledger: hang/throttle sleeps attributed to their
# target rank since the last consume.  The straggler detector subtracts
# these from the host wall time to reconstruct per-rank step times of the
# stacked ranks (diagnostics.observe_step_time).
_delay_lock = threading.Lock()
_step_delays: Dict[int, float] = {}


def _attribute_delay(rank: Optional[int], seconds: float) -> None:
    if rank is None:
        rank = _ambient_rank() or 0
    with _delay_lock:
        _step_delays[rank] = _step_delays.get(rank, 0.0) + seconds


def consume_step_delays() -> Dict[int, float]:
    """Pop the per-rank injected sleep seconds accumulated since the last
    call (``{} `` when chaos injected nothing)."""
    with _delay_lock:
        out = dict(_step_delays)
        _step_delays.clear()
    return out


def _enact(fault: Fault, site: str, tick: int) -> None:
    """Apply a kill/hang/throttle fault (nan is handled by the corruptors).

    Rank-targeted faults are gated on the process's block of rows: across
    processes only the one holding the target rank enacts them.
    """
    if not _owns(fault.rank):
        return
    me = _ambient_rank()
    if fault.kind == "kill":
        _record_fault(fault, site, tick=tick)
        raise RankKilled(fault.rank, tick, fault.code)
    if fault.kind == "preempt":
        if fault.rank is not None:
            victims: Tuple[int, ...] = (fault.rank,)
        else:
            plan = _plan
            victims = zone_victims(fault.zone or 0, _world_size(),
                                   plan.zones if plan is not None else 1)
        if not any(_owns(v) for v in victims):
            return
        # advance notice first: a spot victim gets to flush telemetry
        # inside the grace window before the reclaim lands
        try:
            from . import flight as _flight
            _flight.record("preempt_notice", step=tick, zone=fault.zone,
                           grace=fault.grace, regrant=fault.regrant,
                           victims=list(victims))
        except Exception:                                  # pragma: no cover
            pass
        _record_fault(fault, site, tick=tick,
                      rank=me if me is not None else fault.rank,
                      zone=fault.zone, grace=fault.grace,
                      regrant=fault.regrant, victims=list(victims))
        code = (fault.code if fault.code != DEFAULT_KILL_CODE
                else DEFAULT_PREEMPT_CODE)
        raise RankPreempted(victims, tick, zone=fault.zone,
                            grace=fault.grace, regrant=fault.regrant,
                            code=code)
    if fault.kind in ("hang", "throttle"):
        _record_fault(fault, site, dur_s=fault.t, tick=tick)
        time.sleep(fault.t)
        _attribute_delay(fault.rank, fault.t)


# ---------------------------------------------------------------------------
# NaN corruption: rank r's row of every floating [rows, ...] tensor, in place
# ---------------------------------------------------------------------------

def _corrupt_distributed(x, rank: int):
    """NaN rank ``rank``'s row of a distributed tensor (leading rank axis
    of this process's rows), in place; other tensors pass untouched."""
    import torch
    ctx = _context()
    if ctx is None:
        return x
    if (not isinstance(x, torch.Tensor) or x.ndim < 1
            or x.shape[0] != ctx.rows or not x.is_floating_point()):
        return x
    row = int(rank) - (ctx.first_rank if ctx.world > 1 else 0)
    if 0 <= row < ctx.rows:
        with torch.no_grad():
            x[row].fill_(float("nan"))
    return x


def _corrupt_tree(tree, rank: int):
    from .snapshot import live_tensors
    for leaf in live_tensors(tree):
        _corrupt_distributed(leaf, rank)
    return tree


# ---------------------------------------------------------------------------
# Hook entry points (call sites gate on `_plan is not None` themselves)
# ---------------------------------------------------------------------------

def on_train_step(step: int) -> None:
    """Pre-dispatch train-step hook: may sleep (hang/throttle) or raise
    :class:`RankKilled`.  Called by ``optimizers._InstrumentedStep``."""
    plan = _plan
    if plan is None:
        return
    for f in plan.match_step(step):
        if f.kind not in ("nan", "join"):
            _enact(f, "train_step", step)


def corrupt_train_output(out, step: int):
    """Post-dispatch train-step hook: NaN-corrupt the target rank's row of
    the step outputs (the live state, updated in place by the step)."""
    plan = _plan
    if plan is None:
        return out
    for f in plan.match_step(step):
        if f.kind == "nan":
            _record_fault(f, "train_step")
            out = _corrupt_tree(out, f.rank)
    return out


def apply_membership(out, step: int):
    """Post-dispatch train-step hook: enact ``join`` faults through the real
    elastic-membership path (:func:`bluefog_tpu_torch.resilience.chaos_join` —
    neighbor-pull bootstrap of the step outputs, then admission).  Runs
    after :func:`corrupt_train_output` so a same-step NaN hits the
    pre-bootstrap state, exactly like production ordering."""
    plan = _plan
    if plan is None:
        return out
    for f in plan.match_step(step):
        if f.kind == "join":
            _record_fault(f, "train_step", tick=step)
            from .. import resilience as _rz
            out = _rz.chaos_join(out, f.rank, warmup_steps=f.warmup)
    return out


def on_eager_op(op_name: str, out):
    """Eager-dispatch hook (``api._dispatch`` / ``parallel.windows``' moves):
    counts this op's call, then kills / sleeps / corrupts per the plan."""
    plan = _plan
    if plan is None:
        return out
    call = plan.bump_op(op_name)
    for f in plan.match_op(op_name, call):
        if f.kind == "nan":
            _record_fault(f, op_name)
            out = _corrupt_tree(out, f.rank)
        else:
            _enact(f, op_name, call)
    return out


def on_regrow_phase(phase: str, attempt: int, *,
                    coordinator: Optional[int] = None,
                    joiners: Tuple[int, ...] = ()) -> None:
    """Mesh-regrowth protocol hook, for ``resilience.regrow_world`` at
    the top of every phase attempt (ROADMAP queue 1, item 10: nothing calls
    it until the context's ``reinit`` is ported).  May raise :class:`RankKilled` (``kill_coordinator`` /
    ``kill_joiner`` — the regrowth aborts and rolls back to the old world)
    or sleep (``hang_reinit`` — the phase deadline is the detector).

    ``kill_joiner`` without an explicit ``rank=`` kills the first joiner;
    with ``rank=`` it fires only when that rank is actually joining, so a
    plan written for one drill cannot stray into another."""
    plan = _plan
    if plan is None:
        return
    site = f"regrow_{phase}"
    for f in plan.match_regrow(phase, attempt):
        if f.kind == "kill_coordinator":
            victim = coordinator if f.rank is None else f.rank
            _record_fault(f, site, tick=attempt, rank=victim)
            raise RankKilled(victim, attempt, f.code)
        if f.kind == "kill_joiner":
            if f.rank is not None and f.rank not in joiners:
                continue
            victim = f.rank if f.rank is not None else (
                joiners[0] if joiners else None)
            _record_fault(f, site, tick=attempt, rank=victim)
            raise RankKilled(victim, attempt, f.code)
        if f.kind == "hang_reinit":
            _record_fault(f, site, dur_s=f.t, tick=attempt)
            time.sleep(f.t)
            _attribute_delay(f.rank, f.t)
