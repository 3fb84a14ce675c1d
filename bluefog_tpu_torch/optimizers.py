"""Decentralized optimizer strategies over stacked ranks (counterpart of
``bluefog_tpu/optimizers.py``).

Every parameter leaf is ``[n, ...]`` with the rank on dim 0, as in the JAX
API.  A strategy wraps a ``torch.optim`` optimizer over those stacked
tensors: Adam and SGD are elementwise, so one optimizer over the stack
updates every rank exactly as a per-rank optimizer would.  The
communicators apply the stacked collectives of
:mod:`bluefog_tpu_torch.ops.collectives` and the window ops of
:mod:`bluefog_tpu_torch.ops.windows`.

Under a composed carving (:mod:`bluefog_tpu_torch.parallel.compose`) the
``n`` rows are ``dp`` replicas of ``slice_size`` peers each, replica-major:
the gradient function runs once per replica on its ``[slice_size, ...]``
rows (:func:`stacked_grads`), and the gossip mixes the ``dp`` replicas
for each peer coordinate through a ``[dp, slice_size, ...]`` view.

==============================  ===========================================
strategy                        update
==============================  ===========================================
``gradient_allreduce``          x_{t+1} = A(x_t, mean_ranks(g_t))
``adapt_with_combine``          x_{t+1} = A(Comb(x_t), g(x_t)); with
                                ``delayed`` x_{t+1} = A(Comb(x_{t-1}), g(x_t))
``adapt_then_combine``          x_{t+1} = Comb(A(x_t, g_t))
``win_put_optimizer``           combine last step's mailboxes, put the
                                combined value to out-neighbors, adapt
``pull_get_optimizer``          fetch neighbors' current values, combine,
                                adapt
``push_sum``                    push-sum gossip of (x, p), adapt x / p
``choco_gossip``                adapt, then gossip compressed differences
                                against public copies (CHOCO-SGD)
``zero_gradient_allreduce``     ``gradient_allreduce`` with each rank's
                                optimizer state a 1/n shard (ZeRO-1)
``powersgd_allreduce``          ``gradient_allreduce`` of rank-r factors
                                with error feedback
``exact_diffusion``             psi = A(x, g); x+ = Comb(psi + x - psi_prev)
``gradient_tracking``           y+ = Comb(y) + g+ - g; x+ = Comb(A(x, y))
``push_diging``                 gradient tracking over push-sum weights
``async_window_gossip``         bounded-staleness push-sum window gossip
                                under a per-rank ``pace`` table
``zero_adapt_with_combine``     CTA gossip, then a ZeRO-1 adapt over an
                                orthogonal axis
==============================  ===========================================

:data:`STRATEGIES` names the strategies with their contract flags, and
:func:`strategy_constraint_violation` gives the reason a knob combination
breaks one.  :func:`make_train_step` and :func:`make_stateful_train_step`
return the step inside :class:`_InstrumentedStep`, which records every
call (flight events, metrics, a span when tracing is armed, the per-rank
step-time table) and, with ``metrics_every_k``, samples the consensus
probes of :mod:`bluefog_tpu_torch.diagnostics` on the step's output.

``Comb`` is a communicator: :func:`neighbor_communicator` (static, or
dynamic: schedule ``step % period``), :func:`hierarchical_communicator`,
:func:`allreduce_communicator` or :func:`empty_communicator`; the
reference's ``Distributed*Optimizer`` factories pick one by
``communication_type``.

``optimizer.step()`` updates ``p.data`` in place, so each update first
swaps the point the gradient is applied to into the optimizer's slots:
the combined params for CTA, the carried mixed params for delayed CTA,
the current params for ATC.  The step updates that point in place and
returns it as the new params (the JAX step donates its inputs the same
way), so a caller that needs the old params keeps a copy.

Strategy state starts from each rank's own params (a window's
mailboxes, CHOCO's public copies): with identical starts (the
:func:`replicate` flow) that is the JAX ``init_distributed`` state, which
broadcasts rank 0's.  :func:`state_from_jax` carries a JAX state over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fusion
from .fusion import tree_flatten, tree_map, tree_unflatten
from .ops import collectives as _coll
from .ops import windows as wops
from .parallel import context as _ctx
from .schedule import CommSchedule, compile_from_weights
from .utils import chaos as _chaos
from .utils import flight as _flight
from .utils import metrics as _metrics
from .utils import tracing as _tracing
from .utils import wire_bytes as _wb
from .utils.timeline import named_span

__all__ = ["neighbor_communicator", "hierarchical_communicator",
           "allreduce_communicator", "empty_communicator",
           "DecentralizedState", "DecentralizedOptimizer",
           "gradient_allreduce", "adapt_with_combine", "adapt_then_combine",
           "win_put_optimizer", "pull_get_optimizer", "push_sum",
           "push_schedule", "choco_gossip", "zero_gradient_allreduce",
           "powersgd_allreduce", "DistributedGradientAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedHierarchicalNeighborAllreduceOptimizer",
           "DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
           "DistributedPushSumOptimizer", "init_distributed",
           "make_train_step", "stacked_grads", "adam", "sgd",
           "replicate", "state_from_jax", "StackedAdam",
           "exact_diffusion", "gradient_tracking", "push_diging",
           "AsyncGossipState", "async_window_gossip",
           "AdaptiveStalenessController", "zero_adapt_with_combine",
           "StrategySpec", "STRATEGIES", "strategy_constraint_violation",
           "make_stateful_train_step"]

Communicator = Callable[[Any, int], Any]       # (params tree, step) -> tree
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


# ---------------------------------------------------------------------------
# Optimizer factories (the optax names and defaults)
# ---------------------------------------------------------------------------

class StackedAdam(torch.optim.Optimizer):
    """Adam over rank-stacked tensors with one step count per row (dim 0)
    of each tensor: optax's per-rank ``count``.  ``torch.optim.Adam``
    keeps one count a tensor, so a strategy that freezes some ranks'
    optimizer state (``async_window_gossip`` under a ``pace`` table) needs
    this one: each row's bias correction follows its own count.  The
    arithmetic is ``torch.optim.Adam``'s (``lerp`` of the first moment,
    ``sqrt(v) / sqrt(1 - b2^t) + eps``, the step ``lr / (1 - b1^t)``),
    with the corrections as per-row columns; half-precision tensors do
    it in float32 and store the result.  A 0-dim tensor is one row."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros(p.shape[:1], dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                t, m, v = st["step"], st["exp_avg"], st["exp_avg_sq"]
                t += 1
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                opm = (torch.float32 if p.dtype in (torch.bfloat16,
                                                    torch.float16)
                       else p.dtype)
                t64 = t.to(torch.float64)
                col = (t.shape[0],) + (1,) * (p.ndim - 1) if p.ndim else ()
                step_size = (lr / (1 - torch.pow(b1, t64))).reshape(col)
                bc2_sqrt = (1 - torch.pow(b2, t64)).sqrt().reshape(col)
                denom = (v.sqrt().to(opm) / bc2_sqrt.to(opm)).to(
                    p.dtype).add_(eps)
                p.copy_(p.to(opm) - m.to(opm) / denom.to(opm)
                        * step_size.to(opm))
        return None


def adam(learning_rate: float) -> OptimizerFactory:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8) as a
    :class:`StackedAdam` factory (a step count per rank, as optax's
    per-rank ``count``)."""
    return lambda params: StackedAdam(params, lr=learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8)


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> OptimizerFactory:
    """``optax.sgd(learning_rate, momentum, nesterov)`` as a
    ``torch.optim.SGD`` factory.

    optax's momentum is ``trace``: ``v <- g + momentum * v`` (from ``v =
    0``), then the update ``-lr * v``, or ``-lr * (g + momentum * v)``
    with ``nesterov``.  That is ``torch.optim.SGD(momentum=momentum,
    dampening=0)``, whose first step sets its buffer to ``g``.  Without
    ``momentum`` (optax's ``None``) ``nesterov`` does nothing, as in
    optax."""
    if momentum is None:
        return lambda params: torch.optim.SGD(params, lr=learning_rate)
    return lambda params: torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum, dampening=0.0,
        nesterov=nesterov)


# ---------------------------------------------------------------------------
# Communicators
# ---------------------------------------------------------------------------

def neighbor_communicator(
    schedule: Optional[CommSchedule] = None,
    schedules: Optional[Sequence[CommSchedule]] = None,
    *,
    fuse: bool = True,
    wire: Optional[str] = None,
    concurrent: Optional[bool] = None,
    slice_size: int = 1,
) -> Communicator:
    """Neighbor averaging of a stacked params tree under ``schedule``, or
    dynamic under ``schedules``: step ``t`` gossips over schedule ``t %
    period`` (the JAX ``lax.switch`` on the step counter).  ``fuse``
    gossips one ``[n, total]`` buffer per dtype instead of one gather
    chain per leaf; ``wire`` compresses the gossiped bytes (float leaves
    only; with ``fuse`` an int8/fp8 scale per rank's flat buffer).  With
    ``slice_size`` peers per replica the ``n = schedule.size *
    slice_size`` rows gossip over the replicas only, each peer coordinate
    with its own counterparts (``W (x) I_slice``), each peer encoding its
    own buffer."""
    if (schedule is None) == (schedules is None):
        raise ValueError("pass exactly one of schedule / schedules")
    if schedule is not None and schedule.num_rounds == 0:
        fuse = False     # degenerate topology: the op is elementwise

    def leaf(x, step):
        s = schedule if schedule is not None else \
            schedules[step % len(schedules)]
        # non-float leaves (int counters, complex) travel uncompressed
        w = wire if x.is_floating_point() else None
        # replica r's peers are rows r * slice_size ...: one row a replica
        view = (x.reshape(x.shape[0], -1) if slice_size == 1
                else x.reshape(x.shape[0] // slice_size, slice_size, -1))
        return _coll.neighbor_allreduce(
            view, s, wire=w, concurrent=concurrent,
            lead=1 if slice_size == 1 else 2).reshape(x.shape)

    def comm(params, step):
        with named_span("COMMUNICATE"):
            if fuse:
                return fusion.fused_leaf_op(lambda x: leaf(x, step))(params)
            return tree_map(lambda x: leaf(x, step), params)

    return comm


def hierarchical_communicator(
    machine_schedule: Optional[CommSchedule] = None,
    machine_schedules: Optional[Sequence[CommSchedule]] = None,
    *,
    fuse: bool = True,
    wire: Optional[str] = None,
    concurrent: Optional[bool] = None,
) -> Communicator:
    """Machine-level neighbor averaging (reference:
    ``DistributedHierarchicalNeighborAllreduceOptimizer``): the mean over
    each machine's ranks, then gossip over the machine schedule (dynamic
    under ``machine_schedules``).  ``wire`` compresses the machine edges
    only; None resolves to the process default (``set_dcn_wire`` /
    ``BLUEFOG_DCN_WIRE``) once, here, and ``"off"`` forces full width."""
    if (machine_schedule is None) == (machine_schedules is None):
        raise ValueError(
            "pass exactly one of machine_schedule / machine_schedules")
    if wire is None:
        wire = _coll._default_dcn_wire()
    elif wire == "off":
        wire = None

    def leaf(x, step):
        s = machine_schedule if machine_schedule is not None else \
            machine_schedules[step % len(machine_schedules)]
        w = wire if x.is_floating_point() else None
        return _coll.hierarchical_neighbor_allreduce(
            x, s, wire=w if w is not None else "off", concurrent=concurrent)

    def comm(params, step):
        with named_span("COMMUNICATE"):
            if fuse:
                return fusion.fused_leaf_op(lambda x: leaf(x, step))(params)
            return tree_map(lambda x: leaf(x, step), params)

    return comm


def allreduce_communicator() -> Communicator:
    """Global parameter averaging."""
    def comm(params, step):
        with named_span("COMMUNICATE"):
            return tree_map(_coll.allreduce, params)
    return comm


def empty_communicator() -> Communicator:
    """No communication."""
    return lambda params, step: params


def _every_k(comm: Communicator, k: int) -> Communicator:
    """Communicate every k-th step (reference: num_steps_per_communication)."""
    if k <= 1:
        return comm

    def wrapped(params, step):
        return comm(params, step) if (step + 1) % k == 0 else params
    return wrapped


# ---------------------------------------------------------------------------
# Strategy container
# ---------------------------------------------------------------------------

class DecentralizedState(NamedTuple):
    step: int
    opt_state: Any                # the torch.optim optimizer over the stack
    comm_state: Any = None        # delayed carry, windows, push-sum p, ...


class DecentralizedOptimizer(NamedTuple):
    """init(params) -> state;  update(grads, state, params) -> (params,
    state).  As in the JAX package, update returns the new parameters:
    gossip averaging is multiplicative in the parameters.  ``axes`` names
    the JAX mesh axes the update runs under: ``("rank",)``, or
    ``("machine", "local")`` for the hierarchical strategies (the stacked
    ranks are machine-major either way; the train step's probe reads
    it)."""
    init: Callable[[Any], DecentralizedState]
    update: Callable[[Any, DecentralizedState, Any],
                     Tuple[Any, DecentralizedState]]
    axes: Tuple[str, ...] = ("rank",)
    # True when comm_state carries the one-step-delayed mixed params
    pipelined: bool = False


def _make_optimizer(opt: OptimizerFactory, params) -> torch.optim.Optimizer:
    # slots share the params' storage; every update swaps its point in
    return opt([x.detach() for x in tree_flatten(params)[0]])


def _apply(optimizer: torch.optim.Optimizer, grads, point):
    """One optimizer step on ``point`` with ``grads``; updates ``point`` in
    place and returns it as the new params tree."""
    slots = optimizer.param_groups[0]["params"]
    xs, treedef = tree_flatten(point)
    gs = tree_flatten(grads)[0]
    with named_span("ADAPT"):
        for p, x, g in zip(slots, xs, gs):
            p.data = x
            p.grad = g
        optimizer.step()
        out = [p.data for p in slots]
        for p in slots:
            p.grad = None
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def gradient_allreduce(opt: OptimizerFactory, *,
                       fuse: bool = True) -> DecentralizedOptimizer:
    """Synchronous data parallelism: every rank adapts with the mean
    gradient."""
    def init(params):
        return DecentralizedState(0, _make_optimizer(opt, params))

    def update(grads, state, params):
        reduce_ = _coll.allreduce
        with named_span("COMMUNICATE"):
            grads = (fusion.fused_leaf_op(reduce_)(grads) if fuse
                     else tree_map(reduce_, grads))
        new_params = _apply(state.opt_state, grads, params)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update)


def adapt_with_combine(opt: OptimizerFactory, comm: Communicator, *,
                       num_steps_per_communication: int = 1,
                       delayed: bool = False,
                       axes: Tuple[str, ...] = ("rank",)
                       ) -> DecentralizedOptimizer:
    """Combine-then-adapt (CTA): x_{t+1} = A(Comb(x_t), g_t), the gradient
    taken at x_t applied to the combined point.  ``delayed=True`` is the
    pipelined variant x_{t+1} = A(Comb(x_{t-1}), g(x_t)): the gossip of
    step t rides in ``comm_state`` and step t+1 adapts on it; the first
    step adapts on the rank's own params."""
    if delayed and num_steps_per_communication != 1:
        raise ValueError(
            "delayed=True requires num_steps_per_communication == 1: the "
            "carried mixed params would be poisoned by raw params on "
            "non-communicating steps")
    comm = _every_k(comm, num_steps_per_communication)

    def init(params):
        carry = tree_map(torch.clone, params) if delayed else None
        return DecentralizedState(0, _make_optimizer(opt, params), carry)

    def update(grads, state, params):
        if delayed:
            mixed_next = comm(params, state.step)
            new_params = _apply(state.opt_state, grads, state.comm_state)
            return new_params, DecentralizedState(
                state.step + 1, state.opt_state, mixed_next)
        combined = comm(params, state.step)
        new_params = _apply(state.opt_state, grads, combined)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update, axes, pipelined=delayed)


def adapt_then_combine(opt: OptimizerFactory, comm: Communicator, *,
                       num_steps_per_communication: int = 1,
                       delayed: bool = False,
                       axes: Tuple[str, ...] = ("rank",)
                       ) -> DecentralizedOptimizer:
    """Adapt-then-combine (ATC): x_{t+1} = Comb(A(x_t, g_t))."""
    if delayed:
        raise ValueError(
            "adapt_then_combine cannot be pipelined: its gossip input IS "
            "the update output. Use adapt_with_combine(..., delayed=True) "
            "for one-step-delayed mixing")
    comm = _every_k(comm, num_steps_per_communication)

    def init(params):
        return DecentralizedState(0, _make_optimizer(opt, params))

    def update(grads, state, params):
        adapted = _apply(state.opt_state, grads, params)
        new_params = comm(adapted, state.step)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update, axes)


def _col(v, x: torch.Tensor) -> torch.Tensor:
    """A per-rank ``[n]`` tensor as a ``[n, 1, ...]`` column for x."""
    return v.reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def _values(params, fuse: bool):
    """The buffers a mailbox strategy gossips: one ``[n, total]`` buffer
    per dtype, or the leaves; plus the recipe that rebuilds the tree."""
    if fuse:
        ft = fusion.fuse_tree(params)
        return ft.buffers, ft
    leaves, treedef = tree_flatten(params)
    return leaves, treedef


def _rebuild(recipe, values):
    if isinstance(recipe, fusion.FusedTree):
        recipe.buffers = list(values)
        return recipe.unfuse()
    return tree_unflatten(recipe, list(values))


def _mailbox_optimizer(opt: OptimizerFactory, sched: Optional[CommSchedule],
                       leaf_comm, *, num_steps_per_communication: int,
                       fuse: bool, carry_windows: bool
                       ) -> DecentralizedOptimizer:
    """Shared scaffold of the window (mailbox) strategies.
    ``leaf_comm(s, window, x) -> Window`` is one buffer's gossip round;
    ``carry_windows`` keeps the mailboxes in ``comm_state`` across steps
    (push reads last step's deliveries) or rebuilds them in each
    communication (a pull overwrites them before reading).  The carried
    window's value aliases the combined point, which the adapt updates in
    place; the next round replaces it with the then-current params, so
    only the mailboxes carry over."""
    k = num_steps_per_communication

    def _sched():
        return sched if sched is not None else _ctx.static_schedule()

    def init(params):
        windows = ([wops.win_create(x, _sched(), zero_init=False)
                    for x in _values(params, fuse)[0]]
                   if carry_windows else None)
        return DecentralizedState(0, _make_optimizer(opt, params), windows)

    def update(grads, state, params):
        s = _sched()
        values, recipe = _values(params, fuse)
        windows = state.comm_state
        if k <= 1 or (state.step + 1) % k == 0:
            with named_span("COMMUNICATE"):
                if carry_windows:
                    new_windows = [leaf_comm(s, w, x)
                                   for w, x in zip(windows, values)]
                else:
                    new_windows = [leaf_comm(s, wops.win_create(x, s), x)
                                   for x in values]
            values = [w.value for w in new_windows]
            windows = new_windows if carry_windows else None
        new_params = _apply(state.opt_state, grads, _rebuild(recipe, values))
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state, windows)

    return DecentralizedOptimizer(init, update)


def win_put_optimizer(opt: OptimizerFactory,
                      sched: Optional[CommSchedule] = None, *,
                      num_steps_per_communication: int = 1,
                      fuse: bool = True, wire: Optional[str] = None
                      ) -> DecentralizedOptimizer:
    """Mailbox gossip (reference: ``DistributedWinPutOptimizer``): combine
    the current value with the mailboxes the in-neighbors put LAST step,
    put the combined value to the out-neighbors (``wire`` compresses the
    put; the local combine stays full precision), adapt.  The mailboxes
    ride ``comm_state``; ``fuse`` keeps one window per dtype buffer."""
    def leaf(s, w, x):
        w = wops.Window(value=x, recv=w.recv)
        value, w = wops.win_update(w, s)
        return wops.win_put(w, value, s, wire=wire)

    return _mailbox_optimizer(
        opt, sched, leaf,
        num_steps_per_communication=num_steps_per_communication,
        fuse=fuse, carry_windows=True)


def pull_get_optimizer(opt: OptimizerFactory,
                       sched: Optional[CommSchedule] = None, *,
                       num_steps_per_communication: int = 1,
                       fuse: bool = True, wire: Optional[str] = None
                       ) -> DecentralizedOptimizer:
    """Pull-based gossip (reference: ``DistributedPullGetOptimizer``):
    fetch the in-neighbors' CURRENT params into fresh mailboxes (zero
    steps stale, so it coincides with combine-then-adapt), combine,
    adapt.  The mailboxes are rebuilt each communication."""
    def leaf(s, w, x):
        w = wops.win_get(w, s, wire=wire)
        _, w = wops.win_update(w, s)
        return w

    return _mailbox_optimizer(
        opt, sched, leaf,
        num_steps_per_communication=num_steps_per_communication,
        fuse=fuse, carry_windows=False)


def push_sum(opt: OptimizerFactory, sched: Optional[CommSchedule] = None,
             *, self_weight: Optional[float] = None,
             dst_weight: Optional[float] = None,
             fuse: bool = True) -> DecentralizedOptimizer:
    """Stochastic gradient push (reference:
    ``DistributedPushSumOptimizer``): every buffer carries a scalar p per
    rank (from 1); each step a rank keeps ``1/(outdeg+1)`` of ``(x, p)``
    and accumulates the same share into each out-neighbor's mailbox, then
    collects its mailboxes.  The adapt runs on the de-biased ``x / p``,
    and the result is re-biased into the gossip channel so ``sum_r x_r =
    sum_r p_r z_r`` keeps holding."""
    def _sched():
        s = sched if sched is not None else _ctx.static_schedule()
        if s.uses_dst_weighting:
            raise ValueError(
                "push_sum requires a schedule without dst-weighting "
                "(uses_dst_weighting=False); pass dst_weight= instead")
        return s

    def init(params):
        s = _sched()
        vals = _values(params, fuse)[0]
        windows = [wops.win_create(x, s, zero_init=True) for x in vals]
        p_windows = [wops.win_create(
            torch.ones(x.shape[0], dtype=x.dtype, device=x.device), s,
            zero_init=True) for x in vals]
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  (windows, p_windows))

    def update(grads, state, params):
        s = _sched()
        sw = (1.0 / (s.out_degree + 1.0)) if self_weight is None \
            else np.full(s.size, self_weight)
        dw = sw if dst_weight is None else np.full(s.size, dst_weight)
        windows, p_windows = state.comm_state
        recipe = _values(params, fuse)[1]

        def gossip(w):
            x = w.value
            w = wops.win_accumulate(w, x * _coll._table(dw, x), s)
            w = wops.Window(value=x * _coll._table(sw, x), recv=w.recv)
            return wops.win_update_then_collect(w, s)[1]

        windows = [gossip(w) for w in windows]
        p_windows = [gossip(w) for w in p_windows]
        p_new = [w.value for w in p_windows]
        debiased = [w.value / _col(p, w.value)
                    for w, p in zip(windows, p_new)]
        new_params = _apply(state.opt_state, grads,
                            _rebuild(recipe, debiased))
        adapted = _values(new_params, fuse)[0]
        windows = [wops.Window(value=a * _col(p, a), recv=w.recv)
                   for w, a, p in zip(windows, adapted, p_new)]
        return new_params, DecentralizedState(
            state.step + 1, state.opt_state, (windows, p_windows))

    return DecentralizedOptimizer(init, update)


def choco_gossip(opt: OptimizerFactory, sched: Optional[CommSchedule] = None,
                 *, wire: str = "int8", gamma: float = 1.0
                 ) -> DecentralizedOptimizer:
    """CHOCO-SGD: error-compensated *compressed* gossip (Koloskova et al.,
    2019).  Each rank gossips the compressed difference to a public copy,
    so the quantization error is fed back and decays::

        x_half = A(x_t, g_t)
        q_i    = Q(x_half_i - xhat_i)
        xhat_i += deq(q_i);  s_i += w_ii deq(q_i) + sum_j w_ij deq(q_j)
        x_{t+1} = x_half + gamma (s_i - xhat_i)

    ``comm_state`` holds ``(xhat, s)`` as fused per-dtype buffers.
    Assumes identical initial params across the ranks."""
    def _scheds():
        s = sched if sched is not None else _ctx.static_schedule()
        if s.uses_dst_weighting and _coll._parse_wire(wire)[0] not in (
                "int8", "fp8"):
            # the s-tracking invariant needs deq(Q(.)) to commute with the
            # sender-side dst scaling: the amax-scaled quantizers do, a
            # bf16 cast does not
            raise ValueError(
                "choco_gossip with a dst-weighted schedule "
                "(uses_dst_weighting=True) requires wire='int8' or "
                f"'fp8'; wire={wire!r} does not commute with send scaling")
        # zero-self variant: the rounds carry the neighbors' diffs only
        s0 = dataclasses.replace(s, self_weight=np.zeros_like(s.self_weight),
                                 key="")
        return s, s0

    def init(params):
        _scheds()                     # fail fast on wire/schedule mismatch
        bufs = [b.clone() for b in fusion.fuse_tree(params).buffers]
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  (bufs, [b.clone() for b in bufs]))

    def update(grads, state, params):
        s_full, s_zero = _scheds()
        xhat, sbufs = state.comm_state
        half = _apply(state.opt_state, grads, params)
        fp = fusion.fuse_tree(half)
        new_bufs, new_xhat, new_s = [], [], []
        for buf, xh, sb in zip(fp.buffers, xhat, sbufs):
            diff = buf - xh
            qd = _coll._wire_decode(wire, _coll._wire_encode(wire, diff, 1),
                                    buf.dtype, shape=diff.shape, lead=1)
            recv = _coll.neighbor_allreduce(diff, s_zero, wire=wire)
            xh2 = xh + qd
            sb2 = sb + qd * _coll._table(s_full.self_weight, buf) + recv
            new_bufs.append(buf + torch.tensor(gamma, dtype=buf.dtype)
                            * (sb2 - xh2))
            new_xhat.append(xh2)
            new_s.append(sb2)
        fp.buffers = new_bufs
        return fp.unfuse(), DecentralizedState(
            state.step + 1, state.opt_state, (new_xhat, new_s))

    return DecentralizedOptimizer(init, update)


def push_schedule(topo=None, size: Optional[int] = None) -> CommSchedule:
    """Column-stochastic push schedule: sender j keeps and sends
    ``1/(outdeg_j + 1)`` of its mass on every out-edge."""
    from . import topology as _topo
    if topo is None:
        topo = _ctx.load_topology()
    n = size if size is not None else topo.number_of_nodes()
    keep = [1.0 / (len(_topo.GetOutNeighbors(topo, r)) + 1.0)
            for r in range(n)]
    src = [{s: keep[s] for s in _topo.GetInNeighbors(topo, r)}
           for r in range(n)]
    return compile_from_weights(n, keep, src)


# ---------------------------------------------------------------------------
# Gradient tracking family
# ---------------------------------------------------------------------------

def _update_only(optimizer: torch.optim.Optimizer, grads, like):
    """The optimizer's update for ``grads`` (optax's ``updates``), as a
    tree like ``like``: one step on a zero point.  SGD, momentum and Adam
    step ``0 + u``, which is ``u`` exactly."""
    return _apply(optimizer, grads, tree_map(torch.zeros_like, like))


def exact_diffusion(opt: OptimizerFactory, comm: Communicator, *,
                    axes: Tuple[str, ...] = ("rank",)
                    ) -> DecentralizedOptimizer:
    """Exact diffusion: bias-corrected CTA gossip (Yuan et al.)::

        psi_t   = A(x_t, g_t)
        x_{t+1} = Comb(psi_t + x_t - psi_{t-1})

    ``comm_state`` carries psi_{t-1} (from x_0)."""
    def init(params):
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  tree_map(torch.clone, params))

    def update(grads, state, params):
        psi_prev = state.comm_state
        # the adapt steps its point in place: psi on a copy of x_t
        psi = _apply(state.opt_state, grads, tree_map(torch.clone, params))
        phi = tree_map(lambda a, b, c: a + b - c, psi, params, psi_prev)
        new_params = comm(phi, state.step)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state, psi)

    return DecentralizedOptimizer(init, update, axes)


def gradient_tracking(opt: OptimizerFactory, comm: Communicator, *,
                      axes: Tuple[str, ...] = ("rank",)
                      ) -> DecentralizedOptimizer:
    """Gradient tracking: every rank tracks the global mean gradient::

        y_{t+1} = Comb(y_t) + g_{t+1} - g_t
        x_{t+1} = Comb(A(x_t, y_t))

    so ``sum_r y_r == sum_r g_r`` at every step.  ``comm_state`` carries
    ``(y, g_prev)``, both from zeros (``y_0 = g_0`` on the first
    update)."""
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  (zeros, zeros))

    def update(grads, state, params):
        y, g_prev = state.comm_state
        y = comm(y, state.step)
        y = tree_map(lambda a, g, gp: a + g - gp, y, grads, g_prev)
        adapted = _apply(state.opt_state, y, params)
        new_params = comm(adapted, state.step)
        return new_params, DecentralizedState(
            state.step + 1, state.opt_state, (y, grads))

    return DecentralizedOptimizer(init, update, axes)


def push_diging(opt: OptimizerFactory, sched: Optional[CommSchedule] = None,
                *, axes: Tuple[str, ...] = ("rank",),
                fuse: bool = True) -> DecentralizedOptimizer:
    """Push-DIGing: gradient tracking on directed graphs through push-sum
    (Nedic et al.).  Over column-stochastic push weights ``C``
    (:func:`push_schedule` by default)::

        y_t     = C(y_{t-1}) + g(z_t) - g(z_{t-1})     (tracker)
        u_{t+1} = C(u_t + A(y_t))                      (push mixing)
        p_{t+1} = C(p_t)
        z_{t+1} = u_{t+1} / p_{t+1}                    (the params)

    ``A(y)`` is the optimizer's update (:func:`_update_only`).
    ``comm_state`` holds ``(u, p, y, g_prev)``; with ``fuse`` ``u`` is the
    per-dtype buffers and ``p`` one ``[n]`` mass a buffer."""
    def _sched():
        return sched if sched is not None else push_schedule()

    def _bufs(tree):
        return fusion.fuse_tree(tree).buffers if fuse else tree

    def init(params):
        u0 = _bufs(tree_map(torch.clone, params))
        p0 = tree_map(lambda x: torch.ones(x.shape[0], dtype=x.dtype,
                                           device=x.device), u0)
        zeros = tree_map(torch.zeros_like, params)
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  (u0, p0, zeros, zeros))

    def update(grads, state, params):
        s = _sched()
        u, p, y, g_prev = state.comm_state

        def nar(t):
            return tree_map(lambda x: _coll.neighbor_allreduce(x, s), t)

        y = nar(y)
        y = tree_map(lambda a, g, gp: a + g - gp, y, grads, g_prev)
        step_tree = _bufs(_update_only(state.opt_state, y, params))
        u = nar(tree_map(torch.add, u, step_tree))
        p = nar(p)
        z = tree_map(lambda a, b: a / _col(b, a), u, p)
        if fuse:
            recipe = fusion.fuse_tree(params)
            recipe.buffers = z
            z = recipe.unfuse()
        return z, DecentralizedState(state.step + 1, state.opt_state,
                                     (u, p, y, grads))

    return DecentralizedOptimizer(init, update, axes)


# ---------------------------------------------------------------------------
# Bounded-staleness asynchronous window gossip
# ---------------------------------------------------------------------------

class AsyncGossipState(NamedTuple):
    """Carry of :func:`async_window_gossip`, each field stacked over the
    ranks: ``recv`` one ``[n, K, ...]`` mailbox block a gossiped buffer;
    ``p`` / ``p_recv`` the push-sum mass lane (``[n]`` f32, one mass for
    the whole model, and its ``[n, K]`` mailboxes); ``stamps`` ``[n, K]``
    int32 per-slot step stamps; ``local_steps`` ``[n]`` the ticks each
    rank worked; ``force`` ``[n]`` bool, the fleet-wide sync-up flag for
    the next tick; ``depth`` ``[n]`` int32, last tick's staleness depth
    (what :func:`bluefog_tpu_torch.diagnostics.observe_async_staleness`
    reads)."""
    recv: Any
    p: torch.Tensor
    p_recv: torch.Tensor
    stamps: torch.Tensor
    local_steps: torch.Tensor
    force: torch.Tensor
    depth: torch.Tensor


def _opt_snapshot(optimizer: torch.optim.Optimizer):
    """Copies of every tensor of the optimizer's per-slot state."""
    return {id(p): {k: v.clone() for k, v in optimizer.state[p].items()
                    if torch.is_tensor(v)}
            for p in optimizer.param_groups[0]["params"]}


def _freeze_rows(optimizer: torch.optim.Optimizer, before, keep_new):
    """Put back the rows (dim 0) where ``keep_new`` is False in every state
    tensor of the optimizer: an inactive rank's state is its state before
    the step, zeros where the step created it (optax's state starts at
    zeros; torch's optimizers create theirs at the first step)."""
    for p in optimizer.param_groups[0]["params"]:
        old = before[id(p)]
        st = optimizer.state[p]
        for k, v in list(st.items()):
            if not torch.is_tensor(v) or v.ndim < 1 or \
                    v.shape[0] != keep_new.shape[0]:
                continue
            prev = old.get(k)
            if prev is None:
                prev = torch.zeros_like(v)
            st[k] = torch.where(_col(keep_new, v), v, prev)


def async_window_gossip(opt: OptimizerFactory,
                        sched: Optional[CommSchedule] = None, *,
                        staleness_bound: Optional[int] = None,
                        pace: Optional[Sequence[int]] = None,
                        fuse: bool = True, wire: Optional[str] = None
                        ) -> DecentralizedOptimizer:
    """Bounded-staleness asynchronous window gossip (JAX
    ``optimizers.py:715``): every rank pushes ``1/(outdeg+1)`` of its mass
    into its out-neighbors' mailboxes (``win_accumulate``, through
    ``wire``) and folds in whatever has arrived.  A static per-rank
    ``pace`` table marks rank r *active* on ticks where ``tick % pace[r]
    == 0``; an inactive rank neither pushes, collects nor adapts (its
    mailboxes keep accumulating), and its params and optimizer state
    stay bit-identical (:func:`_freeze_rows`; Adam needs
    :class:`StackedAdam`'s per-row counts for that).

    The push-sum mass ``p`` travels through the same mailboxes with the
    same activity (and no wire codec: a quantized ``p`` would bias the
    correction it exists for), so every tick's mixing over the extended
    state is column-stochastic for any activity
    (:func:`bluefog_tpu_torch.ops.windows.async_mixing_matrices`), and
    the params carry the de-biased ``z = x / p``.

    The staleness bound K (``staleness_bound``, else
    :func:`bluefog_tpu_torch.parallel.context.async_gossip_bound`): each
    slot's step stamp tracks its in-neighbor's latest delivery; when any
    rank's staleness depth exceeds K (a MAX over every rank, through the
    process group across processes) the whole fleet is forced active on
    the next tick.  ``K = 0`` makes every tick active: synchronous
    combine-then-adapt on the push weights."""
    def _sched():
        s = sched if sched is not None else _ctx.static_schedule()
        if s.uses_dst_weighting:
            raise ValueError(
                "async_window_gossip requires column-stochastic push "
                "weights (push_schedule), not a dst-weighted schedule")
        return s

    def _bound() -> int:
        if staleness_bound is not None:
            b = int(staleness_bound)
        else:
            b = _ctx.async_gossip_bound()
        if b < 0:
            raise ValueError(f"staleness_bound must be >= 0, got {b}")
        return b

    def _pace(n: int) -> np.ndarray:
        if pace is None:
            return np.ones(n, np.int32)
        tab = np.asarray(pace, np.int32)
        if tab.shape != (n,) or (tab < 1).any():
            raise ValueError(
                f"pace must be {n} ints >= 1, got {np.asarray(pace)!r}")
        return tab

    def init(params):
        s = _sched()
        _bound()                         # fail fast on a bad knob
        K = max(s.max_in_degree, 1)
        vals = _values(params, fuse)[0]
        rows, dev = vals[0].shape[0], vals[0].device
        recv = [torch.zeros((rows, K) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=dev) for x in vals]
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  AsyncGossipState(
            recv=recv,
            p=torch.ones(rows, dtype=torch.float32, device=dev),
            p_recv=torch.zeros((rows, K), dtype=torch.float32, device=dev),
            stamps=wops.stamp_create(s, rows, dev),
            local_steps=torch.zeros(rows, dtype=torch.int32, device=dev),
            force=torch.zeros(rows, dtype=torch.bool, device=dev),
            depth=torch.zeros(rows, dtype=torch.int32, device=dev)))

    def update(grads, state, params):
        s = _sched()
        bound = _bound()
        cs: AsyncGossipState = state.comm_state
        tick = state.step
        z_vals, recipe = _values(params, fuse)
        rows, dev = z_vals[0].shape[0], z_vals[0].device
        deg = _coll._local(s.out_degree, rows).astype(np.float32)
        sw = torch.as_tensor(np.float32(1.0) / (deg + np.float32(1.0)),
                             device=dev)                     # f32, as JAX
        if bound == 0:
            active = torch.ones(rows, dtype=torch.bool, device=dev)
        else:
            scheduled = torch.as_tensor(
                _coll._local(tick % _pace(s.size) == 0, rows), device=dev)
            active = scheduled | cs.force
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        send_w = torch.where(active, sw, zero)
        keep_w = torch.where(active, sw, torch.ones_like(sw))
        p = cs.p

        def slot_sum(recv):
            total = recv[:, 0]
            for k in range(1, recv.shape[1]):
                total = total + recv[:, k]
            return total

        def gossip(z, recv):
            # rebias z -> x = z p, push 1/(outdeg+1) of x along the
            # out-edges; if active, keep the same share and fold in every
            # mailbox (the slots past in_degree never receive: zeros)
            dt = z.dtype
            x = z * _col(p.to(dt), z)
            w = wops.win_accumulate(wops.Window(value=x, recv=recv),
                                    x * _col(send_w.to(dt), x), s, wire=wire)
            mailbox = slot_sum(w.recv.to(dt))
            act = _col(active, x)
            mixed = (_col(keep_w.to(dt), x) * x
                     + torch.where(act, mailbox, torch.zeros_like(mailbox)))
            new_recv = torch.where(_col(active, w.recv),
                                   torch.zeros_like(w.recv), w.recv)
            return mixed, new_recv

        moved = [gossip(z, r) for z, r in zip(z_vals, cs.recv)]
        mixed_vals = [m for m, _ in moved]
        new_recv = [r for _, r in moved]
        pwin = wops.win_accumulate(wops.Window(value=p, recv=cs.p_recv),
                                   p * send_w, s)
        p_mixed = torch.where(active, sw * p + slot_sum(pwin.recv), p)
        new_p_recv = torch.where(active[:, None],
                                 torch.zeros_like(pwin.recv), pwin.recv)
        stamps = wops.stamp_push(cs.stamps, tick, active, s)
        depth = wops.staleness_depth(stamps, tick, s)
        if bound == 0:
            force_next = torch.zeros(rows, dtype=torch.bool, device=dev)
        else:
            force_next = (_coll.rank_max(depth) > bound).expand(rows)
        z_tree = _rebuild(recipe, [m / _col(p_mixed.to(m.dtype), m)
                                   for m in mixed_vals])
        before = _opt_snapshot(state.opt_state)
        adapted = _apply(state.opt_state, grads, z_tree)
        # an inactive rank is mid-local-compute: no adapt lands, its
        # params and optimizer state stay as they were
        _freeze_rows(state.opt_state, before, active)
        new_params = tree_map(lambda a, o: torch.where(_col(active, a), a, o),
                              adapted, params)
        return new_params, DecentralizedState(
            state.step + 1, state.opt_state,
            AsyncGossipState(
                recv=new_recv, p=p_mixed, p_recv=new_p_recv, stamps=stamps,
                local_steps=cs.local_steps + active.to(torch.int32),
                force=force_next.contiguous(), depth=depth))

    return DecentralizedOptimizer(init, update)


class AdaptiveStalenessController:
    """Learn the async staleness bound K online from the per-rank
    step-time table (:func:`bluefog_tpu_torch.diagnostics.
    observe_step_time` / ``last_step_times``).

    A rank running at ``r x`` the alive-median pace needs its neighbors to
    tolerate ``ceil(r) - 1`` missed ticks before a forced sync-up, so
    ``K = clamp(ceil(max_alive / median) - 1, k_min, k_max)``.  A change
    is applied (:func:`bluefog_tpu_torch.parallel.context.
    set_async_gossip`) only after the same recommendation holds
    ``patience`` observations in a row; :meth:`observe` then returns it
    and the caller rebuilds its strategy and step.  The change sets the
    ``bluefog_async_staleness_bound`` gauge and records an
    ``async_bound`` flight event."""

    def __init__(self, *, k_min: int = 0, k_max: int = 16,
                 patience: int = 3, dead_ranks: Sequence[int] = ()):
        if not (0 <= k_min <= k_max):
            raise ValueError(
                f"need 0 <= k_min <= k_max, got {k_min}..{k_max}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.patience = int(patience)
        self.dead_ranks = frozenset(int(r) for r in dead_ranks)
        self._candidate: Optional[int] = None
        self._streak = 0
        self.applied: Optional[int] = None

    @property
    def current_bound(self) -> int:
        return _ctx.async_gossip_bound()

    def recommend(self, step_times: Optional[Sequence[float]] = None
                  ) -> Optional[int]:
        """The bound the current pace spread calls for (no side effects);
        None when no step-time table has been observed yet."""
        from . import diagnostics as _diag
        t = (np.asarray(step_times, np.float64).reshape(-1)
             if step_times is not None else _diag.last_step_times())
        if t is None or np.size(t) == 0:
            return None
        t = np.asarray(t, np.float64).reshape(-1)
        alive = [r for r in range(t.size)
                 if r not in self.dead_ranks and np.isfinite(t[r])]
        if not alive:
            return None
        med = float(np.median(t[alive]))
        if med <= 0:
            return None
        spread = float(np.max(t[alive])) / med
        k = int(np.ceil(spread)) - 1
        return max(self.k_min, min(self.k_max, k))

    def observe(self, step_times: Optional[Sequence[float]] = None
                ) -> Optional[int]:
        """Fold one pace observation in; the newly applied bound when the
        hysteresis window agrees on a change, else None."""
        rec = self.recommend(step_times)
        if rec is None or rec == self.current_bound:
            self._candidate, self._streak = None, 0
            return None
        if rec == self._candidate:
            self._streak += 1
        else:
            self._candidate, self._streak = rec, 1
        if self._streak < self.patience:
            return None
        old = self.current_bound
        self._candidate, self._streak = None, 0
        _ctx.set_async_gossip(rec)
        _metrics.mark_steady_state(False)
        self.applied = rec
        _metrics.gauge(
            "bluefog_async_staleness_bound",
            "async gossip staleness bound K (pace-adaptive)").set(rec)
        _flight.record("async_bound", old=old, new=rec,
                       reason="pace_adaptive")
        return rec


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def _zero_axis_size(axis: str) -> int:
    """Size of a rank axis by name from the live context."""
    if axis == "rank":
        return _ctx.size()
    if axis == "local":
        return _ctx.local_size()
    if axis == "machine":
        return _ctx.machine_size()
    raise ValueError(f"unknown mesh axis {axis!r}")


def _zero_shard_templates(params, n: int):
    """Zero-filled ``[ranks, shard]`` templates, one per dtype bucket: the
    optimizer's slots (each rank's row is its 1/n shard)."""
    out = []
    for buf in fusion.fuse_tree(params).buffers:
        T = buf.shape[1]
        out.append(torch.zeros((buf.shape[0], (T + (-T) % n) // n),
                               dtype=buf.dtype, device=buf.device))
    return out


def _zero_rounds(axis: str, n: int, L: int) -> Tuple[np.ndarray, list]:
    """Each rank's member index in its group along ``axis`` (all the
    ranks; a machine's local ranks; the ranks of one local index across
    machines), and the ``n`` rounds of a rotation inside every group
    (round ``k``: each member receives from the member ``k`` after it),
    as global ``_permute`` tables.  The reduce-scatter and the all-gather
    of ZeRO-1 are these rounds: every row that moves between ranks goes
    through ``_permute_rounds``."""
    N = _ctx.size()
    ranks = np.arange(N)
    members = ranks[None] if axis == "rank" else ranks.reshape(N // L, L)
    if axis == "machine":
        members = members.T                            # [groups, n]
    member = np.empty(N, dtype=np.int64)
    group = np.empty(N, dtype=np.int64)
    for g, row in enumerate(members):
        member[row] = np.arange(n)
        group[row] = g
    rounds = [members[group, (member + k) % n] for k in range(n)]
    return member, rounds


def _zero_apply(optimizer, grads, params, axis: str, n: int, L: int):
    """ZeRO-1 sharded adapt over stacked ranks: the reduce-scatter (the
    group's mean gradient, member j keeping shard j, the members' shards
    added in member order), the step of each rank's shard of its params
    with its shard of the optimizer state, and the all-gather of the
    updated shards.  Each move is the rotation rounds of
    :func:`_zero_rounds` at once (across processes, one message a
    process pair)."""
    grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
    fg = fusion.fuse_tree(grads)
    fp = fusion.fuse_tree(params)
    if not fg.buffers:
        return fp.unfuse()
    rows = fg.buffers[0].shape[0]
    if _coll._procs()[0] > 1 and axis == "local" and rows % L:
        raise ValueError(
            f"zero_gradient_allreduce(axis='local'): a machine of {L} ranks "
            "spans processes; its group stays inside one process (ROADMAP "
            "queue 1, item 12)")
    member, rounds = _zero_rounds(axis, n, L)
    mine = _coll._local(member, rows)
    dev = fg.buffers[0].device
    ar = torch.arange(rows, device=dev)

    def by_member(got, m):
        """Each row's piece from member ``m`` of the rounds' ``got``."""
        return got[torch.as_tensor((m - mine) % n, device=dev), ar]

    g_shards, p_shards, pads = [], [], []
    for gbuf, pbuf in zip(fg.buffers, fp.buffers):
        pad = (-gbuf.shape[1]) % n
        gv = torch.nn.functional.pad(gbuf, (0, pad)).view(rows, n, -1)
        pv = torch.nn.functional.pad(pbuf, (0, pad)).view(rows, n, -1)
        # round k: member m gets member m + k's shard m
        got = torch.stack(_coll._permute_rounds(
            [gv[ar, torch.as_tensor((mine - k) % n, device=dev)]
             for k in range(n)], rounds))
        total = by_member(got, 0)
        for m in range(1, n):
            total = total + by_member(got, m)
        if total.is_floating_point():
            total = total / n                 # the mean, as pmean
        g_shards.append(total)
        p_shards.append(pv[ar, torch.as_tensor(mine, device=dev)])
        pads.append(pad)
    new_shards = _apply(optimizer, g_shards, p_shards)
    bufs = []
    for sh, pad in zip(new_shards, pads):
        got = torch.stack(_coll._permute_rounds([sh] * n, rounds))
        full = torch.stack([by_member(got, m) for m in range(n)],
                           dim=1).reshape(rows, -1)
        bufs.append((full[:, :full.shape[1] - pad] if pad else full)
                    .contiguous())
    fp.buffers = bufs
    return fp.unfuse()


def _check_elementwise_chain(opt: OptimizerFactory, n_probe: int = 2
                             ) -> None:
    """Best-effort tripwire for the ZeRO elementwise requirement: one
    step of ``opt`` on a small structured tree, and one on the emulated
    ZeRO shard buffers (each dtype bucket padded and split across
    ``n_probe`` ranks, one optimizer each), at gradient scales x1, x100
    and x0.01; raises if the new parameters differ.

    The JAX probe runs an optax chain.  Here ``opt`` is a ``torch.optim``
    factory: the optimizer steps each tensor it is given, so SGD,
    momentum, Adam and AdamW are elementwise and pass bit for bit, while
    one whose ``step()`` couples elements (a global-norm clip, per-tensor
    trust ratios as in LARS / LAMB) sees per-shard buffers under ZeRO and
    is caught here when a probe scale engages it."""
    tree_p = {"a": torch.tensor([0.3, -0.4, 0.5]),
              "b": torch.tensor([[2.0, -1.0], [0.5, 3.0]])}
    base_g = {"a": torch.tensor([0.1, 0.2, -0.3]),
              "b": torch.tensor([[-1.0, 0.4], [0.2, 2.0]])}

    def one_step(params, grads):
        slots = [p.clone() for p in params]
        o = opt(slots)
        for p, g in zip(slots, grads):
            p.grad = g.clone()
        o.step()
        return [p.detach() for p in slots]

    why = None
    try:
        for scale in (1.0, 100.0, 0.01):
            names = sorted(tree_p)
            ps = [tree_p[k] for k in names]
            gs = [base_g[k] * scale for k in names]
            ref_new = one_step(ps, gs)
            flat_p = torch.cat([p.reshape(-1) for p in ps])
            flat_g = torch.cat([g.reshape(-1) for g in gs])
            pad = (-flat_p.numel()) % n_probe
            flat_p = torch.nn.functional.pad(flat_p, (0, pad))
            flat_g = torch.nn.functional.pad(flat_g, (0, pad))
            size = flat_p.numel() // n_probe
            shards = [one_step([flat_p[i * size:(i + 1) * size]],
                               [flat_g[i * size:(i + 1) * size]])[0]
                      for i in range(n_probe)]
            flat = torch.cat(shards)[:flat_p.numel() - pad]
            zero_new, off = [], 0
            for p in ps:
                zero_new.append(flat[off:off + p.numel()].reshape(p.shape))
                off += p.numel()
            if not all(torch.allclose(a, b, rtol=2e-5, atol=1e-6)
                       for a, b in zip(ref_new, zero_new)):
                why = ("probe trajectories differ between the structured "
                       "tree and ZeRO shard buffers "
                       f"(at gradient scale x{scale:g})")
                break
    except Exception as exc:                    # structure errors etc.
        why = f"probe failed on ZeRO shard buffers: {exc!r}"
    if why:
        raise ValueError(
            "this optax chain is not elementwise, so ZeRO-1 sharding would "
            f"silently diverge from gradient_allreduce ({why}). Transforms "
            "that couple elements across the tree (clip_by_global_norm, "
            "masked, multi_transform, per-leaf trust ratios) see per-shard "
            "buffers under ZeRO, not the full tree. Use gradient_allreduce, "
            "move the coupling into grad_fn, or pass "
            "check_elementwise=False if you know the chain is exact.")


def zero_gradient_allreduce(opt: OptimizerFactory, *, axis: str = "rank",
                            axis_size: Optional[int] = None,
                            check_elementwise: bool = True
                            ) -> DecentralizedOptimizer:
    """Synchronous data parallelism with ZeRO-1 sharded optimizer state:
    the same trajectory as :func:`gradient_allreduce` provided ``opt`` is
    elementwise (:func:`_check_elementwise_chain` probes it at
    construction; ``check_elementwise=False`` skips the probe).  The
    gradients are reduce-scattered over ``axis`` (``"rank"``; ``"local"``
    or ``"machine"`` shard within a machine or across machines), each
    rank steps its ``1/n`` shard with its ``1/n`` of the optimizer state,
    and the updated shards are all-gathered.  Requires params identical
    across ``axis``.  ``axis_size`` overrides the context lookup."""
    if check_elementwise:
        _check_elementwise_chain(opt)
    n = axis_size or _zero_axis_size(axis)
    L = _ctx.local_size() if axis != "rank" else 1
    axes = ("rank",) if axis == "rank" else ("machine", "local")

    def init(params):
        return DecentralizedState(
            0, _make_optimizer(opt, _zero_shard_templates(params, n)))

    def update(grads, state, params):
        new_params = _zero_apply(state.opt_state, grads, params, axis, n, L)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update, axes)


def zero_adapt_with_combine(opt: OptimizerFactory, comm: Communicator, *,
                            shard_axis: str = "local",
                            axes: Tuple[str, ...] = ("machine", "local"),
                            shard_axis_size: Optional[int] = None,
                            check_elementwise: bool = True
                            ) -> DecentralizedOptimizer:
    """Gossip with ZeRO-1 sharding on an orthogonal axis::

        x_{t+1} = ZeROAdapt_shard(Comb(x_t), mean_shard(g_t))

    ``comm`` gossips the params (machine to machine with
    :func:`hierarchical_communicator`), and the adapt is ZeRO-sharded
    over ``shard_axis`` (``"local"``: within each machine; ``"rank"``:
    over every rank) by the rotation rounds of :func:`_zero_apply`.  Every
    rank of a shard group ends the step with the same parameters.  The
    optimizer must be elementwise, as for
    :func:`zero_gradient_allreduce` (the same probe;
    ``check_elementwise=False`` skips it)."""
    if check_elementwise:
        _check_elementwise_chain(opt)
    n = shard_axis_size or _zero_axis_size(shard_axis)
    L = _ctx.local_size() if shard_axis != "rank" else 1

    def init(params):
        return DecentralizedState(
            0, _make_optimizer(opt, _zero_shard_templates(params, n)))

    def update(grads, state, params):
        combined = comm(params, state.step)
        new_params = _zero_apply(state.opt_state, grads, combined,
                                 shard_axis, n, L)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update, axes)


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------

def powersgd_allreduce(opt: OptimizerFactory, *, compression_rank: int = 2,
                       min_compress_size: int = 2048, out_dim: int = -1
                       ) -> DecentralizedOptimizer:
    """Synchronous data parallelism with PowerSGD rank-r gradient
    compression (Vogels et al., 2019) and error feedback: each matrix
    gradient ``M [m, k]`` is allreduced as two rank-r factors, one power
    iteration a step warm-started from last step's factor::

        M  = grad + error
        P  = mean_ranks(M @ Q);  P = qr(P).Q
        Q' = mean_ranks(M.T @ P)
        M^ = P @ Q'.T;  error = M - M^

    A leaf of at least ``min_compress_size`` elements and 2 dims (after
    the rank) is a matrix whose ``k`` is its output-feature dim
    ``out_dim``: -1, the last, for flax-layout leaves (the JAX rule,
    ``[prod(others), last]``), 0 for the port's zoo, whose Dense and
    Conv kernels are ``[out, in, ...]`` (the matrix is then the leaf's
    ``[out, rest]`` view transposed, the flax kernel's matrix up to the
    order of its rows).  Other leaves are allreduced exactly in one fused
    buffer.  ``Q`` starts identical on every rank (drawn on the host from
    seed 17, so every device starts alike) and stays identical; the
    compression runs in f32.  ``comm_state`` is ``(errors, Qs)``,
    ``[n, m, k]`` and ``[n, k, r]`` each."""
    if compression_rank < 1:
        raise ValueError(f"compression_rank must be >= 1, got "
                         f"{compression_rank}")
    if out_dim not in (0, -1):
        raise ValueError(f"out_dim must be 0 or -1, got {out_dim}")
    r = compression_rank

    def _compressible(x):
        return x.ndim >= 3 and x[0].numel() >= min_compress_size

    def _mk(shape):
        shape = tuple(shape[1:])
        if out_dim == -1:
            return int(np.prod(shape[:-1])), int(shape[-1])
        return int(np.prod(shape[1:])), int(shape[0])

    def _matrix(x):
        n = x.shape[0]
        m, k = _mk(x.shape)
        if out_dim == -1:
            return x.reshape(n, m, k)
        return x.reshape(n, k, m).transpose(1, 2)

    def _unmatrix(M, shape):
        if out_dim == -1:
            return M.reshape(shape)
        return M.transpose(1, 2).reshape(shape)

    def init(params):
        gen = torch.Generator().manual_seed(17)
        errs, qs = [], []
        for p in tree_flatten(params)[0]:
            if not _compressible(p):
                continue
            m, k = _mk(p.shape)
            q = torch.randn((k, min(r, m, k)), generator=gen,
                            dtype=torch.float32).to(p.device)
            qs.append(q.unsqueeze(0).expand((p.shape[0],) + tuple(q.shape)))
            errs.append(torch.zeros((p.shape[0], m, k), dtype=torch.float32,
                                    device=p.device))
        return DecentralizedState(0, _make_optimizer(opt, params),
                                  (tuple(errs), tuple(qs)))

    def update(grads, state, params):
        errs, qs = state.comm_state
        leaves, treedef = tree_flatten(grads)
        new_errs, new_qs = [], []
        out: List[Any] = [None] * len(leaves)
        ci = 0
        for i, g in enumerate(leaves):
            if not _compressible(g):
                continue
            n = g.shape[0]
            M = _matrix(g).to(torch.float32) + errs[ci]
            # the means over every rank (the process group's sum
            # across processes)
            N = n * _coll._procs()[0]
            P = _coll.rank_sum(torch.matmul(M, qs[ci]))[0] / N  # [m, r]
            P = torch.linalg.qr(P, mode="reduced")[0]
            Qn = _coll.rank_sum(torch.matmul(M.transpose(1, 2), P))[0] / N
            Mhat = P @ Qn.T
            new_errs.append(M - Mhat)
            new_qs.append(Qn.unsqueeze(0).expand((n,) + tuple(Qn.shape)))
            out[i] = _unmatrix(Mhat.unsqueeze(0).expand_as(M),
                               g.shape).to(g.dtype)
            ci += 1
        exact = [i for i, o in enumerate(out) if o is None]
        if exact:
            reduced = fusion.fused_leaf_op(_coll.allreduce)(
                [leaves[i] for i in exact])
            for i, rg in zip(exact, reduced):
                out[i] = rg
        new_params = _apply(state.opt_state, tree_unflatten(treedef, out),
                            params)
        return new_params, DecentralizedState(
            state.step + 1, state.opt_state,
            (tuple(new_errs), tuple(new_qs)))

    return DecentralizedOptimizer(init, update)


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

class StrategySpec(NamedTuple):
    """Constructor + contract metadata for one named strategy.

    ``build(opt, *, schedule, wire, concurrent, delayed,
    num_steps_per_communication)`` returns the configured strategy.  The
    flags say which knobs the algorithm responds to, and ``weights`` the
    schedule weightings its contract admits: ``"recv"`` (recv-side
    combine weights, ``compile_topology``), ``"push"`` (column-stochastic
    push weights, :func:`push_schedule`), ``"dst"`` (sender-side
    dst-weighting)."""
    build: Callable[..., DecentralizedOptimizer]
    uses_schedule: bool       # gossip: wire bytes depend on the topology
    wire_aware: bool          # accepts a wire= codec on its gossip rounds
    concurrent_aware: bool    # accepts concurrent= round-parallel emission
    pipelined_ok: bool        # supports delayed=True (hence overlap=True)
    weights: Tuple[str, ...]


def _reg_comm(schedule, wire, concurrent):
    return neighbor_communicator(
        schedule if schedule is not None else _ctx.static_schedule(),
        wire=wire, concurrent=concurrent)


def _reg_allreduce(opt, *, schedule=None, wire=None, concurrent=None,
                   delayed=False, num_steps_per_communication=1):
    return gradient_allreduce(opt)


def _reg_neighbor_cta(opt, *, schedule=None, wire=None, concurrent=None,
                      delayed=False, num_steps_per_communication=1):
    return adapt_with_combine(
        opt, _reg_comm(schedule, wire, concurrent), delayed=delayed,
        num_steps_per_communication=num_steps_per_communication)


def _reg_neighbor_atc(opt, *, schedule=None, wire=None, concurrent=None,
                      delayed=False, num_steps_per_communication=1):
    return adapt_then_combine(
        opt, _reg_comm(schedule, wire, concurrent), delayed=delayed,
        num_steps_per_communication=num_steps_per_communication)


def _reg_exact_diffusion(opt, *, schedule=None, wire=None, concurrent=None,
                         delayed=False, num_steps_per_communication=1):
    return exact_diffusion(opt, _reg_comm(schedule, wire, concurrent))


def _reg_gradient_tracking(opt, *, schedule=None, wire=None, concurrent=None,
                           delayed=False, num_steps_per_communication=1):
    return gradient_tracking(opt, _reg_comm(schedule, wire, concurrent))


def _reg_push_sum(opt, *, schedule=None, wire=None, concurrent=None,
                  delayed=False, num_steps_per_communication=1):
    return push_sum(opt, schedule)


def _reg_push_diging(opt, *, schedule=None, wire=None, concurrent=None,
                     delayed=False, num_steps_per_communication=1):
    return push_diging(opt, schedule)


def _reg_choco(opt, *, schedule=None, wire=None, concurrent=None,
               delayed=False, num_steps_per_communication=1):
    return choco_gossip(opt, schedule, wire=wire if wire else "int8")


def _reg_async_window_gossip(opt, *, schedule=None, wire=None,
                             concurrent=None, delayed=False,
                             num_steps_per_communication=1):
    # pace and the bound come from the context's knob (BLUEFOG_ASYNC /
    # set_async_gossip), not from these knobs
    return async_window_gossip(opt, schedule, wire=wire)


#: Name -> :class:`StrategySpec` for every strategy the autotuner can pick.
STRATEGIES = {
    "allreduce": StrategySpec(
        _reg_allreduce, uses_schedule=False, wire_aware=False,
        concurrent_aware=False, pipelined_ok=False, weights=()),
    "neighbor_cta": StrategySpec(
        _reg_neighbor_cta, uses_schedule=True, wire_aware=True,
        concurrent_aware=True, pipelined_ok=True, weights=("recv",)),
    "neighbor_atc": StrategySpec(
        _reg_neighbor_atc, uses_schedule=True, wire_aware=True,
        concurrent_aware=True, pipelined_ok=False, weights=("recv",)),
    "exact_diffusion": StrategySpec(
        _reg_exact_diffusion, uses_schedule=True, wire_aware=True,
        concurrent_aware=True, pipelined_ok=False, weights=("recv",)),
    "gradient_tracking": StrategySpec(
        _reg_gradient_tracking, uses_schedule=True, wire_aware=True,
        concurrent_aware=True, pipelined_ok=False, weights=("recv",)),
    "push_sum": StrategySpec(
        _reg_push_sum, uses_schedule=True, wire_aware=False,
        concurrent_aware=False, pipelined_ok=False, weights=("push",)),
    "push_diging": StrategySpec(
        _reg_push_diging, uses_schedule=True, wire_aware=False,
        concurrent_aware=False, pipelined_ok=False, weights=("push",)),
    "choco": StrategySpec(
        _reg_choco, uses_schedule=True, wire_aware=True,
        concurrent_aware=False, pipelined_ok=False,
        weights=("recv", "dst")),
    "async_window_gossip": StrategySpec(
        _reg_async_window_gossip, uses_schedule=True, wire_aware=True,
        concurrent_aware=False, pipelined_ok=False, weights=("push",)),
}


def strategy_constraint_violation(
    name: str,
    *,
    schedule: Optional[CommSchedule] = None,
    wire: Optional[str] = None,
    delayed: bool = False,
    num_steps_per_communication: int = 1,
    overlap: bool = False,
) -> Optional[str]:
    """The reason a knob combination violates ``name``'s contract, or
    None; the texts are the constructors' and the train step's."""
    spec = STRATEGIES[name]
    if delayed and not spec.pipelined_ok:
        if name == "neighbor_atc":
            return ("adapt_then_combine cannot be pipelined: its gossip "
                    "input IS the update output. Use adapt_with_combine"
                    "(..., delayed=True) for one-step-delayed mixing")
        return (f"{name} has no pipelined variant: delayed=True only "
                "applies to adapt_with_combine")
    if delayed and num_steps_per_communication != 1:
        return ("delayed=True requires num_steps_per_communication == 1: "
                "the carried mixed params would be poisoned by raw params "
                "on non-communicating steps")
    if overlap and not (spec.pipelined_ok and delayed):
        return ("overlap=True requires a pipelined strategy whose "
                "comm_state carries one-step-delayed mixed params — build "
                "one with adapt_with_combine(..., delayed=True)")
    dst = schedule is not None and schedule.uses_dst_weighting
    if name in ("push_sum", "push_diging") and dst:
        return ("push_sum requires a schedule without dst-weighting "
                "(uses_dst_weighting=False); pass dst_weight= instead"
                if name == "push_sum" else
                "push_diging requires column-stochastic push weights "
                "(push_schedule), not a dst-weighted schedule")
    if name == "async_window_gossip" and dst:
        return ("async_window_gossip requires column-stochastic push "
                "weights (push_schedule), not a dst-weighted schedule")
    if name == "choco" and dst:
        w = wire if wire else "int8"
        if _coll._parse_wire(w)[0] not in ("int8", "fp8"):
            return ("choco_gossip with a dst-weighted schedule "
                    "(uses_dst_weighting=True) requires wire='int8' or "
                    f"'fp8'; wire={w!r} does not commute with send scaling")
    return None


# ---------------------------------------------------------------------------
# Reference-named factories
# ---------------------------------------------------------------------------

def DistributedGradientAllreduceOptimizer(opt, **kw):
    return gradient_allreduce(opt, **kw)


def DistributedAdaptWithCombineOptimizer(
        opt, communication_type="neighbor_allreduce", **kw):
    comm, kw = _comm_from_type(communication_type, kw)
    return adapt_with_combine(opt, comm, **kw)


def DistributedAdaptThenCombineOptimizer(
        opt, communication_type="neighbor_allreduce", **kw):
    comm, kw = _comm_from_type(communication_type, kw)
    return adapt_then_combine(opt, comm, **kw)


def DistributedNeighborAllreduceOptimizer(opt, **kw):
    comm, kw = _comm_from_type("neighbor_allreduce", kw)
    return adapt_with_combine(opt, comm, **kw)


def DistributedHierarchicalNeighborAllreduceOptimizer(opt, **kw):
    comm, kw = _comm_from_type("hierarchical_neighbor_allreduce", kw)
    return adapt_with_combine(opt, comm, **kw)


def DistributedWinPutOptimizer(opt, **kw):
    return win_put_optimizer(opt, **kw)


def DistributedPullGetOptimizer(opt, **kw):
    return pull_get_optimizer(opt, **kw)


def DistributedPushSumOptimizer(opt, **kw):
    return push_sum(opt, **kw)


def _comm_from_type(communication_type: str, kw):
    """Resolve a reference ``communication_type`` to (communicator,
    strategy kw).  An installed dynamic topology
    (``set_dynamic_topology``) takes precedence over the static schedule.
    The hierarchical type sets ``axes=("machine", "local")``, as in JAX
    (the stacked ranks are machine-major either way)."""
    kw = dict(kw)
    sched = kw.pop("schedule", None)
    scheds = kw.pop("schedules", None)
    wire = kw.pop("wire", None)
    concurrent = kw.pop("concurrent", None)
    if communication_type == "neighbor_allreduce":
        if sched is None and scheds is None:
            scheds = _ctx.get_context().dynamic_schedules
            if scheds is None:
                sched = _ctx.static_schedule()
        comm = neighbor_communicator(sched, scheds, wire=wire,
                                     concurrent=concurrent)
    elif communication_type == "hierarchical_neighbor_allreduce":
        if sched is None and scheds is None:
            sched = _ctx.machine_schedule()
        comm = hierarchical_communicator(sched, scheds, wire=wire,
                                         concurrent=concurrent)
        kw.setdefault("axes", ("machine", "local"))
    elif communication_type in ("allreduce", "empty"):
        if sched is not None or scheds is not None:
            raise TypeError(
                f"communication_type {communication_type!r} does not take a "
                "schedule; dynamic topologies require neighbor_allreduce")
        if wire is not None or concurrent is not None:
            raise TypeError(
                f"wire compression / round-parallel emission apply to "
                f"gossip, not communication_type {communication_type!r}")
        comm = (allreduce_communicator() if communication_type == "allreduce"
                else empty_communicator())
    else:
        raise ValueError(f"unknown communication_type {communication_type!r}")
    allowed = ("num_steps_per_communication", "axes", "delayed")
    unknown = set(kw) - set(allowed)
    if unknown:
        raise TypeError(f"unexpected arguments: {sorted(unknown)}")
    return comm, kw


# ---------------------------------------------------------------------------
# Train-step builder
# ---------------------------------------------------------------------------

def replicate(tree, n: int):
    """Stack ``n`` copies of every leaf on a new leading rank axis.  The
    JAX function broadcasts a view; the port's strategies update the stack
    in place, so every rank gets its own copy."""
    return tree_map(
        lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.ndim), tree)


def init_distributed(strategy: DecentralizedOptimizer, dist_params
                     ) -> DecentralizedState:
    """Initialize strategy state for stacked params.  The strategy sees the
    whole stack, so a delayed carry starts from each rank's OWN params (the
    JAX function has to replace its broadcast template for that)."""
    return strategy.init(dist_params)


def stacked_grads(grad_fn: Callable[[Any, Any], Tuple[Any, Any]], params,
                  batch, slice_size: int = 1) -> Tuple[torch.Tensor, Any]:
    """Run ``grad_fn(params_r, batch_r) -> (loss, grads)`` once per DP
    replica, one replica after the other; returns ``(losses [n], grads)``
    with the grads stacked ``[n, ...]`` like ``params``.

    Replica ``r`` is rows ``r * slice_size ... (r + 1) * slice_size - 1``
    of every leaf; ``grad_fn`` gets them as ``[slice_size, ...]`` leaves
    and returns its peers' losses ``[slice_size]`` and grads stacked the
    same way.  At ``slice_size == 1`` it gets the rank's own leaves (no
    slice axis) and returns a scalar loss."""
    leaves, treedef = tree_flatten(params)
    bleaves, bdef = tree_flatten(batch)
    n = leaves[0].shape[0]
    if slice_size < 1 or n % slice_size:
        raise ValueError(f"{n} stacked rows are not replicas of "
                         f"slice_size={slice_size} peers")

    def rows(x, r):
        return x[r] if slice_size == 1 else \
            x[r * slice_size:(r + 1) * slice_size]

    bufs: Optional[List[torch.Tensor]] = None
    losses = []
    for r in range(n // slice_size):
        args = (tree_unflatten(treedef, [rows(x, r) for x in leaves]),
                tree_unflatten(bdef, [rows(b, r) for b in bleaves]))
        if _wb._armed is None:
            loss, grads = grad_fn(*args)
        else:                 # the ledger charges replica r's chips
            lo = _coll._procs()[1] * n + r * slice_size
            with _wb.replica(lo, lo + slice_size):
                loss, grads = grad_fn(*args)
        gl = tree_flatten(grads)[0]
        if bufs is None:
            shape = (n,) if slice_size == 1 else (n // slice_size,)
            bufs = [torch.empty(shape + tuple(g.shape), dtype=g.dtype,
                                device=g.device) for g in gl]
        for buf, g in zip(bufs, gl):
            buf[r].copy_(g)
        losses.append(torch.as_tensor(loss).detach().reshape(
            (slice_size,)))
    if slice_size > 1:
        bufs = [b.flatten(0, 1) for b in bufs]
    return torch.cat(losses), tree_unflatten(treedef, bufs)


class _InstrumentedStep:
    """Telemetry around a train step (JAX ``optimizers.py:1780``).

    Every call records flight ``step_begin`` / ``step_end`` events (and
    ``note_failure`` on an exception), a ``train_step`` span when tracing
    is armed, :func:`~bluefog_tpu_torch.utils.metrics.record_step`, the
    per-rank step-time table (:func:`~bluefog_tpu_torch.diagnostics.
    observe_step_time`) and a metrics :func:`sample`.  With
    ``metrics_every_k`` it runs :func:`~bluefog_tpu_torch.diagnostics.
    diagnose_consensus` on the step's *output* params on the first call
    and every k-th call after it, and :func:`~bluefog_tpu_torch.
    diagnostics.observe_async_staleness` on its output strategy state
    (``state_index`` into the outputs).  The wall time is the host's
    around the call: on the card, the dispatch.

    The chaos hooks run as in JAX (zero cost when no plan is installed):
    a kill / hang / throttle fault before the call, a ``nan`` fault on the
    outputs after it (the live params and state, which the step updates
    in place) and a ``join`` fault through ``resilience.chaos_join``.
    Left out of the JAX wrapper: the jit-cache retrace sentinel (the port
    compiles no programs).  The port's step updates its params and state
    in place, so ``donated`` reads 1 as JAX's default donation does."""

    def __init__(self, fn, *, steps_per_call: int, overlap: bool = False,
                 metrics_every_k: Optional[int] = None, warmup: int = 2,
                 state_index: int = 1):
        self._fn = fn
        self._steps_per_call = steps_per_call
        self._overlap = overlap
        self._metrics_every_k = metrics_every_k
        self._warmup = max(int(warmup), 1)
        self._state_index = state_index
        self._calls = 0
        self._trace = ""                 # minted lazily when tracing is armed

    def __call__(self, *args, **kwargs):
        import time as _time
        call = self._calls + 1
        _flight.record("step_begin", name="train_step", step=call)
        traced = _tracing.enabled()
        if traced and not self._trace:
            self._trace = _tracing.new_trace("train")
        tm0 = _time.monotonic() if traced else 0.0
        t0 = _time.perf_counter()
        try:
            # fault injection (zero-cost gate when no plan is installed): a
            # kill / hang / throttle fault fires BEFORE dispatch, so the
            # sleep lands in the step-time metrics as a real straggler's
            if _chaos._plan is not None:
                _chaos.on_train_step(call)
            out = self._fn(*args, **kwargs)
        except BaseException as e:
            _flight.note_failure(
                "exception", detail=f"{type(e).__name__}: {e}", step=call)
            raise
        dt = _time.perf_counter() - t0
        self._calls += 1
        if _chaos._plan is not None:
            # NaN a rank's row of the outputs (the live state), then enact
            # seeded membership churn (`join`) on them
            out = _chaos.corrupt_train_output(out, self._calls)
            out = _chaos.apply_membership(out, self._calls)
        _metrics.record_step(dt, steps=self._steps_per_call, donated=True,
                             fused_k=self._steps_per_call,
                             overlap=self._overlap)
        _flight.record("step_end", name="train_step", step=self._calls,
                       dur_s=round(dt, 6), fused_k=self._steps_per_call,
                       overlap=self._overlap, donated=True)
        if traced:
            _tracing.add_span(self._trace, "train_step", tm0,
                              _time.monotonic(), cat="train",
                              step=self._calls, fused_k=self._steps_per_call,
                              overlap=self._overlap)
        from . import diagnostics as _diag
        step_times = _diag.observe_step_time(dt)
        k = self._metrics_every_k
        if k and (self._calls == 1 or self._calls % k == 0):
            tp0 = _time.monotonic() if traced else 0.0
            with _wb.paused():     # the probe is not the step's traffic
                _diag.diagnose_consensus(out[0], step_times=step_times)
                if len(out) > self._state_index:
                    _diag.observe_async_staleness(out[self._state_index])
            if traced:
                _tracing.add_span(self._trace, "consensus_probe", tp0,
                                  _time.monotonic(), cat="train",
                                  step=self._calls)
        if self._calls >= self._warmup:
            _metrics.mark_steady_state(True)
        _metrics.sample(step=self._calls)
        return out


def _default_metrics_every_k(metrics_every_k, strategy):
    """An armed fleet view (``BLUEFOG_FLEET_EVERY`` / ``fleetview.arm``)
    declares a probe cadence; a step built without an explicit
    ``metrics_every_k`` inherits it so the metric carrier actually
    gossips — only for rank-axis strategies, the ones the probe can run
    on."""
    if metrics_every_k is not None:
        return metrics_every_k
    from .utils import fleetview as _fleetview
    every = _fleetview.fleet_every()
    if every is not None and strategy.axes[:1] == ("rank",):
        return every
    return None


def _check_metrics_every_k(metrics_every_k, strategy):
    if metrics_every_k is None:
        return
    if metrics_every_k < 1:
        raise ValueError("metrics_every_k must be >= 1")
    if strategy.axes[:1] != ("rank",):
        raise ValueError(
            "metrics_every_k requires a strategy that gossips over the "
            "rank axis (axes[0] == 'rank'); the consensus probe runs over "
            "the 1-D mesh — call diagnose_consensus manually for "
            "hierarchical strategies")


def _check_overlap(overlap, strategy):
    if overlap and not strategy.pipelined:
        raise ValueError(
            "overlap=True requires a pipelined strategy whose comm_state "
            "carries one-step-delayed mixed params — build one with "
            "adapt_with_combine(..., delayed=True) (or "
            "DistributedAdaptWithCombineOptimizer(..., delayed=True)). "
            "With a bulk-synchronous strategy the adapt waits on the "
            "gossip, so there is nothing for the scheduler to overlap.")


def _batch_at(batch, t: int, steps_per_call: int, reuse_batch: bool):
    return batch if steps_per_call == 1 or reuse_batch else \
        tree_map(lambda x: x[:, t], batch)


def make_train_step(grad_fn: Callable[[Any, Any], Tuple[Any, Any]],
                    strategy: DecentralizedOptimizer, *,
                    steps_per_call: int = 1, reuse_batch: bool = False,
                    slice_size: int = 1, overlap: bool = False,
                    metrics_every_k: Optional[int] = None,
                    metrics_warmup: int = 2):
    """The training step over stacked ranks.

    ``grad_fn(params, batch) -> (loss, grads)`` is per rank, or per DP
    replica of ``slice_size`` peers (:func:`stacked_grads`); the returned
    ``step(params, state, batch) -> (new_params, new_state, loss)`` maps
    trees whose leaves all carry the leading rank axis, with ``loss``
    ``[n]``.  ``steps_per_call > 1`` runs that many optimizer steps in a
    host loop: batch leaves then carry a steps axis after the rank axis
    (``[n, steps, ...]``) and the loss is ``[n, steps]``; ``reuse_batch``
    feeds the same ``[n, ...]`` batch to every step instead.

    The step is an :class:`_InstrumentedStep`: ``metrics_every_k=k``
    samples the consensus probes on the step's output every k-th call
    (and on the first), ``metrics_warmup`` is the call count after which
    the process is marked steady, and ``overlap=True`` declares the
    pipelined mode, which needs a strategy built with ``delayed=True``
    (JAX's texts for both refusals).  The port has no compiled programs,
    so there is no donation flag: the step updates params and state in
    place.
    """
    metrics_every_k = _default_metrics_every_k(metrics_every_k, strategy)
    _check_metrics_every_k(metrics_every_k, strategy)
    _check_overlap(overlap, strategy)
    if reuse_batch and steps_per_call == 1:
        raise ValueError("reuse_batch requires steps_per_call > 1 (a single "
                         "step has no steps axis to elide)")

    def step(params, state, batch):
        losses = []
        for t in range(steps_per_call):
            b = _batch_at(batch, t, steps_per_call, reuse_batch)
            with named_span("GRADIENT"):
                loss, grads = stacked_grads(grad_fn, params, b, slice_size)
            with torch.no_grad():
                params, state = strategy.update(grads, state, params)
            del grads
            losses.append(loss)
        loss = losses[0] if steps_per_call == 1 else torch.stack(losses, 1)
        return params, state, loss

    return _InstrumentedStep(step, steps_per_call=steps_per_call,
                             overlap=overlap,
                             metrics_every_k=metrics_every_k,
                             warmup=metrics_warmup)


def _stacked_state_grads(grad_fn, params, net_state, batch):
    """``grad_fn(params_r, net_state_r, batch_r) -> (loss, grads,
    new_net_state)`` once per rank: ``(losses [n], grads, new net
    state)`` stacked like ``params`` and ``net_state``."""
    leaves, treedef = tree_flatten(params)
    nleaves, ndef = tree_flatten(net_state)
    bleaves, bdef = tree_flatten(batch)
    n = leaves[0].shape[0]
    gbufs = nbufs = None
    losses = []
    for r in range(n):
        loss, grads, ns = grad_fn(
            tree_unflatten(treedef, [x[r] for x in leaves]),
            tree_unflatten(ndef, [x[r] for x in nleaves]),
            tree_unflatten(bdef, [b[r] for b in bleaves]))
        gl, nl = tree_flatten(grads)[0], tree_flatten(ns)[0]
        if gbufs is None:
            gbufs = [torch.empty((n,) + tuple(g.shape), dtype=g.dtype,
                                 device=g.device) for g in gl]
            nbufs = [torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                 device=x.device) for x in nl]
        for buf, g in zip(gbufs, gl):
            buf[r].copy_(g)
        for buf, x in zip(nbufs, nl):
            buf[r].copy_(x)
        losses.append(torch.as_tensor(loss).detach().reshape(()))
    return (torch.stack(losses), tree_unflatten(treedef, gbufs),
            tree_unflatten(ndef, nbufs))


def make_stateful_train_step(
    grad_fn: Callable[[Any, Any, Any], Tuple[Any, Any, Any]],
    strategy: DecentralizedOptimizer,
    *,
    steps_per_call: int = 1,
    reuse_batch: bool = False,
    overlap: bool = False,
    state_sync: Optional[str] = None,
    state_sync_schedule: Optional[CommSchedule] = None,
    metrics_every_k: Optional[int] = None,
    metrics_warmup: int = 2,
):
    """:func:`make_train_step` for networks with non-parameter state
    (BatchNorm statistics, EMA shadows; flax's ``batch_stats``).

    ``grad_fn(params, net_state, batch) -> (loss, grads, new_net_state)``
    per rank; the step maps ``(params, net_state, dstate, batch) ->
    (new_params, new_net_state, new_dstate, loss)``, every leaf stacked.
    Each step runs the gradient, then ``state_sync`` on the new net state,
    then the strategy's update.  ``state_sync``: ``None`` keeps the state
    rank-local, ``"neighbor"`` gossips it over the topology each step
    (``state_sync_schedule`` overrides the context's schedule),
    ``"allreduce"`` averages it over every rank; integer leaves (counters)
    are never averaged.  Syncing requires a rank-axis strategy.
    ``steps_per_call``, ``reuse_batch``, ``overlap``, ``metrics_every_k``
    and ``metrics_warmup`` behave as in :func:`make_train_step`; the
    probe's async sample reads the output strategy state."""
    metrics_every_k = _default_metrics_every_k(metrics_every_k, strategy)
    _check_metrics_every_k(metrics_every_k, strategy)
    _check_overlap(overlap, strategy)
    if state_sync not in (None, "neighbor", "allreduce"):
        raise ValueError(f"unknown state_sync {state_sync!r}")
    if state_sync_schedule is not None and state_sync != "neighbor":
        raise ValueError(
            "state_sync_schedule only applies to state_sync='neighbor'")
    if state_sync is not None and strategy.axes != ("rank",):
        raise ValueError(
            "state_sync requires a rank-axis strategy; sync net state "
            "manually for hierarchical (2-D mesh) strategies")
    if reuse_batch and steps_per_call == 1:
        raise ValueError("reuse_batch requires steps_per_call > 1 (a single "
                         "step has no steps axis to elide)")

    def sync(ns):
        if state_sync is None:
            return ns
        s = (state_sync_schedule if state_sync_schedule is not None
             else _ctx.static_schedule())

        def leaf(x):
            if not x.is_floating_point():
                return x
            if state_sync == "neighbor":
                return _coll.neighbor_allreduce(x, s)
            return _coll.allreduce(x)

        with named_span("STATE_SYNC"):
            return tree_map(leaf, ns)

    def step(params, net_state, dstate, batch):
        losses = []
        for t in range(steps_per_call):
            b = _batch_at(batch, t, steps_per_call, reuse_batch)
            with named_span("GRADIENT"):
                loss, grads, net_state = _stacked_state_grads(
                    grad_fn, params, net_state, b)
            with torch.no_grad():
                net_state = sync(net_state)
                params, dstate = strategy.update(grads, dstate, params)
            del grads
            losses.append(loss)
        loss = losses[0] if steps_per_call == 1 else torch.stack(losses, 1)
        return params, net_state, dstate, loss

    return _InstrumentedStep(step, steps_per_call=steps_per_call,
                             overlap=overlap,
                             metrics_every_k=metrics_every_k,
                             warmup=metrics_warmup, state_index=2)


# ---------------------------------------------------------------------------
# State carried across from the JAX package
# ---------------------------------------------------------------------------

def _find(tree, pred):
    if pred(tree):
        return tree
    if isinstance(tree, (tuple, list)):
        for x in tree:
            hit = _find(x, pred)
            if hit is not None:
                return hit
    return None


def _tensor_like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True)).to(ref.device)


def state_from_jax(jstate, strategy: DecentralizedOptimizer, params
                   ) -> DecentralizedState:
    """Map a JAX ``DecentralizedState`` (rank-stacked leaves, as
    ``init_distributed`` and the train step leave it) onto ``params``, the
    port's stacked params: ``step`` -> step; optax adam ``count``/``mu``/
    ``nu`` -> :class:`StackedAdam`'s ``step`` (each rank's count; one
    count for a ``torch.optim.Adam``) / ``exp_avg`` / ``exp_avg_sq``; the
    optax momentum ``trace`` -> the ``torch.optim.SGD``
    ``momentum_buffer``; the ``comm_state`` (the delayed carry, the window
    mailboxes, push-sum's weights, CHOCO's public copies, PowerSGD's
    errors and Qs, exact diffusion's psi, gradient tracking's ``(y,
    g_prev)``, push-DIGing's ``(u, p, y, g_prev)``, the async strategy's
    :class:`AsyncGossipState`) -> the port's.  ZeRO's optimizer state
    sits on the shard buffers, the port's slots.  Leaves pair up in
    sorted-key order, as ``jax.tree.flatten`` visits them, so the two
    sides' leaves must share their layout."""
    state = strategy.init(params)
    opt = state.opt_state
    slots = opt.param_groups[0]["params"]
    adam_state = _find(jstate.opt_state, lambda s: {"count", "mu", "nu"}
                       <= set(getattr(s, "_fields", ())))
    if adam_state is not None:
        counts = np.asarray(adam_state.count).reshape(-1)
        for p, mu, nu in zip(slots, tree_flatten(adam_state.mu)[0],
                             tree_flatten(adam_state.nu)[0]):
            if isinstance(opt, StackedAdam):
                step = torch.as_tensor(
                    _coll._local(counts, p.shape[0]).astype(np.float32),
                    device=p.device)
            else:
                step = torch.tensor(float(counts[0]), dtype=torch.float32)
            opt.state[p] = {"step": step,
                            "exp_avg": _tensor_like(mu, p),
                            "exp_avg_sq": _tensor_like(nu, p)}
    trace = _find(jstate.opt_state, lambda s: "trace"
                  in getattr(s, "_fields", ()))
    if trace is not None:
        for p, v in zip(slots, tree_flatten(trace.trace)[0]):
            opt.state[p] = {"momentum_buffer": _tensor_like(v, p)}
    carry = _carry_from_jax(jstate.comm_state, slots[0])
    step = int(np.asarray(jstate.step).reshape(-1)[0])
    return DecentralizedState(step, opt, carry)


def _carry_from_jax(x, ref: torch.Tensor):
    """A JAX ``comm_state`` as the port's: windows -> :class:`Window`,
    async states -> :class:`AsyncGossipState`, dicts / lists / tuples
    kept, arrays -> tensors on ``ref``'s device."""
    if x is None:
        return None
    fields = tuple(getattr(x, "_fields", ()))
    if set(fields) == {"value", "recv"}:
        return wops.Window(value=_tensor_like(x.value, ref),
                           recv=_tensor_like(x.recv, ref))
    if fields == AsyncGossipState._fields:
        return AsyncGossipState(*(_carry_from_jax(getattr(x, f), ref)
                                  for f in fields))
    if isinstance(x, dict):
        return {k: _carry_from_jax(v, ref) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_carry_from_jax(v, ref) for v in x)
    return _tensor_like(x, ref)
