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
==============================  ===========================================

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
           "replicate", "state_from_jax"]

Communicator = Callable[[Any, int], Any]       # (params tree, step) -> tree
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


# ---------------------------------------------------------------------------
# Optimizer factories (the optax names and defaults)
# ---------------------------------------------------------------------------

def adam(learning_rate: float) -> OptimizerFactory:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8) as a
    ``torch.optim.Adam`` factory."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate,
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
        view = (x.reshape(s.size, -1) if slice_size == 1
                else x.reshape(s.size, slice_size, -1))
        return _coll.neighbor_allreduce(
            view, s, wire=w, concurrent=concurrent,
            lead=1 if slice_size == 1 else 2).reshape(x.shape)

    def comm(params, step):
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
        if fuse:
            return fusion.fused_leaf_op(lambda x: leaf(x, step))(params)
        return tree_map(lambda x: leaf(x, step), params)

    return comm


def allreduce_communicator() -> Communicator:
    """Global parameter averaging."""
    return lambda params, step: tree_map(_coll.allreduce, params)


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
    gossip averaging is multiplicative in the parameters."""
    init: Callable[[Any], DecentralizedState]
    update: Callable[[Any, DecentralizedState, Any],
                     Tuple[Any, DecentralizedState]]
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
        grads = (fusion.fused_leaf_op(reduce_)(grads) if fuse
                 else tree_map(reduce_, grads))
        new_params = _apply(state.opt_state, grads, params)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update)


def adapt_with_combine(opt: OptimizerFactory, comm: Communicator, *,
                       num_steps_per_communication: int = 1,
                       delayed: bool = False) -> DecentralizedOptimizer:
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

    return DecentralizedOptimizer(init, update, pipelined=delayed)


def adapt_then_combine(opt: OptimizerFactory, comm: Communicator, *,
                       num_steps_per_communication: int = 1,
                       delayed: bool = False) -> DecentralizedOptimizer:
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

    return DecentralizedOptimizer(init, update)


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


def _zero_groups(x: torch.Tensor, axis: str, L: int) -> torch.Tensor:
    """``[n, ...]`` -> ``[groups, members, ...]``: the ranks that shard
    together along ``axis`` (all of them; a machine's local ranks; the
    ranks of one local index across machines)."""
    if axis == "rank":
        return x.unsqueeze(0)
    y = x.reshape((x.shape[0] // L, L) + tuple(x.shape[1:]))
    return y if axis == "local" else y.transpose(0, 1)


def _zero_ungroup(y: torch.Tensor, axis: str) -> torch.Tensor:
    if axis == "rank":
        return y[0]
    if axis == "machine":
        y = y.transpose(0, 1)
    return y.reshape((-1,) + tuple(y.shape[2:]))


def _zero_shard_templates(params, n: int):
    """Zero-filled ``[ranks, shard]`` templates, one per dtype bucket: the
    optimizer's slots (each rank's row is its 1/n shard)."""
    out = []
    for buf in fusion.fuse_tree(params).buffers:
        T = buf.shape[1]
        out.append(torch.zeros((buf.shape[0], (T + (-T) % n) // n),
                               dtype=buf.dtype, device=buf.device))
    return out


def _zero_apply(optimizer, grads, params, axis: str, n: int, L: int):
    """ZeRO-1 sharded adapt over stacked ranks: the reduce-scatter (the
    group's mean gradient, member j keeping shard j), the step of each
    rank's shard of its params with its shard of the optimizer state, and
    the all-gather of the updated shards."""
    grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
    fg = fusion.fuse_tree(grads)
    fp = fusion.fuse_tree(params)
    g_shards, p_shards, pads = [], [], []
    for gbuf, pbuf in zip(fg.buffers, fp.buffers):
        pad = (-gbuf.shape[1]) % n
        gp = torch.nn.functional.pad(gbuf, (0, pad))
        pp = torch.nn.functional.pad(pbuf, (0, pad))
        G = _zero_groups(gp, axis, L)                  # [groups, n, Tp]
        shard = G.shape[2] // n
        total = G.sum(dim=1)
        if total.is_floating_point():
            total = total / n             # the mean, as pmean
        g_shards.append(_zero_ungroup(total.reshape(-1, n, shard), axis))
        own = _zero_groups(pp, axis, L).reshape(-1, n, n, shard)
        j = torch.arange(n, device=pbuf.device)
        p_shards.append(_zero_ungroup(own[:, j, j], axis))
        pads.append(pad)
    new_shards = _apply(optimizer, g_shards, p_shards)
    bufs = []
    for sh, pad in zip(new_shards, pads):
        S = _zero_groups(sh, axis, L)                  # [groups, n, shard]
        full = S.reshape(S.shape[0], 1, -1).expand(-1, n, -1)
        full = _zero_ungroup(full, axis)
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

    def init(params):
        return DecentralizedState(
            0, _make_optimizer(opt, _zero_shard_templates(params, n)))

    def update(grads, state, params):
        new_params = _zero_apply(state.opt_state, grads, params, axis, n, L)
        return new_params, DecentralizedState(state.step + 1,
                                              state.opt_state)

    return DecentralizedOptimizer(init, update)


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
            P = torch.matmul(M, qs[ci]).sum(dim=0) / n          # [m, r]
            P = torch.linalg.qr(P, mode="reduced")[0]
            Qn = torch.matmul(M.transpose(1, 2), P).sum(dim=0) / n  # [k, r]
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
    ``axes`` is accepted as in JAX, where it picks the 2-D mesh of the
    hierarchical type; the stacked ranks have one layout (machine-major),
    so it is dropped."""
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
    kw.pop("axes", None)
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
        loss, grads = grad_fn(
            tree_unflatten(treedef, [rows(x, r) for x in leaves]),
            tree_unflatten(bdef, [rows(b, r) for b in bleaves]))
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


def make_train_step(grad_fn: Callable[[Any, Any], Tuple[Any, Any]],
                    strategy: DecentralizedOptimizer, *,
                    steps_per_call: int = 1, reuse_batch: bool = False,
                    slice_size: int = 1):
    """The training step over stacked ranks.

    ``grad_fn(params, batch) -> (loss, grads)`` is per rank, or per DP
    replica of ``slice_size`` peers (:func:`stacked_grads`); the returned
    ``step(params, state, batch) -> (new_params, new_state, loss)`` maps
    trees whose leaves all carry the leading rank axis, with ``loss``
    ``[n]``.  ``steps_per_call > 1`` runs that many optimizer steps in a
    host loop: batch leaves then carry a steps axis after the rank axis
    (``[n, steps, ...]``) and the loss is ``[n, steps]``; ``reuse_batch``
    feeds the same ``[n, ...]`` batch to every step instead.
    """
    if reuse_batch and steps_per_call == 1:
        raise ValueError("reuse_batch requires steps_per_call > 1 (a single "
                         "step has no steps axis to elide)")

    def step(params, state, batch):
        losses = []
        for t in range(steps_per_call):
            b = batch if steps_per_call == 1 or reuse_batch else \
                tree_map(lambda x: x[:, t], batch)
            loss, grads = stacked_grads(grad_fn, params, b, slice_size)
            with torch.no_grad():
                params, state = strategy.update(grads, state, params)
            del grads
            losses.append(loss)
        loss = losses[0] if steps_per_call == 1 else torch.stack(losses, 1)
        return params, state, loss

    return step


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
    ``nu`` -> the ``torch.optim.Adam`` state ``step``/``exp_avg``/
    ``exp_avg_sq``; the optax momentum ``trace`` -> the
    ``torch.optim.SGD`` ``momentum_buffer``; the ``comm_state`` (the
    delayed carry, the window mailboxes, push-sum's weights, CHOCO's
    public copies, PowerSGD's errors and Qs) -> the port's.  ZeRO's
    optimizer state sits on the shard buffers, the port's slots.  Leaves
    pair up in sorted-key order, as ``jax.tree.flatten`` visits them, so
    the two sides' leaves must share their layout."""
    state = strategy.init(params)
    opt = state.opt_state
    slots = opt.param_groups[0]["params"]
    adam_state = _find(jstate.opt_state, lambda s: {"count", "mu", "nu"}
                       <= set(getattr(s, "_fields", ())))
    if adam_state is not None:
        count = float(np.asarray(adam_state.count).reshape(-1)[0])
        for p, mu, nu in zip(slots, tree_flatten(adam_state.mu)[0],
                             tree_flatten(adam_state.nu)[0]):
            opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
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
    dicts / lists / tuples kept, arrays -> tensors on ``ref``'s device."""
    if x is None:
        return None
    if set(getattr(x, "_fields", ())) == {"value", "recv"}:
        return wops.Window(value=_tensor_like(x.value, ref),
                           recv=_tensor_like(x.recv, ref))
    if isinstance(x, dict):
        return {k: _carry_from_jax(v, ref) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_carry_from_jax(v, ref) for v in x)
    return _tensor_like(x, ref)
