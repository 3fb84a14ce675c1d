"""Decentralized optimizer strategies over stacked ranks (counterpart of
the strategy core of ``bluefog_tpu/optimizers.py``).

Every parameter leaf is ``[n, ...]`` with the rank on dim 0, as in the JAX
API.  A strategy wraps a ``torch.optim`` optimizer over those stacked
tensors: Adam and SGD are elementwise, so one optimizer over the stack
updates every rank exactly as a per-rank optimizer would.  The
communicators apply the stacked collectives of
:mod:`bluefog_tpu_torch.ops.collectives`.

Under a composed carving (:mod:`bluefog_tpu_torch.parallel.compose`) the
``n`` rows are ``dp`` replicas of ``slice_size`` peers each, replica-major:
the gradient function runs once per replica on its ``[slice_size, ...]``
rows (:func:`stacked_grads`), and the gossip mixes the ``dp`` replicas
for each peer coordinate through a ``[dp, slice_size * ...]`` view.

=======================  ==============================================
strategy                 update
=======================  ==============================================
``gradient_allreduce``   x_{t+1} = A(x_t, mean_ranks(g_t))
``adapt_with_combine``   x_{t+1} = A(Comb(x_t), g(x_t)); with ``delayed``
                         x_{t+1} = A(Comb(x_{t-1}), g(x_t))
``adapt_then_combine``   x_{t+1} = Comb(A(x_t, g_t))
=======================  ==============================================

``optimizer.step()`` updates ``p.data`` in place, so each update first
swaps the point the gradient is applied to into the optimizer's slots:
the combined params for CTA, the carried mixed params for delayed CTA,
the current params for ATC.  The step updates that point in place and
returns it as the new params (the JAX step donates its inputs the same
way), so a caller that needs the old params keeps a copy.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fusion
from .fusion import tree_flatten, tree_map, tree_unflatten
from .ops import collectives as _coll
from .schedule import CommSchedule

__all__ = ["neighbor_communicator", "allreduce_communicator",
           "empty_communicator", "DecentralizedState",
           "DecentralizedOptimizer", "gradient_allreduce",
           "adapt_with_combine", "adapt_then_combine", "init_distributed",
           "make_train_step", "stacked_grads", "adam", "sgd",
           "state_from_jax"]

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


def sgd(learning_rate: float) -> OptimizerFactory:
    """``optax.sgd(learning_rate)`` as a ``torch.optim.SGD`` factory."""
    return lambda params: torch.optim.SGD(params, lr=learning_rate)


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
    """Neighbor averaging of a stacked params tree under ``schedule``.
    ``fuse`` gossips one ``[n, total]`` buffer per dtype instead of one
    gather chain per leaf.  With ``slice_size`` peers per replica the
    ``n = schedule.size * slice_size`` rows gossip over the replicas only,
    each peer coordinate with its own counterparts (``W (x) I_slice``).
    Dynamic ``schedules`` and wire codecs are not ported yet and raise."""
    if (schedule is None) == (schedules is None):
        raise ValueError("pass exactly one of schedule / schedules")
    if schedules is not None:
        raise ValueError("dynamic schedules (schedules=) are not yet ported "
                         "to bluefog_tpu_torch; pass one static schedule")
    if wire is not None:
        raise ValueError(f"wire codec {wire!r}: wire codecs are not yet "
                         "ported to bluefog_tpu_torch")
    if schedule.num_rounds == 0:
        fuse = False     # degenerate topology: the op is elementwise

    def leaf(x):
        # replica r's peers are rows r * slice_size ...: one row a replica
        return _coll.neighbor_allreduce(
            x.reshape(schedule.size, -1), schedule,
            concurrent=concurrent).reshape(x.shape)

    def comm(params, step):
        if fuse:
            return fusion.fused_leaf_op(leaf)(params)
        return tree_map(leaf, params)

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
    comm_state: Any = None        # delayed CTA: the carried mixed params


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


# ---------------------------------------------------------------------------
# Train-step builder
# ---------------------------------------------------------------------------

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
    ``exp_avg_sq``; the delayed carry -> the carry.  Leaves pair up
    in sorted-key order, as ``jax.tree.flatten`` visits them."""
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
    carry = None
    if jstate.comm_state is not None:
        ref = slots[0]
        carry = tree_map(lambda x: _tensor_like(x, ref), jstate.comm_state)
    step = int(np.asarray(jstate.step).reshape(-1)[0])
    return DecentralizedState(step, opt, carry)
