"""The port's strategy layer against the JAX package on the CPU: each of
the 15 variants the strategy benchmark runs (``examples/benchmark.py``'s
``--dist-optimizer`` choices, with ``--atc``, ``--dynamic-topology`` and
``--wire``), built by the port's example (``make_strategy`` on
``setup_context``) and by the JAX example's recipe, over 8 ranks (8
virtual devices on the JAX side) on weighted Exp2 (4 ranks a machine
over a machine ring for the hierarchical type).

The model is a small MLP (64 -> 64 -> 10) in the flax layout on both
sides, rank-varying data from a seed, identical starts (the ``replicate``
flow), ``sgd(0.1, momentum=0.9)``.  Float64 throughout (the ROADMAP's
oracle): the port's params equal JAX's row for row after each of 3 steps
within 1e-12 x max|param|, and, started from JAX's state after step 3 by
``state_from_jax`` (mailboxes, push-sum's weights, CHOCO's public copies,
ZeRO's shards, PowerSGD's errors and Qs), after each of 3 more.  The
codecs see the same float32 casts on both sides, so their codes agree
bit for bit.

Also: the refusals and error texts (push-sum on a dst-weighted schedule,
CHOCO with a dst-weighted bf16 wire, ``_comm_from_type``'s TypeErrors
and ValueError, the example's ``--wire`` refusal), the ZeRO probe,
PowerSGD's ``out_dim=0`` on transposed leaves, and push-sum's mass.
"""
import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu.optimizers as jopt
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.examples import benchmark as tex
from bluefog_tpu_torch.fusion import tree_flatten, tree_unflatten
from bluefog_tpu_torch.parallel import context as tctx
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, DIN, DH, DOUT, B = 8, 64, 64, 10, 8
STEPS = 3
LR, MOMENTUM = 0.1, 0.9

# (id, --dist-optimizer, --atc, --dynamic-topology, --wire)
VARIANTS = [
    ("awc", "neighbor_allreduce", False, False, None),
    ("atc", "neighbor_allreduce", True, False, None),
    ("dynamic", "neighbor_allreduce", False, True, None),
    ("wire_bf16", "neighbor_allreduce", False, False, "bf16"),
    ("wire_int8", "neighbor_allreduce", False, False, "int8"),
    ("gradient_allreduce", "gradient_allreduce", False, False, None),
    ("allreduce", "allreduce", False, False, None),
    ("empty", "empty", False, False, None),
    ("hierarchical", "hierarchical_neighbor_allreduce", False, False, None),
    ("win_put", "win_put", False, False, None),
    ("pull_get", "pull_get", False, False, None),
    ("push_sum", "push_sum", False, False, None),
    ("choco", "choco", False, False, None),
    ("zero_allreduce", "zero_allreduce", False, False, None),
    ("powersgd", "powersgd", False, False, None),
]


def _problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, B, DIN))
    y = rng.integers(0, DOUT, size=(N, B))
    p0 = {"Dense_0": {"kernel": 0.2 * rng.normal(size=(DIN, DH)),
                      "bias": 0.1 * rng.normal(size=(DH,))},
          "Dense_1": {"kernel": 0.2 * rng.normal(size=(DH, DOUT)),
                      "bias": 0.1 * rng.normal(size=(DOUT,))}}
    return x, y, p0


def _jax_grad_fn(p, batch):
    x, y = batch

    def loss_fn(p):
        h = jax.nn.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
        logits = h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
    return jax.value_and_grad(loss_fn)(p)


def _port_grad_fn(p, batch):
    x, y = batch
    leaves, treedef = tree_flatten(p)
    ps = [t.detach().requires_grad_() for t in leaves]
    q = tree_unflatten(treedef, ps)
    h = torch.relu(x @ q["Dense_0"]["kernel"] + q["Dense_0"]["bias"])
    logits = h @ q["Dense_1"]["kernel"] + q["Dense_1"]["bias"]
    loss = torch.nn.functional.cross_entropy(logits, y)
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def _jax_strategy(name, atc, dynamic, wire):
    """``examples/benchmark.py:94-176`` on the live JAX context."""
    hier = name.startswith("hier")
    n = jbf.size()
    topo = jtopo.ExponentialTwoGraph(n)
    jbf.set_topology(topo, is_weighted=True)
    if hier:
        jbf.set_machine_topology(jtopo.RingGraph(jbf.machine_size()),
                                 is_weighted=True)
    opt = optax.sgd(LR, momentum=MOMENTUM)
    scheds = None
    if dynamic:
        L = jbf.local_size()
        if hier:
            gen = lambda m: jtopo.GetExp2DynamicSendRecvMachineRanks(
                n, L, m * L, 0)
            scheds = jsch.compile_dynamic_schedules(gen, jbf.machine_size())
        elif L > 2 and n > L:
            gen = lambda r: jtopo.GetInnerOuterExpo2DynamicSendRecvRanks(
                n, L, r)
            scheds = jsch.compile_dynamic_schedules(gen, n)
        else:
            gen = lambda r: jtopo.GetDynamicOnePeerSendRecvRanks(topo, r)
            scheds = jsch.compile_dynamic_schedules(gen, n)
    if name == "gradient_allreduce":
        return jopt.gradient_allreduce(opt)
    if name == "zero_allreduce":
        return jopt.zero_gradient_allreduce(opt)
    if name == "choco":
        return jopt.choco_gossip(opt, wire=wire or "int8")
    if name == "win_put":
        return jopt.DistributedWinPutOptimizer(opt, wire=wire)
    if name == "pull_get":
        return jopt.DistributedPullGetOptimizer(opt, wire=wire)
    if name == "push_sum":
        return jopt.DistributedPushSumOptimizer(opt)
    if name == "powersgd":
        return jopt.powersgd_allreduce(opt, compression_rank=4)
    factory = (jopt.DistributedAdaptThenCombineOptimizer if atc
               else jopt.DistributedAdaptWithCombineOptimizer)
    return factory(opt, communication_type=name,
                   **({"schedules": scheds} if scheds else {}),
                   **({"wire": wire} if wire else {}))


def _jax_run(cpu_devices, variant, steps):
    """JAX params after each step, the initial state, and the params and
    state after ``STEPS``."""
    _, name, atc, dynamic, wire = variant
    x, y, p0 = _problem()
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N], nodes_per_machine=(
            4 if name.startswith("hier") else None))
        try:
            strat = _jax_strategy(name, atc, dynamic, wire)
            step = jopt.make_train_step(_jax_grad_fn, strat, donate=False)
            params = jopt.replicate(jax.tree.map(jnp.asarray, p0), N)
            state = jopt.init_distributed(strat, params)
            init = jax.tree.map(np.asarray, state)
            batch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
            hist, mid = [], None
            for t in range(steps):
                params, state, loss = step(params, state, batch)
                hist.append(jax.tree.map(np.asarray, params))
                if t + 1 == STEPS:
                    mid = (jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, state))
            return hist, init, mid
        finally:
            jbf.shutdown()


def _port_setup(variant):
    _, name, atc, dynamic, wire = variant
    scheds = tex.setup_context(name, N, "cpu", dynamic)
    strat = tex.make_strategy(name, topt.sgd(LR, momentum=MOMENTUM),
                              atc=atc, wire=wire, schedules=scheds,
                              out_dim=-1)
    return strat, topt.make_train_step(_port_grad_fn, strat)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _assert_params(got, want, tag, rel=1e-12):
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        w = np.asarray(w)
        tol = rel * max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=tag)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_variant_matches_jax_row_for_row(cpu_devices, variant):
    want, init, (mid_params, mid_state) = _jax_run(cpu_devices, variant,
                                                   2 * STEPS)
    x, y, p0 = _problem()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    # PowerSGD compresses in float32 on both sides (products summed in
    # another order): its trajectories agree to float32 noise
    rel = 1e-6 if variant[1] == "powersgd" else 1e-12
    try:
        strat, step = _port_setup(variant)
        params = topt.replicate(_tensors(p0), N)
        state = topt.init_distributed(strat, params)
        if variant[1] == "powersgd":
            # Q starts from JAX's PRNG there, from torch's here
            state = topt.state_from_jax(init, strat, params)
        for t in range(STEPS):
            params, state, _ = step(params, state, batch)
            _assert_params(params, want[t], f"{variant[0]} step {t + 1}",
                           rel)
        # from JAX's state after STEPS: the carried state is the same
        params = _tensors(mid_params)
        state = topt.state_from_jax(mid_state, strat, params)
        for t in range(STEPS, 2 * STEPS):
            params, state, _ = step(params, state, batch)
            _assert_params(params, want[t],
                           f"{variant[0]} from JAX's state, step {t + 1}",
                           rel)
    finally:
        tctx.shutdown()


def _texts(cpu_devices, build_j, build_t):
    """The exception each side raises."""
    with jax.enable_x64(False):
        jbf.init(devices=cpu_devices[:N])
        try:
            with pytest.raises(Exception) as ej:
                build_j()
        finally:
            jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        with pytest.raises(Exception) as et:
            build_t()
    finally:
        tctx.shutdown()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)
    return str(et.value)


def _dst_sched(mod):
    srcs = [{(r - 1) % N: 0.5} for r in range(N)]
    dsts = [{(r + 1) % N: 0.5} for r in range(N)]
    return mod.compile_from_weights(N, [0.5] * N, srcs, dsts)


def test_refusals_keep_the_jax_texts(cpu_devices):
    """push-sum on a dst-weighted schedule, CHOCO with a dst-weighted bf16
    wire, ``_comm_from_type``'s TypeErrors and ValueError, PowerSGD's
    rank: each raises the JAX exception with the JAX text."""
    jo, to = optax.sgd(0.1), topt.sgd(0.1)
    zero = np.zeros((N, 3))
    jp = jopt.replicate({"w": jnp.zeros(3)}, N)
    tp = {"w": torch.from_numpy(zero)}

    def jinit(strat):
        return lambda: jopt.init_distributed(strat, jp)

    cases = [
        (lambda: jopt.init_distributed(
            jopt.push_sum(jo, _dst_sched(jsch)), jp),
         lambda: topt.init_distributed(
             topt.push_sum(to, _dst_sched(tsch)), tp), "pass dst_weight="),
        (lambda: jopt.init_distributed(
            jopt.choco_gossip(jo, _dst_sched(jsch), wire="bf16"), jp),
         lambda: topt.init_distributed(
             topt.choco_gossip(to, _dst_sched(tsch), wire="bf16"), tp),
         "does not commute with send scaling"),
        (lambda: jopt.DistributedAdaptWithCombineOptimizer(
            jo, communication_type="allreduce",
            schedule=jbf.static_schedule()),
         lambda: topt.DistributedAdaptWithCombineOptimizer(
            to, communication_type="allreduce",
            schedule=tctx.static_schedule()), "does not take a schedule"),
        (lambda: jopt.DistributedAdaptThenCombineOptimizer(
            jo, communication_type="empty", wire="bf16"),
         lambda: topt.DistributedAdaptThenCombineOptimizer(
            to, communication_type="empty", wire="bf16"),
         "apply to gossip"),
        (lambda: jopt.DistributedNeighborAllreduceOptimizer(jo, lr=1),
         lambda: topt.DistributedNeighborAllreduceOptimizer(to, lr=1),
         "unexpected arguments"),
        (lambda: jopt.DistributedAdaptWithCombineOptimizer(
            jo, communication_type="ring"),
         lambda: topt.DistributedAdaptWithCombineOptimizer(
            to, communication_type="ring"), "unknown communication_type"),
        (lambda: jopt.powersgd_allreduce(jo, compression_rank=0),
         lambda: topt.powersgd_allreduce(to, compression_rank=0),
         "compression_rank must be >= 1"),
    ]
    for build_j, build_t, want in cases:
        assert want in _texts(cpu_devices, build_j, build_t)


class _ClipByGlobalNorm(torch.optim.SGD):
    """SGD whose step clips the gradients of all its tensors by their
    joint norm: not elementwise."""

    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(1.0 / norm, max=1.0)
        for g in grads:
            g.mul_(scale)
        return super().step(closure)


def test_zero_probe_and_sharded_state():
    tctx.init(size=N, device="cpu")
    try:
        with pytest.raises(ValueError, match="not elementwise"):
            topt.zero_gradient_allreduce(
                lambda ps: _ClipByGlobalNorm(ps, lr=0.1))
        for opt in (topt.sgd(0.1, momentum=0.9), topt.adam(0.1)):
            topt.zero_gradient_allreduce(opt)     # elementwise: passes
        strat = topt.zero_gradient_allreduce(topt.adam(0.1))
        params = {"w": torch.zeros(N, 13), "b": torch.zeros(N, 2)}
        state = strat.init(params)
        slots = state.opt_state.param_groups[0]["params"]
        assert [tuple(s.shape) for s in slots] == [(N, 2)]   # 15 -> 16 / 8
        with pytest.raises(ValueError, match="unknown mesh axis"):
            topt.zero_gradient_allreduce(topt.sgd(0.1), axis="row")
    finally:
        tctx.shutdown()


@pytest.mark.parametrize("axis", ["local", "machine"])
def test_zero_over_a_machine_axis_equals_gradient_allreduce(axis):
    """ZeRO over the local (or machine) axis of 2 x 4 ranks whose params
    are equal within each group: the group mean of the gradients, as
    ``gradient_allreduce`` within each group."""
    tctx.init(size=N, device="cpu", nodes_per_machine=4)
    try:
        rng = np.random.default_rng(5)
        grads = {"w": torch.from_numpy(rng.normal(size=(N, 7)))}
        groups = (np.arange(N) // 4) if axis == "local" else np.arange(N) % 4
        base = rng.normal(size=(N, 7))[groups]
        strat = topt.zero_gradient_allreduce(topt.sgd(0.5), axis=axis)
        params = {"w": torch.from_numpy(base.copy())}
        state = strat.init(params)
        new, _ = strat.update(grads, state, params)
        g = grads["w"].numpy()
        mean = np.stack([g[groups == groups[r]].mean(0) for r in range(N)])
        np.testing.assert_allclose(new["w"].numpy(), base - 0.5 * mean,
                                   rtol=0, atol=1e-12)
    finally:
        tctx.shutdown()


def test_powersgd_out_dim_0_is_the_transposed_leaf():
    """``out_dim=0`` on ``[out, in]`` leaves compresses the same matrices
    as the default on their ``[in, out]`` transposes: the same
    trajectory, transposed."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(64, 48))
    g = [rng.normal(size=(N, 64, 48)) for _ in range(3)]
    runs = []
    tctx.init(size=N, device="cpu")
    try:
        for out_dim, tr in ((-1, lambda a: a), (0, lambda a: a.swapaxes(-1, -2))):
            strat = topt.powersgd_allreduce(topt.sgd(0.1), compression_rank=2,
                                            min_compress_size=16,
                                            out_dim=out_dim)
            params = {"k": torch.from_numpy(np.repeat(tr(w)[None], N, 0))}
            state = strat.init(params)
            for gs in g:
                params, state = strat.update(
                    {"k": torch.from_numpy(np.ascontiguousarray(tr(gs)))},
                    state, params)
            runs.append(tr(params["k"].numpy()))
    finally:
        tctx.shutdown()
    np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=1e-12)
    assert np.abs(runs[0] - runs[0][:1]).max() == 0      # lock-step ranks


def test_push_sum_weights_sum_to_n_on_a_directed_graph():
    tctx.init(size=N, device="cpu")
    try:
        topo = nx.DiGraph()
        topo.add_nodes_from(range(N))
        topo.add_edges_from([(r, (r + 1) % N) for r in range(N)]
                            + [(0, 3), (0, 5), (2, 6)])
        strat = topt.push_sum(topt.sgd(0.1), topt.push_schedule(topo))
        rng = np.random.default_rng(7)
        params = {"w": torch.from_numpy(rng.normal(size=(N, 5)))}
        state = strat.init(params)
        for _ in range(6):
            grads = {"w": torch.from_numpy(rng.normal(size=(N, 5)))}
            params, state = strat.update(grads, state, params)
        p = state.comm_state[1][0].value
        assert abs(float(p.sum()) - N) < 1e-12 * N
        assert float(p.min()) < 1.0 - 1e-3     # the graph is unbalanced
    finally:
        tctx.shutdown()


def test_installed_dynamic_topology_takes_precedence():
    """``_comm_from_type`` picks up ``set_dynamic_topology``'s schedules
    over the static one, as ``optimizers.py:1711-1716`` of the JAX
    package: the factory's strategy equals one built on the schedules."""
    tctx.init(size=N, device="cpu")
    try:
        topo = ttopo.ExponentialTwoGraph(N)
        tctx.set_topology(topo, is_weighted=True)
        scheds = tctx.set_dynamic_topology(
            lambda r: ttopo.GetDynamicOnePeerSendRecvRanks(topo, r))
        assert tctx.dynamic_schedules() is scheds and len(scheds) > 1
        rng = np.random.default_rng(8)
        x0 = rng.normal(size=(N, 4))
        grads = [{"w": torch.from_numpy(rng.normal(size=(N, 4)))}
                 for _ in range(3)]
        runs = []
        for strat in (topt.DistributedNeighborAllreduceOptimizer(
                          topt.sgd(0.1)),
                      topt.adapt_with_combine(
                          topt.sgd(0.1),
                          topt.neighbor_communicator(schedules=scheds))):
            params = {"w": torch.from_numpy(x0.copy())}
            state = strat.init(params)
            for g in grads:
                params, state = strat.update(g, state, params)
            runs.append(params["w"])
        assert torch.equal(runs[0], runs[1])
        tctx.clear_dynamic_topology()
        assert tctx.dynamic_schedules() is None
    finally:
        tctx.shutdown()
