"""The rest of the port's strategies against the JAX package on the CPU:
``exact_diffusion``, ``gradient_tracking``, ``push_diging`` (fused and
per leaf) and ``zero_adapt_with_combine`` (the rank axis, and the local
axis under hierarchical gossip, 4 ranks a machine over a machine ring)
follow JAX's float64 trajectories within 1e-12 x max|param| over 12
steps, from the start and from JAX's state after step 6
(``state_from_jax``: psi, ``(y, g_prev)``, ``(u, p, y, g_prev)``,
ZeRO's shards, Adam's per-rank counts).  ``STRATEGIES`` has JAX's names
and spec fields, each registry entry builds a strategy that trains, and
``strategy_constraint_violation`` gives JAX's answer on a table of knob
combinations.
"""
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
from bluefog_tpu_torch.parallel import context as tctx
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
from torch_oracle import N, port_grad_fn, problem, run_both, tensors

OPTS = {"momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: topt.sgd(0.1, momentum=0.9)),
        "adam": (lambda: optax.adam(0.01), lambda: topt.adam(0.01))}


def _weighted_exp2(mod_bf, mod_topo):
    return lambda: mod_bf.set_topology(mod_topo.ExponentialTwoGraph(N),
                                       is_weighted=True)


def _hier(mod_bf, mod_topo):
    def setup():
        mod_bf.set_topology(mod_topo.ExponentialTwoGraph(N), is_weighted=True)
        mod_bf.set_machine_topology(mod_topo.RingGraph(mod_bf.machine_size()),
                                    is_weighted=True)
    return setup


def _makers(name, jo, to):
    """(the JAX constructor, the port one, extra run_both kwargs)."""
    if name == "exact_diffusion":
        return (lambda: jopt.exact_diffusion(
                    jo(), jopt.neighbor_communicator(jbf.static_schedule())),
                lambda: topt.exact_diffusion(
                    to(), topt.neighbor_communicator(tctx.static_schedule())),
                {})
    if name == "gradient_tracking":
        return (lambda: jopt.gradient_tracking(
                    jo(), jopt.neighbor_communicator(jbf.static_schedule())),
                lambda: topt.gradient_tracking(
                    to(), topt.neighbor_communicator(tctx.static_schedule())),
                {})
    if name.startswith("push_diging"):
        fuse = name == "push_diging"
        return (lambda: jopt.push_diging(
                    jo(), jopt.push_schedule(jbf.load_topology(), N),
                    fuse=fuse),
                lambda: topt.push_diging(
                    to(), topt.push_schedule(tctx.load_topology(), N),
                    fuse=fuse),
                {})
    if name == "zero_awc_rank":
        return (lambda: jopt.zero_adapt_with_combine(
                    jo(), jopt.neighbor_communicator(jbf.static_schedule()),
                    shard_axis="rank", axes=("rank",)),
                lambda: topt.zero_adapt_with_combine(
                    to(), topt.neighbor_communicator(tctx.static_schedule()),
                    shard_axis="rank", axes=("rank",)),
                {})
    assert name == "zero_awc_local"
    return (lambda: jopt.zero_adapt_with_combine(
                jo(), jopt.hierarchical_communicator(
                    jbf.machine_schedule())),
            lambda: topt.zero_adapt_with_combine(
                to(), topt.hierarchical_communicator(
                    tctx.machine_schedule())),
            {"npm": 4})


CASES = [("exact_diffusion", "momentum"), ("gradient_tracking", "momentum"),
         ("gradient_tracking", "adam"), ("push_diging", "momentum"),
         ("push_diging", "adam"), ("push_diging_unfused", "momentum"),
         ("zero_awc_rank", "momentum"), ("zero_awc_local", "adam")]


@pytest.mark.parametrize("name,opt", CASES,
                         ids=[f"{n}-{o}" for n, o in CASES])
def test_strategy_matches_jax_in_float64(cpu_devices, name, opt):
    jo, to = OPTS[opt]
    make_j, make_t, kw = _makers(name, jo, to)
    local = name == "zero_awc_local"
    (params, state), jstate = run_both(
        cpu_devices, make_j, make_t, tag=f"{name} {opt}",
        jax_setup=(_hier if local else _weighted_exp2)(jbf, jtopo),
        port_setup=(_hier if local else _weighted_exp2)(tctx, ttopo), **kw)
    if name.startswith("zero_awc"):
        # every rank of a shard group ends the step with the same params
        group = N if name == "zero_awc_rank" else 4
        for leaf in params.values():
            for x in leaf.values():
                v = x.reshape(N // group, group, -1)
                assert float((v - v[:, :1]).abs().max()) == 0.0
    if name == "push_diging":
        # the mass lane: column-stochastic mixing keeps sum_r p_r = n
        for p in state.comm_state[1]:
            assert abs(float(p.sum()) - N) < 1e-12


def test_strategy_registry_matches_jax(cpu_devices):
    assert list(topt.STRATEGIES) == list(jopt.STRATEGIES)
    assert topt.StrategySpec._fields == jopt.StrategySpec._fields
    for name, spec in jopt.STRATEGIES.items():
        tspec = topt.STRATEGIES[name]
        assert tspec._replace(build=None) == spec._replace(build=None), name
    # every registry entry builds a strategy that takes a step on the port
    x, y, p0 = problem()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N), is_weighted=True)
        for name, spec in topt.STRATEGIES.items():
            sched = (topt.push_schedule(tctx.load_topology(), N)
                     if spec.weights == ("push",) else None)
            strat = spec.build(topt.sgd(0.05), schedule=sched, wire=None,
                               concurrent=None, delayed=False,
                               num_steps_per_communication=1)
            step = topt.make_train_step(port_grad_fn, strat)
            params = topt.replicate(tensors(p0), N)
            state = topt.init_distributed(strat, params)
            params, state, loss = step(params, state, batch)
            assert bool(torch.isfinite(loss).all()), name
            assert strat.axes == ("rank",)
    finally:
        tctx.shutdown()


def _dst(mod):
    srcs = [{(r - 1) % N: 0.5} for r in range(N)]
    dsts = [{(r + 1) % N: 0.5} for r in range(N)]
    return mod.compile_from_weights(N, [0.5] * N, srcs, dsts)


def _plain(mod):
    return mod.compile_topology(
        (jtopo if mod is jsch else ttopo).RingGraph(N))


def test_constraint_violation_matches_jax():
    knobs = [{}, {"delayed": True}, {"overlap": True},
             {"delayed": True, "overlap": True},
             {"delayed": True, "num_steps_per_communication": 2},
             {"num_steps_per_communication": 3},
             {"schedule": "dst"}, {"schedule": "dst", "wire": "bf16"},
             {"schedule": "dst", "wire": "fp8@64"}, {"schedule": "plain"},
             {"wire": "int8"}]
    seen = set()
    for name in jopt.STRATEGIES:
        for k in knobs:
            jk, tk = dict(k), dict(k)
            if "schedule" in k:
                pick = _dst if k["schedule"] == "dst" else _plain
                jk["schedule"], tk["schedule"] = pick(jsch), pick(tsch)
            want = jopt.strategy_constraint_violation(name, **jk)
            got = topt.strategy_constraint_violation(name, **tk)
            assert got == want, (name, k)
            seen.add(want)
    assert len(seen) >= 7       # the table reaches every refusal text
    with pytest.raises(KeyError):
        topt.strategy_constraint_violation("nope")
