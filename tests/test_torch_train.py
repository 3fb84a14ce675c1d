"""The port's decentralized LM trainer vs the JAX package, dp = 4, on the CPU.

The JAX side is the composed LM on a 4-device carving of the virtual CPU
mesh (``compose_parallelism(4)``, ``make_lm_grad_fn``, the optimizer
strategies through ``optimizers.make_train_step``); the port holds the
same 4 ranks stacked on dim 0.  Both start from ``init_lm_params`` draws
that are bit-identical and train on ``make_lm_batch`` tokens that are
bit-identical.

* SGD (lr 0.1), three steps, for delayed and undelayed AWC, ATC and
  gradient allreduce, with the port's attention through the flash path
  (``use_pallas``: the K1/K2 plain versions) and through the plain
  online-softmax path: every parameter within atol 1e-5 and every
  per-rank loss within rtol 1e-5 of JAX (f32, a few hundred ops deep);
* Adam (5e-3, the lm_bench setting) with delayed AWC against JAX with
  ``use_pallas=True`` (interpret-mode Pallas): per-rank losses rtol 1e-4
  (Adam's first updates are +-lr wherever |g| >> eps, so rounding noise
  in g moves params by up to 2 lr only where g ~ 0);
* the state carrier: 2 JAX steps, params and Adam/carry state carried
  across with ``params_from_jax(stacked=True)`` / ``state_from_jax``, then
  2 more steps on each side;
* ``python -m bluefog_tpu_torch.tools.lm_bench --device cpu`` prints its
  JSON and the loss falls.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu.optimizers as jopt
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.parallel import compose as tcompose

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_CFG = dict(vocab=64, d_model=32, heads=4, layers=2, seq_len=32, micro=2,
            batch=2)
STRATEGIES = ["awc_delayed", "awc", "atc", "allreduce"]


def _strategy(mod, name, opt, comm, **axes):
    if name == "awc_delayed":
        return mod.adapt_with_combine(opt, comm, delayed=True, **axes)
    if name == "awc":
        return mod.adapt_with_combine(opt, comm, **axes)
    if name == "atc":
        return mod.adapt_then_combine(opt, comm, **axes)
    return mod.gradient_allreduce(opt)


def _jax_run(devices, name, opt, use_pallas, steps, params=None,
             state=None):
    cfg = jcompose.LMConfig(**_CFG)
    m = jcompose.compose_parallelism(4, devices=devices[:4])
    comm = jopt.neighbor_communicator(m.schedule, axis="rank")
    strat = _strategy(jopt, name, opt, comm, axes=jcompose.AXES)
    step = jopt.make_train_step(
        jcompose.make_lm_grad_fn(cfg, m, use_pallas=use_pallas), strat,
        mesh=m.mesh, in_spec=m.spec, check_vma=False)
    if params is None:
        params = jcompose.init_lm_params(cfg, m)
        state = jopt.init_distributed(strat, params)
        params = jcompose.device_put(m, params)
    toks = jcompose.make_lm_batch(cfg, m)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, toks)
        losses.append(np.asarray(loss))
    return losses, params, state


def _port_setup(name, opt, use_pallas):
    cfg = tcompose.LMConfig(**_CFG)
    m = tcompose.compose_parallelism(4, device="cpu")
    comm = topt.neighbor_communicator(m.schedule)
    strat = _strategy(topt, name, opt, comm)
    step = topt.make_train_step(
        tcompose.make_lm_grad_fn(cfg, m, use_pallas=use_pallas), strat)
    return cfg, m, strat, step


def _port_run(name, opt, use_pallas, steps):
    cfg, m, strat, step = _port_setup(name, opt, use_pallas)
    params = tcompose.init_lm_train_params(cfg, m)
    state = topt.init_distributed(strat, params)
    toks = tcompose.make_lm_batch(cfg, m)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, toks)
        losses.append(loss.numpy())
    return losses, params, state


@pytest.fixture(scope="module")
def jax_sgd(cpu_devices):
    cache = {}

    def get(name):
        if name not in cache:
            losses, params, _ = _jax_run(cpu_devices, name, optax.sgd(0.1),
                                         False, 3)
            cache[name] = (losses, jax.tree.map(np.asarray, params))
        return cache[name]
    return get


def test_init_and_batch_are_bit_identical(cpu_devices):
    jcfg, tcfg = jcompose.LMConfig(**_CFG), tcompose.LMConfig(**_CFG)
    jm = jcompose.compose_parallelism(4, devices=cpu_devices[:4])
    tm = tcompose.compose_parallelism(4, device="cpu")
    jp = jcompose.init_lm_params(jcfg, jm, seed=3)
    tp = tcompose.init_lm_train_params(tcfg, tm, seed=3)
    for group in ("blocks", "shared"):
        for k, v in jp[group].items():
            assert np.array_equal(tp[group][k].numpy(), np.asarray(v)), k
    for steps in (None, 2):
        assert np.array_equal(
            tcompose.make_lm_batch(tcfg, tm, seed=5, steps=steps).numpy(),
            np.asarray(jcompose.make_lm_batch(jcfg, jm, seed=5,
                                              steps=steps)))
    assert tm.describe() == jm.describe()
    np.testing.assert_array_equal(tm.effective_mixing(),
                                  jm.effective_mixing())
    assert tcfg.flops_per_token() == jcfg.flops_per_token()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", STRATEGIES)
def test_sgd_trajectories_match_jax(jax_sgd, name, use_pallas):
    jlosses, jparams = jax_sgd(name)
    tlosses, tparams, _ = _port_run(name, topt.sgd(0.1), use_pallas, 3)
    for t, j in zip(tlosses, jlosses):
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for group in ("blocks", "shared"):
        for k, v in jparams[group].items():
            np.testing.assert_allclose(tparams[group][k].numpy(), v,
                                       rtol=0, atol=1e-5, err_msg=k)


def test_adam_delayed_losses_match_jax_pallas(cpu_devices):
    jlosses, _, _ = _jax_run(cpu_devices, "awc_delayed", optax.adam(5e-3),
                             True, 3)
    for use_pallas in (True, False):
        tlosses, _, _ = _port_run("awc_delayed", topt.adam(5e-3),
                                  use_pallas, 3)
        for t, j in zip(tlosses, jlosses):
            np.testing.assert_allclose(t, j, rtol=1e-4)
    assert jlosses[-1].mean() < jlosses[0].mean()


def test_state_carried_across_from_jax(cpu_devices):
    jl, jparams, jstate = _jax_run(cpu_devices, "awc_delayed",
                                   optax.adam(5e-3), False, 2)
    cfg, m, strat, step = _port_setup("awc_delayed", topt.adam(5e-3), False)
    host = jax.tree.map(np.asarray, (jparams, jstate))
    params = tcompose.params_from_jax(host[0], cfg, device="cpu",
                                      stacked=True)
    state = topt.state_from_jax(host[1], strat, params)
    assert state.step == 2
    slot = state.opt_state.param_groups[0]["params"][0]
    assert float(state.opt_state.state[slot]["step"]) == 2.0
    np.testing.assert_array_equal(state.comm_state["blocks"]["w1"].numpy(),
                                  host[1].comm_state["blocks"]["w1"])
    toks = tcompose.make_lm_batch(cfg, m)
    tl = []
    for _ in range(2):
        params, state, loss = step(params, state, toks)
        tl.append(loss.numpy())
    jl, _, _ = _jax_run(cpu_devices, "awc_delayed", optax.adam(5e-3), False,
                        2, params=jparams, state=jstate)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t, j, rtol=1e-4)


def test_strategy_contracts():
    sched = tcompose.compose_parallelism(4, device="cpu").schedule
    comm = topt.neighbor_communicator(sched)
    with pytest.raises(ValueError, match="cannot be pipelined"):
        topt.adapt_then_combine(topt.sgd(0.1), comm, delayed=True)
    with pytest.raises(ValueError, match="num_steps_per_communication"):
        topt.adapt_with_combine(topt.sgd(0.1), comm, delayed=True,
                                num_steps_per_communication=2)
    with pytest.raises(ValueError, match="exactly one"):
        topt.neighbor_communicator()
    with pytest.raises(ValueError, match="not yet ported"):
        topt.neighbor_communicator(schedules=[sched])
    with pytest.raises(ValueError, match="not yet ported"):
        topt.neighbor_communicator(sched, wire="bf16")
    with pytest.raises(ValueError, match="reuse_batch requires"):
        topt.make_train_step(lambda p, b: None,
                             topt.gradient_allreduce(topt.sgd(0.1)),
                             reuse_batch=True)
    with pytest.raises(ValueError, match="not yet ported"):
        tcompose.compose_parallelism(2, 1, 1, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="gossip topology has 3 nodes"):
        tcompose.compose_parallelism(
            4, device="cpu", topology=lambda d: __import__(
                "bluefog_tpu_torch.topology").topology.RingGraph(3))
    with pytest.raises(ValueError, match="dp=1 carving"):
        tcompose.compose_parallelism(1, device="cpu", wire="bf16")
    with pytest.raises(ValueError, match="must be a positive int"):
        tcompose.compose_parallelism(0, device="cpu")


def test_every_k_and_fused_steps():
    # communicate every 2nd step; a fused 2-step call with a steps axis
    # equals two single-step calls with the same batches
    cfg = tcompose.LMConfig(**_CFG)
    m = tcompose.compose_parallelism(4, device="cpu")
    toks = tcompose.make_lm_batch(cfg, m, steps=2)
    grad_fn = tcompose.make_lm_grad_fn(cfg, m)
    runs = []
    for fused in (False, True):
        comm = topt.neighbor_communicator(m.schedule)
        strat = topt.adapt_with_combine(topt.sgd(0.1), comm,
                                        num_steps_per_communication=2)
        step = topt.make_train_step(grad_fn, strat,
                                    steps_per_call=2 if fused else 1)
        params = tcompose.init_lm_train_params(cfg, m)
        state = topt.init_distributed(strat, params)
        if fused:
            params, state, loss = step(params, state, toks)
        else:
            losses = []
            for t in range(2):
                params, state, l_ = step(params, state, toks[:, t])
                losses.append(l_)
            loss = torch.stack(losses, 1)
        assert state.step == 2 and loss.shape == (4, 2)
        runs.append((loss, params["blocks"]["wo"]))
    assert torch.allclose(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert torch.allclose(runs[0][1], runs[1][1], rtol=0, atol=0)


def test_lm_bench_cli_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools.lm_bench",
         "--device", "cpu", "--iters", "3", "--pallas"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    # the JAX tool's default carving: dp 2 x pp 2 x tp 2, layers 1 a stage
    assert doc["device"] == "cpu" and doc["mesh"]["dp"] == 2
    assert (doc["mesh"]["pp"], doc["mesh"]["tp"], doc["mesh"]["sp"]) == \
        (2, 2, 1)
    assert doc["config"]["seq"] == 32 and doc["config"]["pallas"]
    assert doc["config"]["micro"] == 4
    assert doc["tokens_per_step"] == 2 * 4 * 2 * 32
    assert doc["loss_decreased"] and doc["per_step_s"] > 0
    assert doc["mfu"]["mfu"] is None and doc["peak_mem_gb"] is None
    assert doc["mfu"]["flops_per_token"] == tcompose.LMConfig(
        vocab=64, d_model=32, heads=4, layers=2).flops_per_token()
