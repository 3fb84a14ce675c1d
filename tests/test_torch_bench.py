"""The port's ResNet-50 gossip bench and its optimizer pieces against the
JAX package, on the CPU.

* ``sgd(0.1, momentum=0.9)`` (and nesterov) under adapt-with-combine over
  4 stacked ranks (weighted Exp2, rank-varying starts) equals optax under
  the JAX strategy on 4 virtual devices for 5 steps, in float64 (1e-12);
* ``state_from_jax`` carries optax's momentum ``trace`` and both sides go
  on equal;
  ``replicate`` stacks independent copies;
* the bench's first call (2 steps, 2 ranks) has bench.py's losses:
  its ``grad_fn`` rebuilt as in ``bench.py:450-467`` on the same f32
  ResNet-50 variables at 32 x 32, then optax's update (rtol 1e-5); the
  BatchNorm running statistics stay bit for bit at init (zero
  gradients, and the combine of equal ranks at weights 1/2 is exact);
* the CLI's ``main`` (``python -m bluefog_tpu_torch.tools.bench
  --device cpu``), run in process at the tiny flags, prints one JSON
  line with every schema key.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu.optimizers as jopt
from bluefog_tpu import models as jm
from bluefog_tpu import topology as jtopo
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.fusion import tree_flatten
from bluefog_tpu_torch.models import (ResNet50, variables_from_jax,
                                      variables_to_jax)
from bluefog_tpu_torch.tools import bench
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 4
KEYS = {"schema", "metric", "value", "unit", "vs_baseline", "ok",
        "strategy", "on_accelerator", "device", "n_chips", "batch_per_chip",
        "mfu", "steps_per_call", "image_size", "num_classes", "step_flops",
        "n_ranks", "power_limit_w", "per_step_s", "loss_first", "loss_last"}


def _problem():
    """Per-rank least squares: rank r fits ``A_r w + c ~ y_r``."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(N, 6, 3))
    y = rng.normal(size=(N, 6, 2))
    w0 = rng.normal(size=(N, 3, 2))
    c0 = rng.normal(size=(N, 2))
    return A, y, w0, c0


def _jax_run(cpu_devices, steps, nesterov=False, resume=None):
    A, y, w0, c0 = _problem()
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N])
        try:
            jbf.set_topology(jtopo.ExponentialTwoGraph(N), is_weighted=True)

            def grad_fn(p, batch):
                a, t = batch
                loss_fn = lambda p: 0.5 * jnp.mean(
                    (a @ p["w"] + p["c"] - t) ** 2)
                return jax.value_and_grad(loss_fn)(p)

            strat = jopt.adapt_with_combine(
                optax.sgd(0.1, momentum=0.9, nesterov=nesterov),
                jopt.neighbor_communicator(jbf.static_schedule()))
            step = jopt.make_train_step(grad_fn, strat, donate=False)
            params = {"w": jnp.asarray(w0), "c": jnp.asarray(c0)}
            state = jopt.init_distributed(strat, params)
            if resume is not None:
                params, state = resume
            batch = (jnp.asarray(A), jnp.asarray(y))
            hist = []
            for _ in range(steps):
                params, state, loss = step(params, state, batch)
                hist.append((np.asarray(loss),
                             jax.tree.map(np.asarray, params)))
            return hist, (params, state)
        finally:
            jbf.shutdown()


def _port_strategy(nesterov=False):
    tbf.init(size=N, device="cpu")
    tbf.set_topology(ttopo.ExponentialTwoGraph(N), is_weighted=True)
    strat = topt.adapt_with_combine(
        topt.sgd(0.1, momentum=0.9, nesterov=nesterov),
        topt.neighbor_communicator(tbf.static_schedule()))
    tbf.shutdown()

    def grad_fn(p, batch):
        a, t = batch
        w = p["w"].detach().requires_grad_()
        c = p["c"].detach().requires_grad_()
        loss = 0.5 * ((a @ w + c - t) ** 2).mean()
        gw, gc = torch.autograd.grad(loss, (w, c))
        return loss.detach(), {"w": gw, "c": gc}
    return strat, topt.make_train_step(grad_fn, strat)


def _to_port(tree):
    return {k: np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_under_awc_matches_optax(cpu_devices, nesterov):
    want, _ = _jax_run(cpu_devices, 5, nesterov)
    A, y, w0, c0 = _problem()
    strat, step = _port_strategy(nesterov)
    params = {k: torch.from_numpy(v.copy())
              for k, v in _to_port({"w": w0, "c": c0}).items()}
    state = topt.init_distributed(strat, params)
    batch = (torch.from_numpy(A), torch.from_numpy(y))
    for loss_j, params_j in want:
        params, state, loss = step(params, state, batch)
        np.testing.assert_allclose(loss.numpy(), loss_j, rtol=1e-12, atol=0)
        for k, v in _to_port(params_j).items():
            np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                       atol=1e-12)


def test_sgd_is_torch_sgd_without_dampening():
    opt = topt.sgd(0.1, momentum=0.9)([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert (group["lr"], group["momentum"], group["dampening"],
            group["nesterov"]) == (0.1, 0.9, 0.0, False)
    plain = topt.sgd(0.1)([torch.zeros(2, requires_grad=True)])
    assert plain.param_groups[0]["momentum"] == 0


def test_state_from_jax_carries_the_momentum(cpu_devices):
    _, carried = _jax_run(cpu_devices, 2)
    rest, _ = _jax_run(cpu_devices, 3, resume=carried)
    jparams, jstate = carried
    strat, step = _port_strategy()
    params = {k: torch.from_numpy(v.copy())
              for k, v in _to_port(jparams).items()}
    state = topt.state_from_jax(jstate, strat, params)
    assert state.step == 2
    slots = state.opt_state.param_groups[0]["params"]
    trace = jstate.opt_state[0].trace
    for p, (k, v) in zip(slots, sorted(_to_port(trace).items())):
        assert np.array_equal(state.opt_state.state[p]["momentum_buffer"]
                              .numpy(), v), k
    A, y, _, _ = _problem()
    batch = (torch.from_numpy(A), torch.from_numpy(y))
    for loss_j, params_j in rest:
        params, state, loss = step(params, state, batch)
        np.testing.assert_allclose(loss.numpy(), loss_j, rtol=1e-12, atol=0)
        for k, v in _to_port(params_j).items():
            np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                       atol=1e-12)


def test_replicate_stacks_independent_copies():
    tree = {"a": torch.arange(6.).reshape(2, 3), "b": {"c": torch.ones(())}}
    rep = topt.replicate(tree, 3)
    assert rep["a"].shape == (3, 2, 3) and rep["b"]["c"].shape == (3,)
    assert all(torch.equal(rep["a"][r], tree["a"]) for r in range(3))
    rep["a"][0] += 1
    assert torch.equal(rep["a"][1], tree["a"])
    assert torch.equal(tree["a"], torch.arange(6.).reshape(2, 3))


@pytest.fixture(scope="module")
def jax_bench_losses():
    """bench.py's grad_fn (:450-467) on its data (all-ones images, label
    0) for an f32 ResNet-50 at 32 x 32, 10 classes, batch 2; step 2's loss
    after optax's sgd(0.1, momentum=0.9) update.  The variables are the
    port's own init in flax's layout (flax's distributions)."""
    model = jm.ResNet50(num_classes=10, dtype=jnp.float32)
    image = jnp.ones((2, 32, 32, 3), jnp.float32)
    labels = jnp.zeros((2,), jnp.int32)
    own = ResNet50(num_classes=10, generator=torch.Generator().manual_seed(3))
    variables = variables_to_jax(own, own.variables())
    params, batch_stats = variables["params"], variables["batch_stats"]

    def grad_fn(train_state, data):
        params, batch_stats = train_state["params"], train_state["bs"]
        images, labels = data

        def loss_fn(p):
            logits, updates = model.apply(
                {"params": p, "batch_stats": batch_stats}, images,
                train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()
            return loss, updates["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return loss, {"params": grads,
                      "bs": jax.tree.map(jnp.zeros_like, new_bs)}

    opt = optax.sgd(0.1, momentum=0.9)
    state = {"params": params, "bs": batch_stats}
    # backend optimization level 0 compiles ResNet-50 ~3x faster
    step_grads = jax.jit(grad_fn).lower(state, (image, labels)).compile(
        {"xla_backend_optimization_level": 0})
    opt_state = opt.init(state)
    losses = []
    for _ in range(2):
        loss, grads = step_grads(state, (image, labels))
        updates, opt_state = opt.update(grads, opt_state, state)
        state = optax.apply_updates(state, updates)
        losses.append(float(loss))
    return np.asarray(losses, np.float32), variables, own


def test_bench_first_losses_are_bench_py_losses(jax_bench_losses):
    """Two ranks: every rank's two losses are bench.py's, and the
    BatchNorm statistics stay bit for bit at init (zero gradients; the
    combine of equal ranks at weights 1/2 is exact)."""
    want, variables, own = jax_bench_losses
    b = bench.build(ranks=2, batch=2, steps_per_call=2, image_size=32,
                    num_classes=10, device="cpu", dtype=torch.float32,
                    variables=variables_from_jax(own, variables))
    tbf.shutdown()
    params, _, loss = b.step(b.params, b.state, b.data)
    assert loss.shape == (2, 2) and want[1] < want[0]
    for r in range(2):
        np.testing.assert_allclose(loss[r].numpy(), want, rtol=1e-5, atol=0)
    init = tree_flatten(own.variables()["batch_stats"])[0]
    got = tree_flatten(params["bs"])[0]
    assert len(got) == len(init) == 106
    assert all(torch.equal(g[r], w) for g, w in zip(got, init)
               for r in range(2))


def test_bench_cli_tiny_cpu_run(capsys):
    """The CLI in process, at 32 x 32 images."""
    assert bench.main(["--device", "cpu", "--image-size", "32",
                       "--classes", "10", "--batch", "2",
                       "--steps-per-call", "2", "--iters", "1",
                       "--ranks", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert KEYS <= set(doc)
    assert doc["schema"] == "bluefog-torch-bench-1"
    assert doc["metric"] == "resnet50_synthetic_imgs_per_sec_per_chip"
    assert doc["on_accelerator"] is False and doc["device"] == "cpu"
    assert doc["mfu"] is None and doc["power_limit_w"] is None
    assert (doc["n_chips"], doc["n_ranks"], doc["batch_per_chip"],
            doc["steps_per_call"], doc["image_size"]) == (1, 2, 4, 2, 32)
    assert doc["value"] > 0 and np.isfinite(doc["loss_last"])
    assert doc["loss_last"] < doc["loss_first"]
    assert doc["step_flops"] == 3 * 4.089e9 * 2 * 2
