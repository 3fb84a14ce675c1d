"""The port's stateful train step and its step wrapper against the JAX
package on the CPU.

* ``make_stateful_train_step`` with ``state_sync`` None, ``"neighbor"``
  (the context's schedule and a given ring), and ``"allreduce"`` equals
  JAX's in float64 within 1e-12 x max|leaf|: the params, the float net
  state (a running mean of the hidden activations), and an int32 counter
  leaf that is never averaged; at ``steps_per_call=3`` with a steps axis
  and with ``reuse_batch``.  JAX's own step refuses ``"allreduce"`` at
  ``steps_per_call > 1`` (its ``lax.scan`` carry leaves the ``pmean``
  replicated, not rank-varying), so that sync is held to JAX at one step
  a call.
* JAX's refusals keep their texts (an unknown ``state_sync``, a schedule
  without ``"neighbor"``, syncing under a hierarchical strategy,
  ``metrics_every_k`` < 1 or on a hierarchical strategy, ``overlap=True``
  without a pipelined strategy, ``reuse_batch`` at one step).
* The wrapper's effects: ``step_begin`` / ``step_end`` flight events,
  ``record_step``'s metrics, the ``train_step`` span when tracing is
  armed, and with ``metrics_every_k=2`` the consensus probe on calls 1, 2
  and 4 (its gauges and spans), as JAX's wrapper samples; an exception
  records a ``failure`` event.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu.optimizers as jopt
from bluefog_tpu import schedule as jsch
from bluefog_tpu import topology as jtopo
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jmetrics
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import schedule as tsch
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.fusion import tree_flatten, tree_unflatten
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tmetrics
from bluefog_tpu_torch.utils import tracing as ttracing
import torch_cpu_threads  # noqa: F401  (the worker's thread share)
from torch_oracle import (N, DH, host, jax_grad_fn, port_grad_fn, problem,
                          tensors)

SPC = 3
CALLS = 2


@pytest.fixture(autouse=True)
def _clean():
    for m in (jmetrics, tmetrics):
        m.reset_metrics()
    for f in (jflight, tflight):
        f.reset()
    ttracing.reset()
    yield
    for m in (jmetrics, tmetrics):
        m.reset_metrics()
    for f in (jflight, tflight):
        f.reset()
    ttracing.reset()


def _jgrad3(p, ns, batch):
    x, y = batch

    def loss_fn(q):
        h = jax.nn.relu(x @ q["Dense_0"]["kernel"] + q["Dense_0"]["bias"])
        logits = h @ q["Dense_1"]["kernel"] + q["Dense_1"]["bias"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), h

    (loss, h), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
    new = {"mean": 0.9 * ns["mean"] + 0.1 * h.mean(0),
           "count": ns["count"] + 1}
    return loss, g, new


def _tgrad3(p, ns, batch):
    x, y = batch
    leaves, treedef = tree_flatten(p)
    ps = [t.detach().requires_grad_() for t in leaves]
    q = tree_unflatten(treedef, ps)
    h = torch.relu(x @ q["Dense_0"]["kernel"] + q["Dense_0"]["bias"])
    logits = h @ q["Dense_1"]["kernel"] + q["Dense_1"]["bias"]
    loss = torch.nn.functional.cross_entropy(logits, y)
    grads = torch.autograd.grad(loss, ps)
    new = {"mean": 0.9 * ns["mean"] + 0.1 * h.detach().mean(0),
           "count": ns["count"] + 1}
    return loss.detach(), tree_unflatten(treedef, list(grads)), new


def _data(reuse):
    x, y, p0 = problem()
    rng = np.random.default_rng(5)
    if not reuse:
        x = rng.normal(size=(N, SPC) + x.shape[1:])
        y = rng.integers(0, 5, size=(N, SPC) + y.shape[1:])
    ns0 = {"mean": rng.normal(size=(N, DH)),
           "count": np.zeros((N,), np.int32)}
    return x, y, p0, ns0


# (id, state_sync, ring schedule, steps a call, reuse_batch)
CASES = [(f"{tag}-{'reuse' if reuse else 'steps'}", sync, ring, SPC, reuse)
         for tag, sync, ring in (("none", None, False),
                                 ("neighbor", "neighbor", False),
                                 ("neighbor_ring", "neighbor", True))
         for reuse in (False, True)] + [
    ("allreduce-one_step", "allreduce", False, 1, False)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stateful_step_matches_jax(cpu_devices, case):
    _, state_sync, ring, spc, reuse = case
    x, y, p0, ns0 = _data(reuse or spc == 1)
    want = []
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N])
        try:
            jbf.set_topology(jtopo.ExponentialTwoGraph(N), is_weighted=True)
            strat = jopt.adapt_with_combine(
                optax.sgd(0.1, momentum=0.9),
                jopt.neighbor_communicator(jbf.static_schedule()))
            step = jopt.make_stateful_train_step(
                _jgrad3, strat, steps_per_call=spc, reuse_batch=reuse,
                donate=False, state_sync=state_sync,
                state_sync_schedule=(jsch.compile_topology(
                    jtopo.RingGraph(N)) if ring else None))
            params = jopt.replicate(jax.tree.map(jnp.asarray, p0), N)
            ns = jax.tree.map(jnp.asarray, ns0)
            ds = jopt.init_distributed(strat, params)
            batch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
            for _ in range(CALLS):
                params, ns, ds, loss = step(params, ns, ds, batch)
                want.append((host(params), host(ns), np.asarray(loss)))
        finally:
            jbf.shutdown()
    tctx.init(size=N, device="cpu")
    try:
        tctx.set_topology(ttopo.ExponentialTwoGraph(N), is_weighted=True)
        strat = topt.adapt_with_combine(
            topt.sgd(0.1, momentum=0.9),
            topt.neighbor_communicator(tctx.static_schedule()))
        step = topt.make_stateful_train_step(
            _tgrad3, strat, steps_per_call=spc, reuse_batch=reuse,
            state_sync=state_sync,
            state_sync_schedule=(tsch.compile_topology(ttopo.RingGraph(N))
                                 if ring else None))
        params = topt.replicate(tensors(p0), N)
        ns = tensors(ns0)
        ds = topt.init_distributed(strat, params)
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        for c in range(CALLS):
            params, ns, ds, loss = step(params, ns, ds, batch)
            wp, wns, wloss = want[c]
            for g, w in zip(tree_flatten(params)[0], jax.tree.leaves(wp)):
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max(),
                    err_msg=f"params, call {c + 1}")
            np.testing.assert_allclose(
                ns["mean"].numpy(), wns["mean"], rtol=0,
                atol=1e-12 * np.abs(wns["mean"]).max())
            assert ns["count"].dtype == torch.int32
            np.testing.assert_array_equal(ns["count"].numpy(), wns["count"])
            assert (ns["count"].numpy() == (c + 1) * spc).all()
            np.testing.assert_allclose(loss.numpy(), wloss, rtol=1e-12)
            assert tuple(loss.shape) == ((N, spc) if spc > 1 else (N,))
        if state_sync == "allreduce":
            m = ns["mean"]
            assert float((m - m[:1]).abs().max()) < 1e-12
    finally:
        tctx.shutdown()


def _texts(cpu_devices, build_j, build_t, npm=None):
    jbf.init(devices=cpu_devices[:N], nodes_per_machine=npm)
    try:
        with pytest.raises(Exception) as ej:
            build_j()
    finally:
        jbf.shutdown()
    tctx.init(size=N, device="cpu", nodes_per_machine=npm)
    try:
        with pytest.raises(Exception) as et:
            build_t()
    finally:
        tctx.shutdown()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)
    return str(et.value)


def _hier_strat(opt_mod, bf_mod, topo_mod, opt):
    bf_mod.set_machine_topology(topo_mod.RingGraph(2), is_weighted=True)
    return opt_mod.DistributedHierarchicalNeighborAllreduceOptimizer(opt)


REFUSALS = {
    "unknown_sync": dict(state_sync="bogus"),
    "schedule_without_neighbor": dict(state_sync="allreduce",
                                      state_sync_schedule="ring"),
    "sync_hierarchical": dict(state_sync="neighbor", hier=True),
    "metrics_k_zero": dict(metrics_every_k=0),
    "metrics_k_hierarchical": dict(metrics_every_k=2, hier=True),
    "overlap": dict(overlap=True),
    "reuse_one_step": dict(reuse_batch=True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_keep_the_jax_texts(cpu_devices, case):
    kw = dict(REFUSALS[case])
    hier = kw.pop("hier", False)

    def build(opt_mod, bf_mod, topo_mod, sch_mod, opt, stateful):
        k = dict(kw)
        if k.get("state_sync_schedule") == "ring":
            k["state_sync_schedule"] = sch_mod.compile_topology(
                topo_mod.RingGraph(N))
        strat = (_hier_strat(opt_mod, bf_mod, topo_mod, opt) if hier else
                 opt_mod.adapt_with_combine(opt, opt_mod.neighbor_communicator(
                     bf_mod.static_schedule())))
        extra = {"donate": False} if opt_mod is jopt else {}
        if stateful:
            return opt_mod.make_stateful_train_step(
                _jgrad3 if opt_mod is jopt else _tgrad3, strat, **k, **extra)
        k.pop("state_sync", None)
        k.pop("state_sync_schedule", None)
        return opt_mod.make_train_step(
            jax_grad_fn if opt_mod is jopt else port_grad_fn, strat, **k,
            **extra)

    kinds = (True, False) if "state_sync" not in kw else (True,)
    for stateful in kinds:
        _texts(cpu_devices,
               lambda: build(jopt, jbf, jtopo, jsch, optax.sgd(0.1),
                             stateful),
               lambda: build(topt, tctx, ttopo, tsch, topt.sgd(0.1),
                             stateful),
               npm=4 if hier else None)


def _events(mod, kind):
    return [e for e in mod.events() if e["kind"] == kind]


def test_wrapper_effects_match_jax(cpu_devices, tmp_path):
    """Four calls with ``metrics_every_k=2``: both wrappers record the
    same step events, steps, probes (calls 1, 2 and 4) and gauges."""
    x, y, p0 = problem()
    calls = 4
    with jax.enable_x64(True):
        jbf.init(devices=cpu_devices[:N])
        try:
            strat = jopt.adapt_with_combine(
                optax.sgd(0.1), jopt.neighbor_communicator(
                    jbf.static_schedule()))
            step = jopt.make_train_step(jax_grad_fn, strat, donate=False,
                                        metrics_every_k=2)
            params = jopt.replicate(jax.tree.map(jnp.asarray, p0), N)
            state = jopt.init_distributed(strat, params)
            batch = (jnp.asarray(x), jnp.asarray(y, jnp.int32))
            jprobe = []
            for _ in range(calls):
                params, state, _ = step(params, state, batch)
                jprobe.append(jmetrics.gauge(
                    "bluefog_consensus_distance_max").value())
        finally:
            jbf.shutdown()
    ttracing.configure(str(tmp_path))
    tctx.init(size=N, device="cpu")
    try:
        strat = topt.adapt_with_combine(
            topt.sgd(0.1), topt.neighbor_communicator(
                tctx.static_schedule()))
        step = topt.make_train_step(port_grad_fn, strat, metrics_every_k=2)
        params = topt.replicate(tensors(p0), N)
        state = topt.init_distributed(strat, params)
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        tprobe = []
        for _ in range(calls):
            params, state, _ = step(params, state, batch)
            tprobe.append(tmetrics.gauge(
                "bluefog_consensus_distance_max").value())
        spans = ttracing.spans()
        # an exception inside the step is a failure event, then re-raised
        with pytest.raises(RuntimeError):
            step(params, state, (batch[0][:, :, :3], batch[1]))
    finally:
        tctx.shutdown()
    for kind in ("step_begin", "step_end", "consensus"):
        got, want = _events(tflight, kind), _events(jflight, kind)
        assert len(got) == len(want) + (kind == "step_begin"), kind
    assert [e["step"] for e in _events(tflight, "step_end")] == [1, 2, 3, 4]
    assert [e["step"] for e in _events(tflight, "step_begin")] == \
        [1, 2, 3, 4, 5]
    fail = _events(tflight, "failure")
    assert len(fail) == 1 and fail[0]["step"] == 5
    # the probe ran on calls 1, 2 and 4 on both sides, on equal params
    assert [v is not None for v in tprobe] == [v is not None for v in jprobe]
    np.testing.assert_allclose(tprobe[-1], jprobe[-1], rtol=1e-5)
    for name in ("bluefog_train_steps_total", "bluefog_step_fused_k",
                 "bluefog_step_overlap", "bluefog_consensus_distance_mean",
                 "bluefog_neighbor_disagreement_max",
                 "bluefog_step_time_ewma_s", "bluefog_step_donated"):
        tm, jm = tmetrics.get_metric(name), jmetrics.get_metric(name)
        assert tm is not None and jm is not None, name
        assert tm.help == jm.help and tm.kind == jm.kind, name
    assert tmetrics.counter("bluefog_train_steps_total").value() == calls
    hist = tmetrics.get_metric("bluefog_step_time_s").dump()
    assert hist["count"] == calls
    names = [s["name"] for s in spans]
    assert names.count("train_step") == calls
    assert names.count("consensus_probe") == 3
    assert tmetrics.in_steady_state()
