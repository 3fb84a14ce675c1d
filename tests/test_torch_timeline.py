"""The port's timeline (``bluefog_tpu_torch/utils/timeline.py``, the
native writer of ``_native/timeline.cc``) against the JAX package's
``utils/timeline.py``, as ``tests/test_timeline_integration.py`` and
``tests/test_native.py`` drive it:

* ``BLUEFOG_TIMELINE`` at ``init``, one CTA train step and three eager
  ops: the activity names (COMMUNICATE, ADAPT, GRADIENT) and the op
  categories are JAX's; the stateful step adds STATE_SYNC; every event
  is a complete span;
* the timeline off: the op API writes nothing and ``stop`` returns None;
* manual spans, a span left open closed at stop, ``record_span`` from
  another thread, the native writer taking a 50,000-event burst without
  a drop, and the Python path when the native one is off;
* ``tools/timeline_merge.py`` reads the port's file: one process row per
  input;
* the stall watchdog's counter and STALL span.
"""
import importlib.util
import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import optimizers as jopt
from bluefog_tpu import topology as jtu
from bluefog_tpu.utils import timeline as jtl
from bluefog_tpu_torch import _native as tnative
from bluefog_tpu_torch import api as tapi
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.utils import metrics as tm
from bluefog_tpu_torch.utils import timeline as ttl
from bluefog_tpu_torch.utils import watchdog as twd
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, D = 8, 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    ttl.stop_timeline()
    tm.reset_metrics()
    yield
    ttl.stop_timeline()
    tm.reset_metrics()


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _jax_run(cpu_devices, prefix, stateful):
    jbf.init(devices=cpu_devices)
    jbf.set_topology(jtu.ExponentialTwoGraph(N), is_weighted=True)
    assert jtl.start_timeline(prefix, with_device_trace=False)
    try:
        strat = jopt.DistributedAdaptWithCombineOptimizer(
            optax.sgd(0.05), communication_type="neighbor_allreduce")
        params = jopt.replicate({"w": jnp.zeros((D,), jnp.float32)})
        state = jopt.init_distributed(strat, params)
        batch = jnp.broadcast_to(jnp.arange(float(N))[:, None],
                                 (N, D)).astype(jnp.float32)
        if stateful:
            def sgrad(p, ns, b):
                loss = jnp.mean((p["w"] - b) ** 2)
                g = jax.grad(lambda q: jnp.mean((q["w"] - b) ** 2))(p)
                return loss, g, {"ema": 0.9 * ns["ema"] + 0.1 * loss}
            ns = jopt.replicate({"ema": jnp.zeros((), jnp.float32)})
            step = jopt.make_stateful_train_step(sgrad, strat,
                                                 state_sync="neighbor")
            out = step(params, ns, state, batch)
        else:
            step = jopt.make_train_step(
                lambda p, b: jax.value_and_grad(
                    lambda q: jnp.mean((q["w"] - b) ** 2))(p), strat)
            out = step(params, state, batch)
            x = jbf.shard_distributed(batch)
            jbf.synchronize(jbf.neighbor_allreduce(x))
            jbf.synchronize(jbf.allreduce(x))
            jbf.synchronize(jbf.broadcast(x, 0))
        jax.block_until_ready(out)
    finally:
        path = jtl.stop_timeline()
        jbf.shutdown()
    return _events(path)


def _port_run(prefix, stateful, monkeypatch):
    monkeypatch.setenv(ttl.ENV_VAR, prefix)
    tctx.init(size=N, device="cpu")
    monkeypatch.delenv(ttl.ENV_VAR)
    try:
        assert ttl.active()
        tctx.set_topology(ttu.ExponentialTwoGraph(N), is_weighted=True)
        strat = topt.DistributedAdaptWithCombineOptimizer(
            topt.sgd(0.05), communication_type="neighbor_allreduce")
        params = topt.replicate({"w": torch.zeros(D)}, N)
        state = topt.init_distributed(strat, params)
        batch = torch.arange(float(N))[:, None].expand(N, D).contiguous()

        def grad(p, b):
            w = p["w"].detach().requires_grad_()
            loss = torch.mean((w - b) ** 2)
            return loss.detach(), {"w": torch.autograd.grad(loss, w)[0]}

        if stateful:
            def sgrad(p, ns, b):
                loss, g = grad(p, b)
                return loss, g, {"ema": 0.9 * ns["ema"] + 0.1 * loss}
            ns = topt.replicate({"ema": torch.zeros(())}, N)
            step = topt.make_stateful_train_step(sgrad, strat,
                                                 state_sync="neighbor")
            step(params, ns, state, batch)
        else:
            step = topt.make_train_step(grad, strat)
            step(params, state, batch)
            tapi.neighbor_allreduce(batch)
            tapi.allreduce(batch)
            tapi.broadcast(batch, 0)
    finally:
        tctx.shutdown()                       # flushes the timeline
    assert not ttl.active()
    return _events(prefix + ".activities.json")


@pytest.mark.parametrize("stateful", [False, True],
                         ids=["cta_and_ops", "stateful"])
def test_activity_names_equal_jax(cpu_devices, tmp_path, monkeypatch,
                                  stateful):
    want = _jax_run(cpu_devices, str(tmp_path / "j"), stateful)
    got = _port_run(str(tmp_path / "t"), stateful, monkeypatch)
    names = {e["name"] for e in got}
    assert {e["name"] for e in want} <= names
    assert {"COMMUNICATE", "ADAPT", "GRADIENT"} <= names
    if stateful:
        assert "STATE_SYNC" in names
    else:
        assert {e["cat"] for e in want} - {"train_step"} <= \
            {e["cat"] for e in got}
        assert {"neighbor_allreduce", "allreduce", "broadcast"} <= \
            {e["cat"] for e in got}
    for e in got:
        assert e["ph"] == "X" and e["dur"] >= 0


def test_timeline_off_means_no_artifact(tmp_path):
    tctx.init(size=N, device="cpu")
    try:
        tapi.neighbor_allreduce(torch.ones(N, D))
        assert not ttl.active()
        assert not ttl.timeline_start_activity("x")
        assert not ttl.record_span("x", "Y", 0.0, 1.0)
        assert ttl.stop_timeline() is None
    finally:
        tctx.shutdown()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_spans_open_spans_and_threads(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(tnative, "timeline_start", lambda path: False)
    prefix = str(tmp_path / "tl")
    assert ttl.start_timeline(prefix, with_device_trace=False)
    assert not ttl.start_timeline(prefix)           # already running
    assert ttl.native_active() == native
    with ttl.timeline_context("param0", "COMMUNICATE"):
        pass
    with ttl.op_span("allreduce"):
        pass
    t = threading.Thread(target=lambda: ttl.record_span(
        "watch", "STALL", ttl._now_us() - 5.0, 5.0))
    t.start()
    t.join(5)
    assert not t.is_alive()
    assert ttl.timeline_start_activity("param1", "ADAPT")   # left open
    path = ttl.stop_timeline()
    events = _events(path)
    pairs = {(e["cat"], e["name"]) for e in events}
    assert {("param0", "COMMUNICATE"), ("allreduce", "COMMUNICATE"),
            ("watch", "STALL"), ("param1", "ADAPT")} <= pairs
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert ttl.device_trace_path() is None          # no card here


def test_native_writer_volume(tmp_path):
    assert tnative.available(), tnative.build_error()
    out = str(tmp_path / "burst.json")
    assert tnative.timeline_start(out)
    n = 50_000
    for i in range(n):
        assert tnative.timeline_record("evt", "cat", "X", i, 1, 1, 1)
    assert tnative.timeline_stop() == 0
    assert len(_events(out)) == n


def test_timeline_merge_reads_the_port_file(tmp_path):
    paths = []
    for r in range(2):
        prefix = str(tmp_path / f"rank{r}")
        ttl.start_timeline(prefix, with_device_trace=False)
        with ttl.op_span("neighbor_allreduce"):
            pass
        paths.append(ttl.stop_timeline())
    spec = importlib.util.spec_from_file_location(
        "timeline_merge", ROOT / "tools" / "timeline_merge.py")
    merge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(merge)
    doc = merge.merge(paths)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    rows = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert [e["pid"] for e in spans] == [0, 1] and len(rows) == 2
    assert all(e["cat"] == "neighbor_allreduce" for e in spans)


def test_watchdog_stall_counter_and_span(tmp_path, monkeypatch):
    prefix = str(tmp_path / "wd")
    assert ttl.start_timeline(prefix, with_device_trace=False)
    try:
        monkeypatch.setattr(twd, "_block", lambda x: (time.sleep(0.3), x)[1])
        assert twd.synchronize_with_watchdog(7, interval=0.05,
                                             name="stalltest") == 7
    finally:
        out = ttl.stop_timeline()
    assert tm.counter("bluefog_watchdog_stalls_total").value(
        name="stalltest") >= 1
    spans = [e for e in _events(out)
             if e["name"] == "STALL" and e["cat"] == "stalltest"]
    assert spans and all(e["dur"] > 0 for e in spans)
    x = torch.arange(8.0)
    assert twd.synchronize_with_watchdog(x * 2, interval=60.0) is not None
    np.testing.assert_allclose(
        twd.synchronize_with_watchdog(x * 2, interval=60.0,
                                      timeout=30.0).numpy(),
        np.arange(8.0) * 2)
