"""The port's gossiped fleet view (``bluefog_tpu_torch/utils/fleetview.py``
on the consensus probe of ``diagnostics.py``) held against the JAX
package's (``tests/test_fleetview.py``):

* the fleet tables every rank holds after each of k probes over Exp2 and
  the ring — through a dead -> admitted churn — equal JAX's exactly (the
  same per-rank signals through the override hook; the carrier rides the
  probe's one neighbor gather and merges by stamp argmax, ties local);
  ``fleet()`` aggregates equal JAX's;
* a burn on rank 5 fires the SLO engine's tripwire fleet-wide with its
  origin; the AutoScaler grows on a remote queue breach and stays calm
  without the fleet signal;
* ``/fleet`` answers 503 disarmed and the view armed, ``/healthz``
  reports ``fleet_armed``; the port's ``fleet_top`` renders a saved and a
  scraped frame (``--from-file``, ``--url --once``);
* a train step built without ``metrics_every_k`` inherits the armed
  cadence, and its counters' fleet sum equals the registry's;
* ``context.init`` arms from ``BLUEFOG_FLEET_EVERY``, ``reinit`` re-arms
  at the new size, and the validation refusals are JAX's;
* the disarmed probe path pays one global read (JAX's pin).
"""
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import diagnostics as jdiag
from bluefog_tpu import resilience as jrz
from bluefog_tpu import topology as jtu
from bluefog_tpu.utils import fleetview as jfv
from bluefog_tpu.utils import metrics as jm
from bluefog_tpu_torch import diagnostics as tdiag
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch import resilience as trz
from bluefog_tpu_torch import topology as ttu
from bluefog_tpu_torch.parallel import context as tctx
from bluefog_tpu_torch.tools import fleet_top
from bluefog_tpu_torch.utils import fleetview as tfv
from bluefog_tpu_torch.utils import metrics as tm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N, D = 8, 16


@pytest.fixture(autouse=True)
def _clean():
    for m in (jm, tm):
        m.reset_metrics()
    for f in (jfv, tfv):
        f.reset()
    yield
    for f in (jfv, tfv):
        f.reset()
    tm.stop_http_server()
    for m in (jm, tm):
        m.reset_metrics()
    for r in (jrz, trz):
        r.reset()
    if tctx.is_initialized():
        tctx.shutdown()


def _spread():
    return np.broadcast_to(np.arange(float(N))[:, None], (N, D)).astype(
        np.float32)


def _override(fv, r):
    """Distinct per-rank values for every scalar of the default spec."""
    for i, (name, _) in enumerate(fv.spec):
        fv.set_rank_override(r, name, float((r + 1) * (i + 2)) / 4.0)


def _view(f):
    """A ``fleet()`` document without its wall-clock estimates (the probe
    cadence and the age in seconds), which differ between two runs."""
    st = {k: v for k, v in f["staleness"].items()
          if k not in ("probe_cadence_s", "age_s_est")}
    return dict(f, staleness=st)


def _tables_equal(a, b):
    return np.array_equal(a._tables, b._tables, equal_nan=True)


@pytest.mark.parametrize("topo", ["exp2", "ring"])
def test_fleet_tables_equal_jax_through_churn(cpu_devices, topo):
    jbf.init(devices=cpu_devices)
    tctx.init(size=N, device="cpu")
    try:
        jbf.set_topology(jtu.ExponentialTwoGraph(N) if topo == "exp2"
                         else jtu.RingGraph(N), is_weighted=True)
        tctx.set_topology(ttu.ExponentialTwoGraph(N) if topo == "exp2"
                          else ttu.RingGraph(N), is_weighted=True)
        jv, tv = jfv.arm(), tfv.arm()
        for r in range(N):
            _override(jv, r)
            _override(tv, r)
        jp = jbf.shard_distributed(_spread())
        tp = torch.from_numpy(_spread().copy())
        diam = tfv._graph_diameter(tctx.static_schedule(), frozenset())
        assert diam == jfv._graph_diameter(jbf.static_schedule(),
                                           frozenset()) >= 2
        for k in range(diam + 1):
            jdiag.diagnose_consensus(jp, record=False)
            out = tdiag.diagnose_consensus(tp, record=False)
            assert _tables_equal(tv, jv), k
        assert _view(out["fleet"]) == _view(jv.fleet())
        for r in range(N):
            assert _view(tv.fleet(rank=r)) == _view(jv.fleet(rank=r))
        c = tv.fleet()["metrics"]["bluefog_train_steps_total"]
        assert c["per_rank"] == {q: (q + 1) * 2 / 4.0 for q in range(N)}

        for rz in (jrz, trz):
            rz.mark_rank_dead(3)
        for k in range(diam + 2):
            jdiag.diagnose_consensus(jp, dead_ranks=(3,), record=False)
            tdiag.diagnose_consensus(tp, dead_ranks=(3,), record=False)
            assert _tables_equal(tv, jv), ("dead", k)
        f = tv.fleet(rank=0)
        assert _view(f) == _view(jv.fleet(rank=0))
        assert f["dead_ranks"] == [3]
        assert 3 not in f["metrics"]["bluefog_train_steps_total"][
            "per_rank"]

        for rz in (jrz, trz):
            rz.admit_rank(3)
        for k in range(diam + 1):
            jdiag.diagnose_consensus(jp, record=False)
            tdiag.diagnose_consensus(tp, record=False)
            assert _tables_equal(tv, jv), ("admit", k)
        assert _view(tv.fleet()) == _view(jv.fleet())
        st = tv.fleet()["staleness"]
        assert st["rounds_max"] <= st["bound_rounds"]
    finally:
        jbf.shutdown()


def test_fleet_breach_fires_tripwire_fleetwide():
    tctx.init(size=N, device="cpu")
    tctx.set_topology(ttu.ExponentialTwoGraph(N), is_weighted=True)
    fv = tfv.arm()
    fv.set_rank_override(5, "bluefog_slo_burn_rate", 50.0)
    tp = torch.from_numpy(_spread().copy())
    for _ in range(tfv._graph_diameter(tctx.static_schedule(),
                                       frozenset())):
        tdiag.diagnose_consensus(tp, record=False)
    for r in range(N):
        assert fv.fleet_max("bluefog_slo_burn_rate", rank=r) == (50.0, 5)
    res = tdiag.SLOEngine().observe()
    fired = [t for t in res["tripwires"] if t["kind"] == "slo_fast_burn"]
    assert fired and fired[0]["slo"] == "fleet"
    assert fired[0]["origin_rank"] == 5
    assert tm.counter("bluefog_tripwire_total").value(
        kind="slo_fast_burn") == 1


class _StubSched:
    def __init__(self, replicas=2, slots=4):
        class _Obj:
            pass
        self.engine = _Obj()
        self.engine.scfg = _Obj()
        self.engine.scfg.slots = slots
        self.engine.m = _Obj()
        self.engine.m.slice_size = 1
        self.replicas = replicas
        self._dead = set()
        self._parked = set()
        self.pending = 0
        self.restored = []

    def live_replicas(self):
        return [r for r in range(self.replicas) if r not in self._dead]

    def restore_replica(self, r):
        self._dead.discard(r)
        self._parked.discard(r)
        self.restored.append(r)
        return True

    def fail_replica(self, r, reason="failed", park=False):
        self._dead.add(r)
        if park:
            self._parked.add(r)
        return []


def _flood_hostside(fv):
    """Every rank's view becomes the stamped own rows of all ranks (what
    diameter probes converge to), without a world."""
    carrier = fv.pre_probe()
    t = carrier.reshape(fv.n, fv.n, fv.row_width)
    rows = np.stack([t[r, r] for r in range(fv.n)])
    fv.post_probe(np.broadcast_to(
        rows, (fv.n, fv.n, fv.row_width)).reshape(fv.n, -1))


def test_autoscaler_acts_on_remote_queue_breach():
    from bluefog_tpu_torch.serve.scheduler import AutoScaler
    fv = tfv.arm(n=N)
    fv.set_rank_override(3, "bluefog_serve_queue_depth", 99.0)
    _flood_hostside(fv)
    sched = _StubSched()
    sched.fail_replica(1, reason="parked", park=True)
    sc = AutoScaler(sched, slo_p99_s=0.25, queue_high=4, cooldown_steps=1)
    ev = sc.observe()
    assert ev and ev["action"] == "grow" and sched.restored == [1]
    tfv.reset()
    sched2 = _StubSched()
    sched2.fail_replica(1, reason="parked", park=True)
    sc2 = AutoScaler(sched2, slo_p99_s=0.25, queue_high=4, cooldown_steps=1)
    assert sc2.observe() is None and sched2.restored == []


def _get(url):
    return json.loads(urllib.request.urlopen(url, timeout=10).read()
                      .decode())


def test_fleet_endpoint_healthz_and_fleet_top(tmp_path, capsys):
    port = tm.start_http_server(0)
    health = _get(f"http://127.0.0.1:{port}/healthz")
    assert health["status"] == "ok" and health["fleet_armed"] is False
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet", timeout=10)
    assert ei.value.code == 503 and b"not armed" in ei.value.read()

    fv = tfv.arm(n=4)
    for r in range(4):
        fv.set_rank_override(r, "bluefog_step_time_ewma_s", 0.1 * (r + 1))
        fv.set_rank_override(r, "bluefog_train_steps_total", 10.0)
    _flood_hostside(fv)
    assert _get(f"http://127.0.0.1:{port}/healthz")["fleet_armed"] is True
    doc = _get(f"http://127.0.0.1:{port}/fleet")
    assert doc == json.loads(json.dumps(fv.fleet()))
    fleet_top.check_schema(doc)
    assert fleet_top._per_rank(doc, "bluefog_step_time_ewma_s", 3) == \
        pytest.approx(0.4, rel=1e-6)
    text = fleet_top.render(doc)
    assert "4/4 ranks live" in text and "train_steps_total=40" in text
    saved = tmp_path / "fleet.json"
    saved.write_text(json.dumps(doc))
    assert fleet_top.main(["--from-file", str(saved), "--once"]) == 0
    assert "4/4 ranks live" in capsys.readouterr().out
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools.fleet_top",
         "--url", f"http://127.0.0.1:{port}/fleet", "--once", "--json"],
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["n"] == 4
    with pytest.raises(ValueError):
        fleet_top.check_schema({"schema": "wrong"})


def test_train_step_inherits_the_armed_cadence(monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLEET_EVERY", "2")
    tctx.init(size=N, device="cpu")
    fv = tfv.active()
    assert fv is not None and fv.every == 2 and fv.n == N

    def grad_fn(params, batch):
        w = params["w"].detach().requires_grad_()
        loss = ((w - batch) ** 2).mean()
        loss.backward()
        return loss.detach(), {"w": w.grad}

    strat = topt.adapt_with_combine(
        topt.sgd(0.0), topt.neighbor_communicator(tctx.static_schedule()))
    params = {"w": torch.from_numpy(_spread().copy())}
    state = topt.init_distributed(strat, params)
    step = topt.make_train_step(grad_fn, strat)   # no metrics_every_k
    batch = torch.zeros(N, D)
    for _ in range(6):
        params, state, loss = step(params, state, batch)
    assert fv._round == 4          # calls 1, 2, 4 and 6, as JAX probes
    for _ in range(tfv._graph_diameter(tctx.static_schedule(),
                                       frozenset()) + 1):
        tdiag.diagnose_consensus(params)
    f = fv.fleet()
    assert f["metrics"]["bluefog_train_steps_total"]["global"] == \
        tm.counter("bluefog_train_steps_total").total() == 6
    assert f["seen_ranks"] == list(range(N))


def test_reinit_rearms_at_the_new_size():
    tctx.init(size=4, device="cpu")
    fv = tfv.arm(every=3)
    tctx.reinit(6)
    nv = tfv.active()
    assert nv is not fv and nv.n == 6 and nv.every == 3
    assert nv.spec == fv.spec
    out = tdiag.diagnose_consensus(torch.zeros(6, 4), record=False)
    assert out["fleet"]["n"] == 6


def test_arm_from_env_and_validation(monkeypatch):
    monkeypatch.setenv("BLUEFOG_FLEET_EVERY", "3")
    fv = tfv.maybe_arm_from_env(N)
    assert fv is not None and fv.every == 3 and tfv.fleet_every() == 3
    tfv.reset()
    monkeypatch.setenv("BLUEFOG_FLEET_EVERY", "zero")
    assert tfv.maybe_arm_from_env(N) is None
    assert tfv.active() is None
    for kw in (dict(spec=()), dict(every=0)):
        with pytest.raises(ValueError) as je:
            jfv.FleetView(N, **kw)
        with pytest.raises(ValueError) as te:
            tfv.FleetView(N, **kw)
        assert str(te.value) == str(je.value)


def test_fleet_hot_path_cost_pin():
    tfv.reset()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        tfv.active()
    disarmed = (time.perf_counter() - t0) / n
    assert disarmed < 5e-6, f"disarmed fleet check {disarmed:.2e}s/call"
    fv = tfv.arm(n=N)
    t0 = time.perf_counter()
    for _ in range(20):
        _flood_hostside(fv)
    armed = (time.perf_counter() - t0) / 20
    assert armed < 5e-3, f"armed probe round {armed:.2e}s"
