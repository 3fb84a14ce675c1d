"""CPU parity of the train->serve estate (the port's refresher, replica
failure and restore, autoscaler and ``tools/serve_bench.py``) against the
JAX package.

At the JAX fixture's sizes (``tests/test_serve.py``'s estate: vocab 32,
d_model 32, 4 heads, 4 layers; train dp 2 x pp 2 with ``sgd(0.05)``
from seed 1 beside serve dp 2 x pp 2 from seed 99):

* one training tree goes through both refreshers: the port's
  ``ServingParams`` equals ``params_from_jax`` of JAX's pulled serving
  tree (f32, 1e-6 relative: both average two rows with weights 1/2),
  before and after a serve replica is marked dead (its weights stay);
* the drain-while-training drill runs on both: equal streams, pulls and
  staleness readings, the pulled weights the training mean at each slice
  offset, the cache written in place;
* the kill drill, through ``fail_replica`` on both: the same lost ids,
  head-of-queue order, requeue counts and ``serve`` flight block, the
  refresher keeping the dead replica's weights;
* the AutoScaler / ``restore_replica`` cases of ``tests/test_regrow.py``
  on both, with equal events and scale files;
* the MoE expert pull and the ep-mismatch text of
  ``tests/test_serve_moe.py``, and the scheduler's hot-expert gauges,
  skew and flight block on fabricated routing statistics;
* the request and engine span trees of a speculative, prefix-sharing
  drain (names, order and attributes, times aside);
* ``serve_bench --device cpu --smoke`` in process, plain, with a
  flash-crowd trace and with MoE + speculative decoding.
"""
import json

import jax
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu.optimizers as jopt
from bluefog_tpu.moe.model import MoELMConfig as JMoELMConfig
from bluefog_tpu.moe.model import init_moe_params as jinit_moe
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.run.launcher import _read_scale as jread_scale
from bluefog_tpu.serve import Scheduler as JScheduler
from bluefog_tpu.serve import ServeConfig as JServeConfig
from bluefog_tpu.serve import ServeEngine as JServeEngine
from bluefog_tpu.serve import WeightRefresher as JRefresher
from bluefog_tpu.serve.scheduler import AutoScaler as JAutoScaler
from bluefog_tpu.utils import flight as jflight
from bluefog_tpu.utils import metrics as jmetrics
from bluefog_tpu.utils import timeseries as jts
from bluefog_tpu.utils import tracing as jtracing
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.moe.model import MoELMConfig, moe_params_from_jax
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.run.launcher import _read_scale as tread_scale
from bluefog_tpu_torch.serve import AutoScaler, Scheduler, ServeConfig
from bluefog_tpu_torch.serve import ServeEngine, WeightRefresher
from bluefog_tpu_torch.tools import serve_bench
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tmetrics
from bluefog_tpu_torch.utils import timeseries as tts
from bluefog_tpu_torch.utils import tracing as ttracing
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

_CFG = dict(vocab=32, d_model=32, heads=4, layers=4, seq_len=32)
_SCFG = dict(batch_buckets=(1, 2, 4), prefill_buckets=(4, 8), slots=4,
             max_len=32)
TOL = 1e-6            # relative to each tensor's largest magnitude


@pytest.fixture(autouse=True)
def _clean():
    for reg in (jmetrics, tmetrics):
        reg.reset_metrics()
    for fl in (jflight, tflight, jtracing, ttracing, jts, tts):
        fl.reset()
    yield
    for fl in (jflight, tflight, jtracing, ttracing, jts, tts):
        fl.reset()
    for reg in (jmetrics, tmetrics):
        reg.reset_metrics()


@pytest.fixture(scope="module")
def jax_programs(cpu_devices):
    """The JAX estate's compiled train step and warmed engine, built once
    for the module (each test starts them from fresh weights)."""
    cfg = jcompose.LMConfig(**_CFG)
    train_m = jcompose.compose_parallelism(2, 2, 1, 1,
                                           devices=cpu_devices[:4])
    serve_m = jcompose.compose_parallelism(2, 2, 1, 1,
                                           devices=cpu_devices[4:])
    step, strategy = jcompose.make_train_step(
        train_m, jcompose.make_lm_grad_fn(cfg, train_m), optax.sgd(0.05))
    eng = JServeEngine(serve_m, cfg,
                       jcompose.init_lm_params(cfg, serve_m, seed=99),
                       JServeConfig(**_SCFG))
    eng.warmup()
    return cfg, train_m, serve_m, step, strategy, eng


def _jax_estate(jax_programs, seed=99):
    """2 training replicas (pp 2) beside 2 serving replicas (pp 2), the
    JAX fixture's estate: the trainer from seed 1, the engine's weights
    from ``seed``."""
    cfg, train_m, serve_m, step, strategy, eng = jax_programs
    params = jcompose.init_lm_params(cfg, train_m, seed=1)
    state = jopt.init_distributed(strategy, params)
    toks = jcompose.make_lm_batch(cfg, train_m)
    params = jcompose.device_put(train_m, params)
    eng.update_params(jcompose.init_lm_params(cfg, serve_m, seed=seed))
    return train_m, serve_m, [step, state, params, toks], eng


def _port_estate(seed=99):
    cfg = tcompose.LMConfig(**_CFG)
    train_m = tcompose.compose_parallelism(2, 2, 1, 1, device="cpu")
    serve_m = tcompose.compose_parallelism(2, 2, 1, 1, device="cpu")
    step, strategy = tcompose.make_train_step(
        train_m, tcompose.make_lm_grad_fn(cfg, train_m), topt.sgd(0.05))
    params = tcompose.init_lm_train_params(cfg, train_m, seed=1)
    state = topt.init_distributed(strategy, params)
    toks = tcompose.make_lm_batch(cfg, train_m)
    eng = ServeEngine(cfg, tcompose.params_from_jax(
        tcompose.init_lm_train_params(cfg, serve_m, seed=seed), cfg,
        m=serve_m), ServeConfig(**_SCFG), device="cpu")
    eng.warmup()
    return cfg, train_m, serve_m, [step, state, params, toks], eng


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x)), tree)


def _assert_params_equal(tparams, want, tol=TOL):
    for (name, a), (_, b) in zip(tparams.tensors(), want.tensors()):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= tol * scale, (name, err, scale)


def _replica(params, r):
    return [t[r].clone() for _, t in params.tensors()]


def test_refresher_pull_matches_jax(jax_programs):
    """Two SGD steps make the training replicas differ; the same tree
    goes through both refreshers, then again after replica 1 dies."""
    train_m, serve_m, (step, state, params, toks), jeng = \
        _jax_estate(jax_programs)
    for _ in range(2):
        params, state, _ = step(params, state, toks)
    tree = jax.tree.map(np.asarray, params)
    cfg, ttrain_m, tserve_m, _, teng = _port_estate()
    jref = JRefresher(jeng, train_m, every=1)
    tref = WeightRefresher(teng, ttrain_m, every=1)
    assert tref.n_train == jref.n_train and tref.n_serve == jref.n_serve
    assert tref.staleness() == 0.0
    jref.pull(tree, 2)
    tref.pull(_to_torch(tree), 2)
    want = tcompose.params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                    cfg, m=tserve_m)
    _assert_params_equal(teng.params, want)
    # the training mean at each offset, replica by replica
    mean = {g: {k: torch.as_tensor(np.tile(
        v.reshape((2, 2) + v.shape[1:]).mean(0), (2,) + (1,) * (v.ndim - 1)))
        for k, v in leaves.items()} for g, leaves in tree.items()}
    _assert_params_equal(teng.params, tcompose.params_from_jax(
        mean, cfg, m=tserve_m))
    # a dead replica keeps its weights; the live one takes the new mean
    kept = _replica(teng.params, 1)
    for _ in range(2):
        params, state, _ = step(params, state, toks)
    tree = jax.tree.map(np.asarray, params)
    jref.mark_dead_serve_replica(1)
    tref.mark_dead_serve_replica(1)
    with pytest.raises(ValueError, match="out of range"):
        tref.mark_dead_serve_replica(2)
    jref.pull(tree, 4)
    tref.pull(_to_torch(tree), 4)
    assert all(torch.equal(a, b)
               for a, b in zip(kept, _replica(teng.params, 1)))
    _assert_params_equal(teng.params, tcompose.params_from_jax(
        jax.tree.map(np.asarray, jeng.params), cfg, m=tserve_m))
    def refresh_events(fl):
        return [(e["name"], e.get("step"), e.get("pulls"), e.get("dead"),
                 e.get("replica")) for e in fl.events()
                if e["name"].startswith("refresh")]
    assert refresh_events(tflight) == refresh_events(jflight)
    assert [e[0] for e in refresh_events(tflight)] == [
        "refresh_pull", "refresh_heal", "refresh_pull"]
    with pytest.raises(ValueError) as jerr:
        JRefresher(jeng, train_m, every=0)
    with pytest.raises(ValueError) as terr:
        WeightRefresher(teng, ttrain_m, every=0)
    assert str(terr.value) == str(jerr.value)


def _drill(sched_cls, ref_cls, eng, train_m, trainer, to_tree=None):
    """The JAX drain-while-training test's loop: 16 requests, 4 train
    steps interleaved, a refresher pulling every 2."""
    step, state, params, toks = trainer
    refresher = ref_cls(eng, train_m, every=2)
    sched = sched_cls(eng)
    rng = np.random.default_rng(0)
    reqs = [sched.submit(rng.integers(0, _CFG["vocab"],
                                      int(rng.integers(2, 9))).tolist(),
                         max_new_tokens=int(rng.integers(2, 6)))
            for _ in range(16)]
    assert sched.pending + sched.in_flight == 16
    train_done, stal_seen, pulls, guard = 0, [], 0, 0
    while not sched.done:
        guard += 1
        assert guard < 500, "scheduler failed to drain"
        sched.step()
        if train_done < 4:
            params, state, _ = step(params, state, toks)
            train_done += 1
            refresher.note_train_step(train_done)
            stal_seen.append(refresher.staleness())
            if refresher.maybe_refresh(params, train_done):
                pulls += 1
                assert refresher.staleness() == 0.0
    sched.close()
    return reqs, stal_seen, pulls, params, refresher


def test_drain_while_training_matches_jax(jax_programs):
    train_m, _, jtrainer, jeng = _jax_estate(jax_programs)
    jreqs, jstal, jpulls, _, _ = _drill(JScheduler, JRefresher, jeng,
                                        train_m, jtrainer)
    cfg, ttrain_m, tserve_m, ttrainer, teng = _port_estate()
    cache_ptrs = {k: v.data_ptr() for k, v in teng.cache.items()}
    treqs, tstal, tpulls, tparams, tref = _drill(
        Scheduler, WeightRefresher, teng, ttrain_m, ttrainer)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == r.max_new_tokens for r in treqs)
    assert (tstal, tpulls) == (jstal, jpulls)
    assert tpulls >= 1 and max(tstal) >= 1.0
    assert int(tmetrics.counter("bluefog_tokens_generated_total").total()) \
        == sum(r.max_new_tokens for r in treqs) == int(
            jmetrics.counter("bluefog_tokens_generated_total").total())
    assert tmetrics.counter("bluefog_requests_total").value(
        status="done") == 16
    # a pull delivers the training average at matching slice offsets
    tref.pull(tparams, 4)
    mean = {g: {k: v.reshape((2, 2) + v.shape[1:]).mean(0).repeat(
        (2,) + (1,) * (v.ndim - 1)) for k, v in leaves.items()}
        for g, leaves in tparams.items()}
    _assert_params_equal(teng.params, tcompose.params_from_jax(
        mean, cfg, m=tserve_m))
    assert all(teng.cache[k].data_ptr() == p for k, p in cache_ptrs.items())
    lat = tmetrics.get_metric("bluefog_serve_token_latency_seconds")
    assert lat.dump()["count"] == jmetrics.get_metric(
        "bluefog_serve_token_latency_seconds").dump()["count"]


def _kill(sched_cls, ref_cls, eng, train_m, trainer, dump_path, flight):
    step, state, params, toks = trainer
    refresher = ref_cls(eng, train_m, every=2)
    sched = sched_cls(eng)
    for i in range(8):
        sched.submit([1 + i, 2, 3, 4], max_new_tokens=4)
    sched.step()                                  # everything in flight
    victims = sorted(r.id for r in sched._active[1].values())
    assert victims, "replica 1 should hold lanes before the kill"
    for _ in range(2):                            # the kill at step 2
        params, state, _ = step(params, state, toks)
    lost = sched.fail_replica(1)
    refresher.mark_dead_serve_replica(1)
    head = [r.id for r in list(sched._queue)[:len(lost)]]
    states = [(r.state, r.requeued, r.replica, r.slot, list(r.generated))
              for r in lost]
    sched.drain()
    refresher.pull(params, 2)
    block = json.loads(open(flight.dump(str(dump_path))).read())["serve"]
    sched.close()
    return {"lost": [r.id for r in lost], "victims": victims, "head": head,
            "states": states, "requeued": sched.requeued_total,
            "completed": sorted(r.id for r in sched.completed),
            "replicas": sorted({r.replica for r in sched.completed}),
            "lengths": [len(r.generated) for r in sched.completed],
            "staleness": refresher.staleness(),
            "block": {k: block[k] for k in (
                "replicas", "dead_replicas", "parked_replicas", "pending",
                "in_flight", "completed", "failed", "requeued",
                "last_request_ids")}}


def test_kill_drill_matches_jax(jax_programs, tmp_path):
    train_m, _, jtrainer, jeng = _jax_estate(jax_programs)
    jgot = _kill(JScheduler, JRefresher, jeng, train_m, jtrainer,
                 tmp_path / "j.json", jflight)
    _, ttrain_m, _, ttrainer, teng = _port_estate()
    kept = _replica(teng.params, 1)
    tgot = _kill(Scheduler, WeightRefresher, teng, ttrain_m, ttrainer,
                 tmp_path / "t.json", tflight)
    assert tgot == jgot
    assert tgot["lost"] == tgot["victims"] == tgot["head"]
    assert tgot["requeued"] == len(tgot["lost"]) and tgot["replicas"] == [0]
    assert all(s == ("queued", 1, -1, -1, []) for s in tgot["states"])
    assert tgot["block"]["dead_replicas"] == [1] and not tgot["block"][
        "failed"]
    assert tgot["staleness"] == 0.0
    assert tmetrics.counter("bluefog_requests_total").value(
        status="requeued") == len(tgot["lost"]) == jmetrics.counter(
            "bluefog_requests_total").value(status="requeued")
    # the healed pull keeps the dead replica's weights
    assert all(torch.equal(a, b)
               for a, b in zip(kept, _replica(teng.params, 1)))
    names = [e["name"] for e in tflight.events()]
    assert "replica_failed" in names and "refresh_heal" in names


# ---------------------------------------------------------------------------
# AutoScaler and restore_replica (tests/test_regrow.py's cases)
# ---------------------------------------------------------------------------

class _StubSched:
    """The Scheduler surface AutoScaler drives, without an engine."""

    def __init__(self, replicas=2, slots=4, slice_size=1):
        class _Ns:
            pass
        self.engine = _Ns()
        self.engine.scfg = _Ns()
        self.engine.scfg.slots = slots
        self.engine.m = _Ns()
        self.engine.m.slice_size = slice_size
        self.replicas = replicas
        self._dead, self._parked = set(), set()
        self.pending = 0
        self.restored, self.retired = [], []

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
        self.retired.append((r, reason))
        return []


def _case_grow(cls, path):
    sched = _StubSched()
    sched.fail_replica(1, reason="parked", park=True)
    sc = cls(sched, slo_p99_s=0.25, queue_high=4, cooldown_steps=2,
             scale_file=path)
    sched.pending = 2
    out = [sc.observe()]
    sched.pending = 9
    out.append(sc.observe())
    return out, sched.restored


def _case_ranks(cls, path):
    sched = _StubSched(slice_size=2)
    sched.fail_replica(1, reason="parked", park=True)
    sc = cls(sched, slo_p99_s=0.25, queue_high=4, cooldown_steps=1,
             scale_file=path)
    sched.pending = 9
    return [sc.observe()], sc.ranks_per_replica


def _case_killed(cls, path):
    sched = _StubSched()
    sched.fail_replica(1, reason="failed")
    sc = cls(sched, slo_p99_s=0.25, queue_high=4, cooldown_steps=1,
             scale_file=path)
    sched.pending = 9
    return [sc.observe()], sched.restored, sorted(sched._dead)


def _case_retire(cls, path):
    sched = _StubSched()
    sc = cls(sched, slo_p99_s=0.25, queue_high=4, cooldown_steps=3,
             scale_file=path, min_replicas=1)
    return [sc.observe() for _ in range(8)], sched.retired


@pytest.mark.parametrize("case", [_case_grow, _case_ranks, _case_killed,
                                  _case_retire])
def test_autoscaler_cases_match_jax(case, tmp_path):
    got = {}
    for side, cls, reg, read in (
            ("jax", JAutoScaler, jmetrics, jread_scale),
            ("port", AutoScaler, tmetrics, tread_scale)):
        path = str(tmp_path / side / "bluefog_scale")
        out = case(cls, path)
        got[side] = (out, read(path),
                     reg.counter("bluefog_autoscale_events_total").value(
                         action="grow"),
                     reg.counter("bluefog_autoscale_events_total").value(
                         action="retire"))
    assert got["port"] == got["jax"]
    assert any(e for e in got["port"][0][0]) == (case is not _case_killed)


def test_restore_replica_prefix_directory_semantics():
    """A parked replica keeps its sealed prefix directory; one restored
    after a real failure gets it rebuilt empty (the JAX test's case)."""
    class _Ns:
        pass
    eng = _Ns()
    eng.replicas = 2
    eng.scfg = _Ns()
    eng.scfg.slots, eng.scfg.prefix_pages = 4, 2
    eng.scfg.prefix_page_tokens = 4
    sched = Scheduler(eng)
    try:
        pc = sched._prefix[1]
        assert pc is not None
        sched.fail_replica(1, reason="parked", park=True)
        assert sched._parked == {1} and sched.live_replicas() == [0]
        assert sched.restore_replica(1) and not sched.restore_replica(1)
        assert sched._prefix[1] is pc
        assert sched._parked == set()
        sched.preempt_replica(1, zone=3, grace=0.5)
        assert sched._parked == set()
        assert sched.restore_replica(1)
        assert sched._prefix[1] is not pc and sched._prefix[1].in_use == 0
        with pytest.raises(RuntimeError, match="every serving replica"):
            sched.fail_replica(0)
            sched.fail_replica(1)
    finally:
        sched.close()
    names = [e["name"] for e in tflight.events()]
    assert names[:4] == ["replica_parked", "replica_restored",
                         "replica_preempted", "replica_preempt_notice"]


# ---------------------------------------------------------------------------
# MoE: the expert-table pull and the ep-mismatch refusal
# ---------------------------------------------------------------------------

E = 4
_MOE = dict(vocab=32, d_model=16, heads=4, layers=2, seq_len=32, micro=1,
            batch=2, num_experts=E, top_k=2, dispatch="dropless")
_MOE_SCFG = dict(batch_buckets=(1, 2), prefill_buckets=(4, 8), slots=4,
                 max_len=32, decode_steps_per_call=1, moe_experts=E,
                 moe_top_k=2, moe_ep=2)


def test_refresher_pulls_expert_tables_and_refuses_ep_mismatch(cpu_devices):
    jcfg = JMoELMConfig(**_MOE)
    jm = jcompose.compose_parallelism(2, 1, 1, 1, 2, num_experts=E,
                                      devices=cpu_devices[:4])
    jeng = JServeEngine(jm, jcfg, jinit_moe(jcfg, jm, seed=5),
                        JServeConfig(**_MOE_SCFG))
    jtrain_m = jcompose.compose_parallelism(1, 1, 1, 1, 2, num_experts=E,
                                            devices=cpu_devices[4:6])
    tree = jax.tree.map(np.asarray, jinit_moe(jcfg, jtrain_m, seed=11))
    JRefresher(jeng, jtrain_m, every=1).pull(tree, train_step=1)

    cfg = MoELMConfig(**_MOE)
    tm = tcompose.compose_parallelism(2, 1, 1, 1, 2, num_experts=E,
                                      device="cpu")
    teng = ServeEngine(cfg, moe_params_from_jax(
        jax.tree.map(np.asarray, jinit_moe(jcfg, jm, seed=5)), cfg, m=tm),
        ServeConfig(**_MOE_SCFG), device="cpu")
    ttrain_m = tcompose.compose_parallelism(1, 1, 1, 1, 2, num_experts=E,
                                            device="cpu")
    WeightRefresher(teng, ttrain_m, every=1).pull(_to_torch(tree), 1)
    want = moe_params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg,
                               m=tm)
    for (name, a), (_, b) in zip(teng.params.tensors(), want.tensors()):
        assert torch.equal(a, b), name      # dp_train 1: copies, exact
    assert {"wr[0]", "w1e[1]", "w2e[0]"} <= {n for n, _ in
                                              teng.params.tensors()}
    # an ep mismatch is refused with the JAX text
    ep1 = jcompose.compose_parallelism(1, 1, 1, 1, 1, num_experts=E,
                                       devices=cpu_devices[4:5])
    with pytest.raises(ValueError, match="ep=1") as jerr:
        JRefresher(jeng, ep1, every=1)
    with pytest.raises(ValueError, match="ep=1") as terr:
        WeightRefresher(teng, tcompose.compose_parallelism(
            1, 1, 1, 1, 1, num_experts=E, device="cpu"), every=1)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="num_experts") as terr:
        WeightRefresher(teng, tcompose.compose_parallelism(
            1, 1, 1, 1, 2, num_experts=2 * E, device="cpu"), every=1)


# ---------------------------------------------------------------------------
# serve_bench, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    [], ["--traffic-trace", "flash-crowd"],
    ["--serve-moe", "4x2@2:4", "--spec-decode", "2@1"]],
    ids=["plain", "flash_crowd", "moe_spec"])
def test_serve_bench_smoke(extra, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("BLUEFOG_SERVE_MOE", raising=False)
    monkeypatch.delenv("BLUEFOG_TRACE", raising=False)
    out = str(tmp_path / "doc.json")
    doc = serve_bench.main(["--device", "cpu", "--smoke", "--out", out]
                           + extra)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(open(out).read()) == doc
    assert doc["ok"] and doc["schema"] == "bluefog-torch-serve-bench-1"
    assert doc["requests"]["failed"] == 0
    assert doc["requests"]["completed"] == doc["requests"]["submitted"]
    assert doc["refresh"]["pulls"] == 3
    assert doc["refresh"]["staleness_after_each_pull"] == [0.0] * 3
    assert doc["invariants"]["cache_in_place"]
    assert doc["invariants"]["retraces_after_warmup"] is None
    assert doc["mfu"]["mfu"] is None and not doc["on_accelerator"]
    lat = doc["latency"]
    if not extra:
        # the drain's median and 99th percentile (the JAX tool passes 0.5
        # / 0.99 to a percentile that takes percent); with no probe and no
        # trace phase the histogram holds the drain's observations alone
        h = tmetrics.get_metric("bluefog_serve_token_latency_seconds")
        assert lat["per_token_observations"] == h.dump()["count"] > 16
        assert lat["per_token_p50_s"] == round(h.percentile(50), 6)
        assert lat["per_token_p99_s"] == round(h.percentile(99), 6)
    assert 0 < lat["per_token_p50_s"] <= lat["per_token_p99_s"]
    assert lat["ttft_p50_s"] <= lat["ttft_p99_s"] <= lat["ttft_max_s"]
    # the breakdown reads the drain's own 16 requests' spans alone, and
    # the run leaves the tracer and the latency ring as it found them
    assert doc["latency_breakdown"]["n_requests"] == 16
    assert not ttracing.enabled()
    assert not tts.armed("bluefog_serve_token_latency_seconds")
    ev = doc["kernels"]["drain"]["events"]
    assert ev["train_steps"] == 6 and ev["prefills"] == 16
    if "--traffic-trace" in extra:
        tr = doc["trace"]
        assert tr["ok"] and tr["failed"] == 0 and tr["grow_step"] is not None
        assert tr["scale_file_target"] == tr["expected_world"]
    if "--serve-moe" in extra:
        moe = doc["moe"]
        assert moe["bit_identity"]["bit_identical"]
        # the ledger over one decode call: the dispatch's all-to-alls, ICI
        wire = moe["wire"]
        assert wire["dcn_bytes"] == 0 and wire["dcn"] == {}
        assert wire["ici"]["all_to_all"]["count"] > 0
        assert doc["spec"]["bit_identical"] and doc["spec"]["drafted"] > 0


def test_serve_bench_needs_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bench.main(["--smoke"])


def test_request_and_engine_spans_match_jax(cpu_devices, tmp_path):
    """A drain with speculative decoding and shared prefix pages on a pp-2
    carving, traced on both sides: every span's trace, name, category
    and attributes (the times aside) in the same order."""
    cfg = tcompose.LMConfig(**_CFG)
    jcfg = jcompose.LMConfig(**_CFG)
    jm = jcompose.compose_parallelism(1, 2, 1, 1, devices=cpu_devices[:2])
    tree = jcompose.init_lm_params(jcfg, jm, seed=3)
    tm = tcompose.compose_parallelism(1, 2, 1, 1, device="cpu")
    scfg = dict(_SCFG, decode_steps_per_call=1, spec_decode=2,
                spec_stages=1, prefix_pages=2, prefix_page_tokens=4)
    shared = [3, 1, 4, 1]
    prompts = [shared + [5, 9, 2], shared + [6, 5, 3], [7, 7, 1],
               shared + [2, 7]]
    got = {}
    for side, tr, eng in (
            ("jax", jtracing, JServeEngine(jm, jcfg, tree,
                                           JServeConfig(**scfg))),
            ("port", ttracing, ServeEngine(cfg, tcompose.params_from_jax(
                jax.tree.map(np.asarray, tree), cfg, m=tm),
                ServeConfig(**scfg), device="cpu"))):
        eng.warmup()
        tr.configure(str(tmp_path / side))
        sched = (JScheduler if side == "jax" else Scheduler)(eng)
        reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.drain()
        sched.close()
        got[side] = ([r.generated for r in reqs],
                     [{k: v for k, v in sp.items() if k not in ("t0", "t1")}
                      for sp in tr.spans()])
    assert got["port"] == got["jax"]
    names = {sp["name"] for sp in got["port"][1]}
    assert {"submit", "queue", "prefill", "decode", "request",
            "prefill_call", "chunk_call", "spec_round"} <= names


def test_hot_expert_gauges_and_skew_match_jax(cpu_devices):
    """Fabricated routing statistics (replica 0 flat, replica 1 all on one
    expert): the scheduler's hot-expert / entropy / per-expert gauges,
    its skew and its flight block's ``moe`` rows (the JAX test's case)."""
    jcfg = JMoELMConfig(**_MOE)
    jm = jcompose.compose_parallelism(2, 1, 1, 1, 2, num_experts=E,
                                      devices=cpu_devices[:4])
    tree = jinit_moe(jcfg, jm, seed=5)
    jeng = JServeEngine(jm, jcfg, tree, JServeConfig(**_MOE_SCFG))
    cfg = MoELMConfig(**_MOE)
    tm = tcompose.compose_parallelism(2, 1, 1, 1, 2, num_experts=E,
                                      device="cpu")
    teng = ServeEngine(cfg, moe_params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, m=tm),
        ServeConfig(**_MOE_SCFG), device="cpu")
    stats = [[2.0, 2.0, 2.0, 2.0, 8.0 * np.log(E), 8.0],
             [8.0, 0.0, 0.0, 0.0, 0.0, 8.0]]
    jeng._route_stats = np.asarray(stats)
    teng._route_stats = torch.tensor(stats, dtype=torch.float64)
    got = {}
    for side, eng, sched_cls, reg in (("jax", jeng, JScheduler, jmetrics),
                                      ("port", teng, Scheduler, tmetrics)):
        sched = sched_cls(eng)
        sched._note_moe_load()
        got[side] = ({n: reg.snapshot()[n] for n in (
            "bluefog_serve_hot_expert_fraction",
            "bluefog_serve_router_entropy",
            "bluefog_serve_expert_load_fraction")},
            [sched._expert_skew(r) for r in range(2)],
            sched._flight_block()["moe"])
        sched.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [0, int((1.0 - 1.0 / E) * 8)]

