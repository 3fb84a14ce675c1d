"""The port's autotuner (``bluefog_tpu_torch/autotune``) against the JAX
package's (``bluefog_tpu/autotune``) on the CPU, 8 ranks:

* **Enumeration**: the candidate and carving spaces, key for key and
  audit for audit (reasons included), and the helpers beside them.
* **Plan parity**: at n = 8 on the same two-leaf probe tree, JAX's
  ``--smoke`` space and a second space (choco at int8 and bf16 under recv
  and dst weights, push_sum, async window gossip, the two-level topology,
  a bf16 wire) give the same scored keys, the same rejections and
  reasons, the same winner and ``plan_id``.  The ledger's per-step bytes
  equal JAX's compiled-HLO count for every group except the ones pinned
  by name below, and for those they equal what the JAX counter reads of
  the same traffic: the CPU backend carries a bf16 permute as f32, and
  ``hlo_bytes.wire_stats`` drops 4-byte permutes (it takes them for the
  async form's sync flags), so a scalar lane (push-sum's weight,
  push-DIGing's mass, an int8 codec's per-rank scale) is missing there.
* **Honest bytes**: a probe's bytes equal the ledger's reading of one
  real train step of the same strategy with real gradients.
* **Determinism, reconstruction, the bank and trials, the CLI,
  ``tools/bench.py --plan``** and the async strategy's enumeration, as
  ``tests/test_autotune.py``, ``tests/test_bench.py`` and
  ``tests/test_async_gossip.py`` pin them for JAX.
"""
import contextlib
import glob
import io
import json
import os
from pathlib import Path

import jax.numpy as jnp
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import autotune_lib as jat
from bluefog_tpu.autotune import bank as jbank
from bluefog_tpu.autotune import cost_model as jcm
import bluefog_tpu_torch as pbf
from bluefog_tpu_torch import autotune_lib as pat
from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch.autotune import __main__ as pcli
from bluefog_tpu_torch.autotune import bank as pbank
from bluefog_tpu_torch.autotune import cost_model as pcm
from bluefog_tpu_torch.autotune.candidates import Candidate
from bluefog_tpu_torch.autotune.plan import make_plan_doc
from bluefog_tpu_torch.parallel import context as pctx
from bluefog_tpu_torch.tools import bench as pbench
from bluefog_tpu_torch.utils import wire_bytes as wb
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

ROOT = Path(__file__).resolve().parents[1]
N = 8
EXP2 = {"family": "exp2", "size": N}
RING = {"family": "ring", "size": N}
TWO = {"family": "two_level", "num_machines": 4, "local_size": 2,
       "intra": "dense", "inter": "exp2"}
SMOKE = dict(algorithms=("allreduce", "neighbor_cta", "neighbor_atc",
                         "push_diging"),
             topologies=(EXP2, RING), wires=(None,), fused_k=(1, 4))
SECOND = dict(algorithms=("choco", "push_sum", "async_window_gossip",
                          "neighbor_cta"),
              topologies=(EXP2, TWO), wires=("bf16",), fused_k=(1,),
              include_delayed=False, include_concurrent=False)
SMALL = dict(algorithms=("allreduce", "neighbor_cta"),
             topologies=(EXP2, RING), wires=(None,), fused_k=(1, 2),
             include_delayed=False, include_concurrent=False)

# groups whose JAX compiled count differs from the ledger's, and why
PINNED = {
    "push_diging|topo=exp2[8]|wire=None|weights=push": "scalar lane",
    "push_diging|topo=ring[8]|wire=None|weights=push": "scalar lane",
    "choco|topo=exp2[8]|wire=int8|weights=recv": "scalar lane",
    "choco|topo=exp2[8]|wire=int8|weights=dst": "scalar lane",
    "choco|topo=two_level[4x2,dense/exp2]|wire=int8|weights=recv":
        "scalar lane",
    "choco|topo=two_level[4x2,dense/exp2]|wire=int8|weights=dst":
        "scalar lane",
    "push_sum|topo=exp2[8]|wire=None|weights=push": "scalar lane",
    "push_sum|topo=two_level[4x2,dense/exp2]|wire=None|weights=push":
        "scalar lane",
    "choco|topo=exp2[8]|wire=bf16|weights=recv": "bf16 as f32",
    "choco|topo=two_level[4x2,dense/exp2]|wire=bf16|weights=recv":
        "bf16 as f32",
    "neighbor_cta|topo=exp2[8]|wire=bf16|weights=recv": "bf16 as f32",
    "neighbor_cta|topo=two_level[4x2,dense/exp2]|wire=bf16|weights=recv":
        "bf16 as f32",
    "async_window_gossip|topo=exp2[8]|wire=bf16|weights=push":
        "bf16 as f32, scalar lanes",
    "async_window_gossip|topo=two_level[4x2,dense/exp2]|wire=bf16"
    "|weights=push": "bf16 as f32, scalar lanes",
}


def _jparams():
    return {"w": jnp.zeros((256, 64), jnp.float32),
            "b": jnp.zeros((64,), jnp.float32)}


@pytest.fixture
def jax_ctx(cpu_devices):
    jbf.init(devices=cpu_devices)
    yield
    jbf.shutdown()


@pytest.fixture
def port_ctx():
    pctx.init(size=N, device="cpu")
    yield
    pctx.shutdown()


def _ptune(tmp_path, **kw):
    kw.setdefault("measured_dir", str(tmp_path))
    return pat.autotune(**kw)


def _group(key: str) -> str:
    return "|".join(key.split("|")[:4])


# ---------------------------------------------------------------------------
# enumeration, audit for audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_candidate_enumeration_equals_jax(n):
    ja, jr = jat.enumerate_candidates(n)
    pa, pr = pat.enumerate_candidates(n)
    assert [c.key for c in pa] == [c.key for c in ja]
    assert [c.compile_group for c in pa] == [c.compile_group for c in ja]
    assert [c.config() for c in pa] == [c.config() for c in ja]
    assert pr == jr
    if n == N:
        assert len(pa) == 164 and len(pr) == 48
    assert pat.default_topologies(n) == jat.default_topologies(n)
    assert pat.two_level_split(n) == jat.two_level_split(n)


@pytest.mark.parametrize("kw", [
    dict(n_chips=8), dict(n_chips=16, num_experts=4),
    dict(n_chips=16, num_experts=6), dict(n_chips=8, require_gossip=False),
    dict(n_chips=8, max_pp=2, max_tp=2, max_sp=2, max_ep=1)])
def test_carving_enumeration_equals_jax(kw):
    ja, jr = jat.enumerate_carvings(**kw)
    pa, pr = pat.enumerate_carvings(**kw)
    assert [tuple(c) for c in pa] == [tuple(c) for c in ja]
    assert [c.key for c in pa] == [c.key for c in ja]
    assert pr == jr


def test_schedules_and_constants_equal_jax():
    for spec in (EXP2, RING, TWO):
        for weights in ("recv", "push", "dst"):
            js = jat.schedule_for(spec, weights, N)
            ps = pat.schedule_for(spec, weights, N)
            assert [tuple(map(tuple, r)) for r in ps.rounds] == \
                [tuple(map(tuple, r)) for r in js.rounds]
    for name in ("_BYTES_PER_SEC", "_DCN_BYTES_PER_SEC", "_ROUND_LATENCY_S",
                 "_DISPATCH_S", "_EXPOSED_WHEN_DELAYED"):
        assert getattr(pcm, name) == getattr(jcm, name)
    cand = Candidate("neighbor_cta", EXP2, None, "recv", 4, True, True)
    assert pcm.predicted_step_time_s(cand, 1000, 3) == \
        jcm.predicted_step_time_s(cand, 1000, 3)
    assert pcm.consensus_gap(cand) == jcm.consensus_gap(cand)
    assert pcm.num_schedule_rounds(cand, N) == jcm.num_schedule_rounds(
        cand, N)
    for obj in ("step_time", "consensus_per_byte",
                {"step_time": 1.0, "consensus_per_byte": 0.5}):
        assert pcm.objective_score(obj, 2.0, 0.5, 100) == \
            jcm.objective_score(obj, 2.0, 0.5, 100)
    cfg = {"algorithm": "allreduce", "topology": None, "wire": None,
           "weights": None, "fused_k": 1, "delayed": False,
           "concurrent": None}
    assert pat.plan_id_of(cfg) == jat.plan_id_of(cfg)
    assert pat.PLAN_SCHEMA == jat.PLAN_SCHEMA
    assert pat.CARVING_PLAN_SCHEMA == jat.CARVING_PLAN_SCHEMA


# ---------------------------------------------------------------------------
# plan parity
# ---------------------------------------------------------------------------

def _jax_counter_view(led: wb.Ledger) -> int:
    """What ``hlo_bytes.wire_stats`` of the CPU-compiled program reads of
    the ledger's traffic: bf16 carried as f32, 4-byte permutes dropped."""
    view = wb.Ledger(led.slice_size)
    for ev in led.events:
        if ev.kind == "collective_permute" and ev.result <= 4:
            continue
        k = 2 if ev.dtype == "bf16" else 1
        view.events.append(wb._Event(ev.kind, ev.side, ev.dtype,
                                     ev.wire * k, ev.result * k, ev.ids,
                                     ev.span))
    return view.total_wire_bytes()


@pytest.mark.parametrize("space", [SMOKE, SECOND], ids=["smoke", "second"])
def test_plan_parity_with_jax(jax_ctx, port_ctx, tmp_path, space):
    jplan = jat.autotune(params=_jparams(), measured_dir=str(tmp_path),
                         **space)
    pplan = _ptune(tmp_path, **space)
    jd, pd = jplan.doc, pplan.doc
    # the same keys (their order follows the scores, which the pinned
    # byte differences move)
    assert sorted(e["key"] for e in pd["audit"]["scored"]) == \
        sorted(e["key"] for e in jd["audit"]["scored"])
    assert pd["audit"]["rejected"] == jd["audit"]["rejected"]
    assert pd["audit"]["considered"] == jd["audit"]["considered"]
    jb = {_group(e["key"]): e["wire_bytes_per_step_per_chip"]
          for e in jd["audit"]["scored"]}
    pb = {_group(e["key"]): e["wire_bytes_per_step_per_chip"]
          for e in pd["audit"]["scored"]}
    assert set(pb) == set(jb)
    differ = {g for g in jb if jb[g] != pb[g]}
    assert differ == {g for g in PINNED if g in jb}, differ
    cands = {_group(c.key): c for c in pat.enumerate_candidates(
        N, **space)[0]}
    for g in jb:
        led = pcm.probe_update(
            pcm.build_probe_strategy(cands[g], N, pat.tuner.
                                     _default_opt_factory()),
            pat.tuner._default_params(), N)
        assert led.total_wire_bytes() == pb[g]
        assert _jax_counter_view(led) == jb[g], g
    # the pinned differences do not move the decision
    assert pplan.config == jplan.config
    assert pplan.plan_id == jplan.plan_id
    for key in ("spectral_gap", "schedule_rounds", "evidence", "backend"):
        assert pd["predicted"][key] == jd["predicted"][key]
    assert pd["device_kind"] == jd["device_kind"] == "cpu"
    # the port's plan replays on the JAX package, and back
    jstrat = jat.Plan(pd).build_strategy(optax.sgd(0.01))
    assert jstrat is not None
    assert pat.Plan(jd).train_step_kwargs() == jplan.train_step_kwargs()


@pytest.mark.parametrize("cand", [
    Candidate("allreduce", None, None, None, 1, False, None),
    Candidate("neighbor_cta", EXP2, None, "recv", 1, False, None),
    Candidate("neighbor_cta", RING, "int8", "recv", 1, False, None),
    Candidate("push_diging", EXP2, None, "push", 1, False, None),
    Candidate("choco", TWO, "int8", "dst", 1, False, None),
], ids=lambda c: c.key)
def test_probe_bytes_equal_one_real_train_step(port_ctx, cand):
    """The probe (zero grads, the update alone) counts the bytes one real
    train step of the same strategy moves with real gradients."""
    opt = pat.tuner._default_opt_factory()
    _, predicted = pcm.group_wire_bytes(cand, pat.tuner._default_params(),
                                        N, opt)
    strategy = pcm.build_probe_strategy(cand, N, opt)

    def grad_fn(p, batch):
        return (batch.sum(),
                {k: 0.01 * v + batch.sum() + 1.0 for k, v in p.items()})

    step = bfopt.make_train_step(grad_fn, strategy)
    params = bfopt.replicate({k: torch.randn(v.shape) for k, v in
                              pat.tuner._default_params().items()}, N)
    state = bfopt.init_distributed(strategy, params)
    with wb.ledger() as led:
        step(params, state, torch.ones(N, 3))
    assert led.total_wire_bytes() == predicted > 0


# ---------------------------------------------------------------------------
# determinism, reconstruction
# ---------------------------------------------------------------------------

def test_plan_is_deterministic_and_round_trips(port_ctx, tmp_path):
    a = _ptune(tmp_path, **SMALL)
    b = _ptune(tmp_path, **SMALL)
    assert a.to_json() == b.to_json()
    assert a.plan_id == pat.plan_id_of(a.config)
    path = a.save(str(tmp_path / "plan.json"))
    assert pat.load_plan(path).to_json() == a.to_json()
    with pytest.raises(ValueError, match="not an autotune plan"):
        pat.Plan({"schema": "bluefog-bench-2"})
    pred = a.doc["predicted"]
    winner = a.doc["audit"]["scored"][0]
    assert pred["wire_bytes_per_step_per_chip"] == \
        winner["wire_bytes_per_step_per_chip"]
    assert pred["backend"] == "cpu"
    with pytest.raises(ValueError, match="unknown algorithm"):
        _ptune(tmp_path, algorithms=("sgd_of_theseus",))
    with pytest.raises(ValueError, match="unknown objective"):
        _ptune(tmp_path, objective="qps", **SMALL)


def test_plan_applies_trains_and_refuses_other_mesh(port_ctx, tmp_path):
    plan = _ptune(tmp_path, algorithms=("neighbor_cta",),
                  topologies=(RING,), wires=(None,), fused_k=(4,),
                  include_delayed=False, include_concurrent=True)
    assert plan.config["concurrent"] is True
    plan.apply()
    assert pctx.round_parallel() is True
    assert pctx.in_neighbor_ranks(0) == [1, 7]       # the ring's
    assert plan.train_step_kwargs() == {"steps_per_call": 4,
                                        "reuse_batch": True,
                                        "overlap": False}
    doc = make_plan_doc(
        config={"algorithm": "neighbor_cta",
                "topology": {"family": "exp2", "size": 4}, "wire": None,
                "weights": "recv", "fused_k": 1, "delayed": False,
                "concurrent": None},
        objective="step_time", n_chips=4, device_kind="cpu",
        predicted={}, audit={})
    with pytest.raises(ValueError, match="re-tune on this mesh"):
        pat.Plan(doc).apply()
    assert pbf.apply_plan is pctx.apply_plan
    assert pbf.autotune is pat.autotune and pbf.Plan is pat.Plan
    assert pbf.load_plan is pat.load_plan and pbf.autotune_lib is pat


def test_cli_apply_steps(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_MEASURED_DIR", str(tmp_path))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pcli.main(["--device", "cpu", "--ranks", "8", "--smoke",
                        "--apply-steps", "3",
                        "--out", str(tmp_path / "plan.json")])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    plan, report = json.loads(lines[0]), json.loads(lines[-1])
    assert pat.load_plan(str(tmp_path / "plan.json")).doc == plan
    assert report["applied"] and report["ok"] and report["loss_finite"]
    assert report["plan_id"] == plan["plan_id"]
    assert report["steps"] == 3 and report["retraces_after_warmup"] == 0
    assert report["in_place"] is True and report["donated"] is None
    # the smoke space's plan, as the JAX CLI's (the parity test's space)
    assert plan["config"]["algorithm"] == "neighbor_cta"
    assert plan["audit"]["considered"] == 38
    assert plan["plan_id"] == "2ee7c2c3db90"


# ---------------------------------------------------------------------------
# the bank and trials
# ---------------------------------------------------------------------------

def _bank(path, name, **fields):
    with open(path / name, "w") as f:
        json.dump(fields, f)


ONE = dict(algorithms=("neighbor_cta",), topologies=(EXP2,), wires=(None,),
           fused_k=(1,), include_delayed=False, include_concurrent=False)


def test_exact_banked_trial_overrides_analytic(port_ctx, tmp_path):
    base = _ptune(tmp_path, **ONE)
    entry = base.doc["audit"]["scored"][0]
    assert entry["evidence"] == "analytic"
    _bank(tmp_path, "autotune_trial_test.json", ok=True,
          on_accelerator=True, algorithm="neighbor_cta",
          device=base.doc["device_kind"], n_chips=N, key=entry["key"],
          seconds_per_step=1.25e-05)
    tuned = _ptune(tmp_path, **ONE)
    e = tuned.doc["audit"]["scored"][0]
    assert (e["evidence"], e["step_time_s"], e["source"]) == (
        "banked", 1.25e-05, "autotune_trial_test.json")


def test_coarse_banked_keeps_order_within_algorithm(port_ctx, tmp_path):
    _bank(tmp_path, "bench_fake.json", ok=True, on_accelerator=True,
          algorithm="neighbor_cta", device="cpu", n_chips=N,
          fused_per_step_s=3.0e-04)
    plan = _ptune(tmp_path, **dict(ONE, fused_k=(1, 4)))
    scored = plan.doc["audit"]["scored"]
    assert all(e["evidence"] == "banked_coarse" for e in scored)
    assert plan.config["fused_k"] == 4


def test_cpu_and_tpu_artifacts_never_steer(port_ctx, tmp_path):
    """CPU artifacts are not on an accelerator; a TPU artifact (and the
    repo's own ``docs/measured/`` TPU files) never match a card's kind."""
    card = "NVIDIA H100 80GB HBM3"
    for name, fields in (
            ("bench_cpu.json", dict(ok=True, on_accelerator=False,
                                    device="cpu")),
            ("bench_rescue.json", dict(ok=False, on_accelerator=True,
                                       device="cpu")),
            ("bench_other_mesh.json", dict(ok=True, on_accelerator=True,
                                           device="cpu", n_chips=N + 8)),
            ("bench_tpu.json", dict(ok=True, on_accelerator=True,
                                    device="TPU v5 lite"))):
        _bank(tmp_path, name, **{"algorithm": "neighbor_cta",
                                 "n_chips": N, "fused_per_step_s": 1e-6,
                                 **fields})
    plan = _ptune(tmp_path, **ONE)
    assert plan.doc["audit"]["scored"][0]["evidence"] == "analytic"
    for alg in bfopt.STRATEGIES:
        for n in (1, 4, 8, 16):
            assert pbank.banked_step_time(alg, card, n, str(tmp_path)) \
                is None
            assert pbank.banked_step_time(alg, card, n) is None
    assert pbank.measured_dir() == str(ROOT / "docs" / "measured")
    assert sorted(glob.glob(str(ROOT / "docs" / "measured" / "*.json")))
    # the two packages read one artifact alike
    _bank(tmp_path, "autotune_trial_x.json", ok=True, on_accelerator=True,
          algorithm="choco", device=card, n_chips=N, key="k",
          seconds_per_step=2e-3)
    got = pbank.banked_step_time("choco", card, N, str(tmp_path))
    assert got == jbank.banked_step_time("choco", card, N, str(tmp_path))
    assert got == (2e-3, "autotune_trial_x.json", True)


def test_live_trials_bank_as_they_land(port_ctx, tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_TRIALS", "1")
    plan = _ptune(tmp_path, trials="auto", **ONE)
    winner = plan.doc["audit"]["scored"][0]
    assert winner["evidence"] == "trial" and winner["step_time_s"] > 0
    banked = glob.glob(os.path.join(str(tmp_path), "autotune_trial_*.json"))
    assert len(banked) == 1
    with open(banked[0]) as f:
        doc = json.load(f)
    assert doc["schema"] == "bluefog-autotune-trial-1"
    assert doc["key"] == winner["key"] and doc["device"] == "cpu"
    assert doc["on_accelerator"] is False
    again = _ptune(tmp_path, **ONE)
    assert again.doc["audit"]["scored"][0]["evidence"] == "analytic"


def test_failed_probe_is_an_audited_rejection(port_ctx, tmp_path,
                                              monkeypatch):
    real = pcm.build_probe_strategy

    def boom(cand, n, opt_factory):
        if cand.algorithm == "allreduce":
            raise RuntimeError("no")
        return real(cand, n, opt_factory)
    monkeypatch.setattr(pcm, "build_probe_strategy", boom)
    plan = _ptune(tmp_path, **SMALL)
    rej = [r for r in plan.doc["audit"]["rejected"]
           if r["key"].startswith("allreduce")]
    assert rej and all(r["reason"] == "probe failed: RuntimeError: no"
                       for r in rej)
    assert plan.doc["audit"]["considered"] == \
        len(plan.doc["audit"]["scored"]) + len(plan.doc["audit"]["rejected"])


# ---------------------------------------------------------------------------
# the async strategy, bench --plan
# ---------------------------------------------------------------------------

def test_async_autotune_enumerated_audited_and_replayable(port_ctx,
                                                          tmp_path):
    accepted, rejected = pat.enumerate_candidates(
        N, algorithms=("async_window_gossip",), topologies=(EXP2,),
        wires=(None,), fused_k=(1,), include_concurrent=False,
        include_delayed=False)
    assert [c.algorithm for c in accepted] == ["async_window_gossip"]
    assert accepted[0].weights == "push"
    assert [r["config"]["weights"] for r in rejected] == ["dst"]
    assert "column-stochastic push" in rejected[0]["reason"]
    plan = pat.autotune(
        params={"w": torch.zeros(64, 8)},
        algorithms=("async_window_gossip", "neighbor_cta"),
        topologies=(EXP2,), wires=(None,), fused_k=(1,),
        include_delayed=False, include_concurrent=False,
        opt_factory=lambda: bfopt.sgd(0.05), measured_dir=str(tmp_path),
        bank_trials=False)
    audit = plan.doc["audit"]
    assert audit["considered"] == len(audit["scored"]) + len(audit["rejected"])
    assert any(s["key"].startswith("async_window_gossip")
               for s in audit["scored"])
    assert any(r["key"].startswith("async_window_gossip")
               and "weights=dst" in r["key"]
               and "column-stochastic push" in r["reason"]
               for r in audit["rejected"])
    doc = make_plan_doc(config=accepted[0].config(), objective="step_time",
                        n_chips=N, device_kind="cpu", predicted={},
                        audit={"scored": [], "rejected": [],
                               "considered": 0})
    strat = pat.Plan(doc).build_strategy(bfopt.sgd(0.05))
    step = bfopt.make_train_step(
        lambda p, b: (b.sum(), {"w": torch.zeros_like(p["w"])}), strat)
    params = {"w": torch.ones(N, 16)}
    state = bfopt.init_distributed(strat, params)
    params, state, _ = step(params, state, torch.zeros(N, 1))
    assert bool(torch.isfinite(params["w"]).all())


def _plan_doc(n_chips, fused_k=2):
    return make_plan_doc(
        config={"algorithm": "neighbor_cta",
                "topology": {"family": "exp2", "size": n_chips},
                "wire": None, "weights": "recv", "fused_k": fused_k,
                "delayed": False, "concurrent": None},
        objective="step_time", n_chips=n_chips, device_kind="cpu",
        predicted={}, audit={})


_SMOKE = ["--device", "cpu", "--image-size", "32", "--classes", "10",
          "--batch", "1", "--iters", "1"]


def test_bench_replays_plan(tmp_path):
    doc = _plan_doc(2)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(doc))
    got, _ = pbench.run(pbench.parse(_SMOKE + ["--ranks", "2",
                                               "--plan", str(path)]))
    pctx.shutdown()
    assert got["value"] > 0 and got["ok"]
    assert got["strategy"] == got["algorithm"] == "neighbor_cta"
    assert got["plan_id"] == doc["plan_id"]
    assert got["config_source"] == "plan:" + doc["plan_id"]
    assert got["steps_per_call"] == 2          # the plan's fused_k


def test_bench_refuses_plan_for_other_mesh(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(_plan_doc(4)))
    with pytest.raises(RuntimeError, match="re-tune on this mesh"):
        pbench.run(pbench.parse(_SMOKE + ["--ranks", "2",
                                          "--plan", str(path)]))
    pctx.shutdown()
    plain, _ = pbench.run(pbench.parse(_SMOKE + ["--ranks", "2"]))
    pctx.shutdown()
    assert plain["plan_id"] is None and plain["config_source"] == "default"
