"""The port's MoE serving slice vs the JAX engine, end to end on the CPU.

A small MoE model (vocab 64, d_model 32, 4 heads, 2 layers, 4 experts,
top-1 and top-2, dropless dispatch) served by the JAX ``ServeEngine`` at
dp = ep = 1 and by the port's ``ServeEngine(device="cpu")`` built from the
same weights through ``moe_params_from_jax``.  The port's expert FFN on
the CPU is the plain version of the grouped-FFN kernel K4, the JAX
engine's the ``"xla"`` batched einsum:

* ``BLUEFOG_SERVE_MOE`` parsing and the ``ServeConfig`` / engine MoE
  rules keep the JAX error texts; ``moe_ep = 2`` is refused by name;
* prefill logits agree within 1e-4;
* greedy token streams through ``Scheduler.drain()`` are identical (top-2
  with raw and int8 KV pages, top-1 with raw pages);
* the automatic decode tile equals the JAX engine's, and ``moe_load()``
  after one decode call has equal counts and entropy within 1e-5;
* the demo entry point serves an MoE model with ``BLUEFOG_SERVE_MOE``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bluefog_tpu.moe.model import MoELMConfig as JMoELMConfig
from bluefog_tpu.moe.model import init_moe_params as jinit_moe
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.serve import Scheduler as JScheduler
from bluefog_tpu.serve import ServeConfig as JServeConfig
from bluefog_tpu.serve import ServeEngine as JServeEngine
from bluefog_tpu.serve.engine import _parse_serve_moe as _jparse
from bluefog_tpu.utils import flight as bfflight
from bluefog_tpu.utils import metrics as bfm
from bluefog_tpu_torch.moe.model import MoELMConfig, moe_params_from_jax
from bluefog_tpu_torch.parallel.compose import LMConfig, init_lm_params
from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
from bluefog_tpu_torch.serve.engine import _parse_serve_moe

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
E = 4
_CFG = dict(vocab=64, d_model=32, heads=4, layers=2, num_experts=E,
            dispatch="dropless", group_tile=4)
_SCFG = dict(batch_buckets=(2, 4), prefill_buckets=(8, 16), slots=4,
             max_len=32, decode_steps_per_call=2, moe_experts=E)
PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [31, 4],
           [27, 18, 28, 18, 28, 45, 23, 53, 60, 28, 10, 7, 35]]


def _streams(sched_cls, engine, max_new=6):
    sched = sched_cls(engine)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in PROMPTS]
    sched.drain()
    if hasattr(sched, "close"):
        sched.close()
    assert all(r.state == "done" for r in reqs)
    return [r.generated for r in reqs]


def _one_decode(eng):
    """Prefill two prompts, then one decode call at the 4-lane bucket with
    two idle lanes on the trash slot."""
    t0, _ = eng.prefill(0, 0, PROMPTS[0])
    t1, _ = eng.prefill(0, 2, PROMPTS[1])
    tok, trash, _ = eng.idle_lane()
    gen = eng.decode(np.array([[t0, t1, tok, tok]]),
                     np.array([[0, 2, trash, trash]]),
                     np.array([[len(PROMPTS[0]), len(PROMPTS[1]), 0, 0]]))
    return np.asarray(gen), eng.moe_load()


@pytest.fixture(scope="module")
def runs(cpu_devices):
    """Per (top_k, kv_dtype): the JAX and the port engine's streams,
    prefill logits, decode tile and one decode call's load."""
    m = jcompose.compose_parallelism(1, 1, 1, 1, 1, num_experts=E,
                                     devices=cpu_devices[:1])
    out = {}
    for k, kv in ((2, "raw"), (2, "int8"), (1, "raw")):
        jcfg = JMoELMConfig(top_k=k, **_CFG)
        params = jinit_moe(jcfg, m, seed=5)
        scfg = dict(_SCFG, moe_top_k=k, kv_dtype=kv)
        bfm.reset_metrics()
        bfflight.reset()
        jeng = JServeEngine(m, jcfg, params, JServeConfig(**scfg))
        cfg = MoELMConfig(top_k=k, **_CFG)
        teng = ServeEngine(cfg, moe_params_from_jax(params, cfg,
                                                    device="cpu"),
                           ServeConfig(**scfg), device="cpu")
        r = {}
        for name, eng, sched in (("jax", jeng, JScheduler),
                                 ("port", teng, Scheduler)):
            logits = [np.asarray(eng.prefill(0, s, p)[1])
                      for s, p in enumerate(PROMPTS[:2])]
            r[name] = dict(streams=_streams(sched, eng), logits=logits,
                           tile=eng._moe_tile, decode=_one_decode(eng))
            bfflight.reset()
            bfm.reset_metrics()
        r["engine"] = teng
        out[(k, kv)] = r
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_prefill_logits_match_jax(runs, k):
    r = runs[(k, "raw")]
    for got, want in zip(r["port"]["logits"], r["jax"]["logits"]):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the engine's cached prefill equals the module's cache-free forward
    eng = r["engine"]
    ref = eng.model(torch.tensor([PROMPTS[1]]))[0, -1].numpy()
    np.testing.assert_allclose(r["port"]["logits"][1], ref, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k,kv", [(2, "raw"), (2, "int8"), (1, "raw")])
def test_greedy_streams_identical_to_jax(runs, k, kv):
    r = runs[(k, kv)]
    assert r["port"]["streams"] == r["jax"]["streams"]
    assert [len(g) for g in r["port"]["streams"]] == [6] * 4


@pytest.mark.parametrize("k", [1, 2])
def test_decode_tile_and_moe_load_match_jax(runs, k):
    r = runs[(k, "raw")]
    assert r["port"]["tile"] == r["jax"]["tile"] == (2 if k == 2 else 1)
    (tgen, tload), (jgen, jload) = r["port"]["decode"], r["jax"]["decode"]
    np.testing.assert_array_equal(tgen[:, :, :2], jgen[:, :, :2])
    assert len(tload) == len(jload) == 1
    t, j = tload[0], jload[0]
    np.testing.assert_array_equal(t["counts"], j["counts"])
    np.testing.assert_array_equal(t["fractions"], j["fractions"])
    assert t["tokens"] == j["tokens"] == 2 * 2 * _CFG["layers"]
    assert abs(t["entropy"] - j["entropy"]) <= 1e-5
    dense = ServeEngine(LMConfig(layers=1),
                        init_lm_params(LMConfig(layers=1), device="cpu"),
                        ServeConfig(), device="cpu")
    assert dense.moe_load() is None


def test_parse_serve_moe_matches_jax():
    for spec in ("8", "8x2", "8x2@2", "8x2@2:4", "4:1", " 4 x 1 "):
        assert _parse_serve_moe(spec) == _jparse(spec)
    for spec in ("", "x2", "8xk", "8x0", "8@0", "8x2:z", "8x2@2:0"):
        with pytest.raises(ValueError) as jerr:
            _jparse(spec)
        with pytest.raises(ValueError) as terr:
            _parse_serve_moe(spec)
        assert str(terr.value) == str(jerr.value)


def test_serve_config_moe_rules_match_jax(monkeypatch):
    bad = [dict(moe_experts=-1), dict(moe_experts=4, moe_top_k=3),
           dict(moe_experts=4, moe_ep=0), dict(moe_experts=4, moe_ep=3),
           dict(moe_experts=4, moe_tile=9)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            JServeConfig(**kw)
        with pytest.raises(ValueError) as terr:
            ServeConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    monkeypatch.setenv("BLUEFOG_SERVE_MOE", "8x2:4")
    got, want = ServeConfig.from_env(), JServeConfig.from_env()
    for f in ("moe_experts", "moe_top_k", "moe_ep", "moe_tile"):
        assert getattr(got, f) == getattr(want, f)
    # expert parallelism is the one MoE knob still refused, by name
    monkeypatch.setenv("BLUEFOG_SERVE_MOE", "8x2@2")
    JServeConfig.from_env()
    with pytest.raises(ValueError,
                       match="expert-parallel MoE serving.*not yet ported"):
        ServeConfig.from_env()
    with pytest.raises(ValueError,
                       match="expert-parallel MoE serving.*not yet ported"):
        ServeConfig(moe_experts=8, moe_ep=2)


def test_engine_moe_cross_checks_match_jax(cpu_devices):
    m = jcompose.compose_parallelism(1, 1, 1, 1, 1, num_experts=E,
                                     devices=cpu_devices[:1])
    cases = [
        (dict(router_mode="expert_choice"), dict()),     # EC at serve time
        (dict(), dict(moe_experts=2 * E)),               # knob vs model
        (dict(top_k=2), dict(moe_experts=E, moe_top_k=1)),
    ]
    for ckw, skw in cases:
        jcfg = JMoELMConfig(**dict(_CFG, **ckw))
        cfg = MoELMConfig(**dict(_CFG, **ckw))
        scfg = dict(_SCFG, **skw)
        with pytest.raises(ValueError) as jerr:
            JServeEngine(m, jcfg, jinit_moe(JMoELMConfig(**_CFG), m),
                         JServeConfig(**scfg))
        model = moe_params_from_jax(jinit_moe(JMoELMConfig(**_CFG), m),
                                    MoELMConfig(**_CFG), device="cpu")
        model.cfg = cfg
        with pytest.raises(ValueError) as terr:
            ServeEngine(cfg, model, ServeConfig(**scfg), device="cpu")
        assert str(terr.value) == str(jerr.value)
    dense = LMConfig(**{k: _CFG[k] for k in ("vocab", "d_model", "heads",
                                              "layers")})
    jm = jcompose.compose_parallelism(1, devices=cpu_devices[:1])
    jdense = jcompose.LMConfig(**{k: _CFG[k] for k in ("vocab", "d_model",
                                                        "heads", "layers")})
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jm, jdense, jcompose.init_lm_params(jdense, jm),
                     JServeConfig(**_SCFG))
    with pytest.raises(ValueError) as terr:
        ServeEngine(dense, init_lm_params(dense, device="cpu"),
                    ServeConfig(**_SCFG), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_moe_demo_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BLUEFOG_")}
    env["BLUEFOG_SERVE_MOE"] = "8x2"
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.serve", "--device", "cpu",
         "--requests", "3", "--layers", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert doc["completed"] == 3 and doc["tokens"] == 12
    assert doc["moe_experts"] == 8 and doc["device"] == "cpu"
