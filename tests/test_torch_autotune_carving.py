"""The port's carving tuner and the tools' wire blocks against the JAX
package on the CPU, 8 ranks:

* ``tune_carving`` on ``tests/test_moe.py``'s MoE config and carvings:
  the same scored keys (3 carvings x 2 dispatch schemes) and the same
  audited rejections, every scored key's DCN bytes and dtypes equal to
  JAX's (the gossip, once a step), ICI bytes at or above JAX's static
  count, and the pipeline's permutes exactly JAX's times the ticks that
  ship (micro + pp - 2): JAX counts the scanned ``ppermute`` and its
  transpose once each, the ledger every tick's;
* ``tools/lm_bench.py``'s ``wire_bytes`` block and codec sweep against
  the JAX cost model's StableHLO count of the same carving at each codec;
* ``tools/serve_bench.py``'s MoE ``wire`` block: the ledger over one
  fused decode call finds the dispatch's all-to-alls, all ICI, none DCN.
"""
import contextlib
import io
import json

import pytest

import bluefog_tpu as jbf
from bluefog_tpu import autotune_lib as jat
from bluefog_tpu.autotune import cost_model as jcm
from bluefog_tpu.moe import MoELMConfig as JMoE
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu_torch import autotune_lib as pat
from bluefog_tpu_torch.autotune import cost_model as pcm
from bluefog_tpu_torch.moe.model import MoELMConfig as PMoE
from bluefog_tpu_torch.parallel import context as pctx
from bluefog_tpu_torch.tools import lm_bench
from bluefog_tpu_torch.tools import serve_bench
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

MOE = dict(layers=2, heads=4, d_model=32, seq_len=32, batch=4,
           num_experts=4, top_k=1, capacity_factor=2.0)
CARVINGS = [(2, 2, 1, 1, 2), (2, 2, 2, 1, 1), (4, 2, 1, 1, 1),
            (1, 2, 2, 2, 1), (2, 2, 1, 1, 4)]


def _capturing(monkeypatch, module, store):
    real = module.carving_wire_bytes

    def wrap(carve, cfg, **kw):
        stats = real(carve, cfg, **kw)
        store[(carve.key, getattr(cfg, "dispatch", None))] = stats
        return stats
    monkeypatch.setattr(module, "carving_wire_bytes", wrap)


def test_tune_carving_parity_with_jax(cpu_devices, monkeypatch):
    jstats, pstats = {}, {}
    _capturing(monkeypatch, jcm, jstats)
    _capturing(monkeypatch, pcm, pstats)
    jbf.init(devices=cpu_devices)
    try:
        jplan = jat.tune_carving(JMoE(**MOE), wire="bf16",
                                 carvings=CARVINGS)
    finally:
        jbf.shutdown()
    pctx.init(size=8, device="cpu")
    try:
        pplan = pat.tune_carving(PMoE(**MOE), wire="bf16",
                                 carvings=CARVINGS)
    finally:
        pctx.shutdown()
    json.dumps(pplan)
    assert pplan["schema"] == jplan["schema"] == pat.CARVING_PLAN_SCHEMA
    js = {e["key"]: e for e in jplan["audit"]["scored"]}
    ps = {e["key"]: e for e in pplan["audit"]["scored"]}
    assert len(ps) == 6 and set(ps) == set(js)
    assert pplan["audit"]["rejected"] == jplan["audit"]["rejected"]
    assert pplan["audit"]["considered"] == jplan["audit"]["considered"]
    assert pplan["model"] == jplan["model"]
    for key in ("objective", "n_chips", "device_kind", "wire"):
        assert pplan[key] == jplan[key]
    for key in ps:
        assert ps[key]["dcn_bytes"] == js[key]["dcn_bytes"] > 0, key
        assert ps[key]["ici_bytes"] >= js[key]["ici_bytes"] > 0, key
        assert ps[key].get("dispatch") == js[key].get("dispatch")
    assert set(pstats) == set(jstats)
    for k in jstats:
        assert pstats[k]["dcn_dtypes"] == jstats[k]["dcn_dtypes"] == \
            ["bf16"], k
        assert pstats[k]["dcn"] == jstats[k]["dcn"], k
        assert pstats[k]["slice_size"] == jstats[k]["slice_size"]
    best = pplan["best"]
    assert best["config"] == jplan["best"]["config"]
    assert best["config"]["dp"] == 2 and "dispatch" in best["config"]
    assert best["dcn_dtypes"] == jplan["best"]["dcn_dtypes"]
    assert ps["carve|dp=4|pp=2|tp=1|sp=1|ep=1"]["dcn_bytes"] > \
        best["dcn_bytes_per_step_per_chip"]
    # the trip-count factor: the pipeline ships micro + pp - 2 ticks a
    # direction; JAX's scan holds its ppermute and the transpose once
    ticks = PMoE(**MOE).micro + 2 - 2
    for carve in ("carve|dp=4|pp=2|tp=1|sp=1|ep=1",
                  "carve|dp=2|pp=2|tp=2|sp=1|ep=1"):
        for disp in ("capacity", "dropless"):
            jp = jstats[(carve, disp)]["ici"]["collective_permute"]
            pp = pstats[(carve, disp)]["ici"]["collective_permute"]
            assert jp["count"] == 2
            assert pp["bytes"] == jp["bytes"] * ticks, (carve, disp)


def _lm_cfg():
    return dict(vocab=64, d_model=32, heads=4, layers=2, seq_len=32,
                micro=4, batch=2)


def test_lm_bench_wire_block_and_sweep(cpu_devices):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        doc = lm_bench.main(["--device", "cpu"])
    wb_block, sweep = doc["wire_bytes"], doc["wire_sweep"]
    assert doc["ok"] and wb_block["slice_size"] == 4
    assert [s["wire"] for s in sweep] == [None, "bf16", "fp8@64"]
    assert doc["moe"] is None
    cfg = jcompose.LMConfig(**_lm_cfg())
    jbf.init(devices=cpu_devices)
    try:
        want = {w: jcm.carving_wire_bytes(
            jat.CarvingCandidate(2, 2, 2, 1, 1), cfg, wire=w)
            for w in (None, "bf16", "fp8@64")}
    finally:
        jbf.shutdown()
    assert wb_block["dcn"] == want[None]["dcn"]
    assert wb_block["dcn_dtypes"] == want[None]["dcn_dtypes"] == ["f32"]
    assert wb_block["ici_bytes"] >= want[None]["ici_bytes"]
    for row in sweep:
        w = want[row["wire"]]
        assert row["dcn_bytes"] == w["dcn_bytes"] > 0, row
        assert row["dcn_dtypes"] == w["dcn_dtypes"], row
        assert row["ici_bytes"] == wb_block["ici_bytes"] >= w["ici_bytes"]
    assert [r["dcn_dtypes"] for r in sweep] == [
        ["f32"], ["bf16"], ["f32", "f8E4M3FN"]]


def test_lm_bench_no_sweep_and_moe_note():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        doc = lm_bench.main(["--device", "cpu", "--moe", "--dropless",
                             "--pp", "1", "--tp", "1", "--ep", "2",
                             "--experts", "4", "--no-sweep"])
    assert doc["wire_sweep"] == []
    assert doc["wire_bytes"]["dcn_bytes"] > 0
    assert doc["wire_bytes"]["ici"]["all_to_all"]["count"] > 0
    assert "all_to_all" not in doc["wire_bytes"]["dcn"]
    assert doc["moe"]["dot_flops"] is None
    assert "lowers no program" in doc["moe"]["dot_flops_note"]


def test_serve_bench_moe_wire_is_ici_only():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        doc = serve_bench.main(["--device", "cpu", "--smoke",
                                "--serve-moe", "4x2@2:4"])
    wire = doc["moe"]["wire"]
    assert wire["dcn_bytes"] == 0 and wire["dcn"] == {}
    assert wire["ici"]["all_to_all"]["count"] > 0
    assert wire["ici"]["all_to_all"]["bytes"] > 0
    assert "none is DCN" in doc["moe"]["wire_note"]


@pytest.mark.parametrize("carve,reason", [
    ((1, 2, 2, 2, 1), "carving_no_gossip_axis"),
    ((2, 2, 1, 1, 4), "carving_size_mismatch"),
    ((2, 1, 1, 1, 4), "moe_carving_requires_num_experts")])
def test_dense_carving_rejections_keep_jax_texts(carve, reason):
    cand = pat.CarvingCandidate(*carve)
    want = jat.carving_violation(jat.CarvingCandidate(*carve), 8, None)
    got = pat.carving_violation(cand, 8, None)
    assert got == want and got.startswith(reason)
