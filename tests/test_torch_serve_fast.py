"""The port's serving fast paths vs the JAX engine, on the CPU.

Self-speculative decoding and shared prefix pages, side by side with the
JAX package:

* ``PrefixCache``: the same operation sequences (admit, seal, acquire,
  release, LRU eviction, a racing admit, an exhausted pool, the longest
  match) give the same rows, lengths, refcounts, digests, evictions and
  hit / miss counts; ``KVCacheConfig`` rows, trash slot, ``prefix_row``,
  ``bytes()`` and ``bytes_per_token()`` agree;
* ``draft_carve`` fields and errors, and the ``ServeConfig`` spec and
  prefix rules (constructor and ``from_env``) with the JAX texts;
* the dense engine at pp 2 (JAX ``compose_parallelism(1, 2, 1, 1)`` on
  two CPU devices; the port loads the same pp-carved tree into one
  module): one ``spec_decode`` call's ``emitted`` / ``counts``, one
  ``chunk_prefill``'s first token, the ``Scheduler.drain()`` streams and
  spec / prefix counts equal JAX's and the port's own plain greedy
  drain; two sharers of one sealed prefix equal the no-sharing streams;
* the MoE engine at pp 1 with its expert-mean draft: streams and spec
  counts equal JAX's;
* K3's chunk form past 64 query rows (T 40 x G 2) with prefix lanes, the
  port's plain version against the JAX kernel in interpret mode, f32 to
  1e-5.

The port's decode attention on the CPU is the plain version of the
flash-decode kernel K3; the JAX engines run ``decode_kernel="xla"``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.moe.model import MoELMConfig as JMoELMConfig
from bluefog_tpu.moe.model import init_moe_params as jinit_moe
from bluefog_tpu.ops import pallas_decode as jpd
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.serve import Scheduler as JScheduler
from bluefog_tpu.serve import ServeConfig as JServeConfig
from bluefog_tpu.serve import ServeEngine as JServeEngine
from bluefog_tpu.serve import kv_cache as jkv
from bluefog_tpu.utils import flight as bfflight
from bluefog_tpu.utils import metrics as bfm
from bluefog_tpu_torch.moe.model import MoELMConfig, moe_params_from_jax
from bluefog_tpu_torch.ops import flash_decode as tfd
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
from bluefog_tpu_torch.serve import kv_cache as tkv
from bluefog_tpu_torch.utils import flight as tflight
from bluefog_tpu_torch.utils import metrics as tbm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

_CFG = dict(vocab=64, d_model=32, heads=4, layers=4)
_SCFG = dict(batch_buckets=(1, 2), prefill_buckets=(4, 8), slots=4,
             max_len=32, decode_steps_per_call=1)
_FAST = dict(spec_decode=2, spec_stages=1, prefix_pages=2,
             prefix_page_tokens=4)
SHARED = [3, 1, 4, 1]                              # one page of 4 tokens
PROMPTS = [SHARED + [5, 9, 2], SHARED + [6, 5, 3, 5], [7, 7, 1],
           SHARED + [2, 7], [9, 2, 6, 5, 3, 5, 8], SHARED + [8, 1, 2, 6]]


@pytest.fixture(autouse=True)
def _clean():
    for reg in (bfm, tbm):
        reg.reset_metrics()
    for fl in (bfflight, tflight):
        fl.reset()
    yield
    for fl in (bfflight, tflight):
        fl.reset()
    for reg in (bfm, tbm):
        reg.reset_metrics()


def _metric(name, reg=bfm):
    m = reg.get_metric(name)
    return 0 if m is None else int(m.total())


def _tmetric(name):
    """The port's registry (each fixture starts it empty)."""
    return _metric(name, tbm)


# ---------------------------------------------------------------------------
# PrefixCache and KVCacheConfig
# ---------------------------------------------------------------------------

A = [1, 2, 3, 4, 5, 6, 7, 8, 9]                    # 2 pages of 4 + 1
B = [9, 8, 7, 6, 5]                                # 1 page + 1
C = [4, 4, 4, 4, 4, 4]
PREFIX_CASES = {
    "admit_seal_acquire_release": (2, [
        ("acquire", A), ("admit", A), ("seal", 0), ("attach", 0),
        ("acquire", A), ("acquire", A[:6]), ("release", 0), ("release", 0),
        ("match", A), ("release", 0), ("release", 0)]),
    "lru_eviction": (2, [
        ("admit", A), ("seal", 0), ("admit", B), ("seal", 1),
        ("acquire", A), ("release", 0), ("admit", C), ("seal", 1),
        ("match", B), ("match", A), ("match", C)]),
    "racing_admit": (2, [
        ("admit", A), ("admit", A), ("match", A), ("seal", 0),
        ("acquire", A), ("admit", A)]),
    "exhausted_pool": (1, [
        ("admit", A), ("seal", 0), ("attach", 0), ("admit", B),
        ("acquire", B), ("release", 0), ("admit", B), ("match", A)]),
    "short_and_longest": (3, [
        ("admit", [1, 2, 3, 4]), ("admit", A[:5]), ("seal", 0),
        ("admit", A), ("seal", 1), ("acquire", A + [0]),
        ("acquire", A[:7]), ("acquire", [1, 2, 3])]),
}


def _apply(pc, ops):
    rows = sorted(range(pc.first_row, pc.first_row + pc.pages))
    out = []
    for op, arg in ops:
        try:
            if op in ("seal", "attach", "release"):
                out.append(getattr(pc, op)(rows[arg]))
            else:
                out.append(getattr(pc, op)(arg))
        except (ValueError, KeyError) as e:
            out.append(("error", type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_cache_matches_jax(case):
    pages, ops = PREFIX_CASES[case]
    jpc = jkv.PrefixCache(pages, 4, first_row=5)
    tpc = tkv.PrefixCache(pages, 4, first_row=5)
    assert _apply(tpc, ops) == _apply(jpc, ops)
    assert tpc.describe() == jpc.describe()
    pages = "bluefog_serve_prefix_pages_in_use"
    assert tpc.in_use == jpc.in_use
    assert (tbm.get_metric(pages) is None) == (bfm.get_metric(pages) is None)
    if tbm.get_metric(pages) is not None:
        assert tbm.gauge(pages).value(replica="0") == \
            bfm.gauge(pages).value(replica="0") == tpc.in_use
    assert _tmetric("bluefog_serve_prefix_hits_total") == _metric(
        "bluefog_serve_prefix_hits_total")
    assert _tmetric("bluefog_serve_prefix_misses_total") == _metric(
        "bluefog_serve_prefix_misses_total")
    for bad in (0, -1):
        with pytest.raises(ValueError) as jerr:
            jkv.PrefixCache(bad, 4, first_row=0)
        with pytest.raises(ValueError) as terr:
            tkv.PrefixCache(bad, 4, first_row=0)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("store", ["raw", "int8", "fp8"])
def test_kv_cache_config_matches_jax(store):
    kw = dict(layers=2, slots=4, max_len=16, kv_heads=2, head_dim=8,
              store=store, prefix_slots=3)
    j, t = jkv.KVCacheConfig(**kw), tkv.KVCacheConfig(**kw)
    assert (t.rows, t.trash_slot, t.bytes(), t.bytes_per_token()) == \
        (j.rows, j.trash_slot, j.bytes(), j.bytes_per_token())
    assert [t.prefix_row(p) for p in range(3)] == \
        [j.prefix_row(p) for p in range(3)] == [4, 5, 6]
    for page in (-1, 3):
        with pytest.raises(ValueError) as jerr:
            j.prefix_row(page)
        with pytest.raises(ValueError) as terr:
            t.prefix_row(page)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# draft_carve and the ServeConfig rules
# ---------------------------------------------------------------------------

def test_draft_carve_matches_jax(cpu_devices):
    jcfg, tcfg = jcompose.LMConfig(**_CFG), tcompose.LMConfig(**_CFG)
    m = jcompose.compose_parallelism(1, 2, 1, 1, devices=cpu_devices[:2])
    for stages in (1, 2):
        j = jcompose.draft_carve(m, jcfg, stages)
        t = tcompose.draft_carve(2, tcfg, stages)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.cost_fraction, t.describe()) == \
            (j.cost_fraction, j.describe())
    for stages in (0, 3, "1"):
        with pytest.raises(ValueError) as jerr:
            jcompose.draft_carve(m, jcfg, stages)
        with pytest.raises(ValueError) as terr:
            tcompose.draft_carve(2, tcfg, stages)
        assert str(terr.value) == str(jerr.value)
    odd = dict(_CFG, layers=3)
    with pytest.raises(ValueError) as jerr:
        jcompose.draft_carve(m, jcompose.LMConfig(**odd), 1)
    with pytest.raises(ValueError) as terr:
        tcompose.draft_carve(2, tcompose.LMConfig(**odd), 1)
    assert str(terr.value) == str(jerr.value)


def test_serve_config_fast_path_rules_match_jax(monkeypatch):
    bad = [dict(spec_decode=-1), dict(spec_stages=0),
           dict(prefix_pages=-1), dict(prefix_page_tokens=0),
           dict(prefix_pages=2, prefix_page_tokens=32),
           dict(decode_kernel="pallas", decode_block_k=8, prefix_pages=2,
                prefix_page_tokens=12),
           dict(spec_decode=2, temperature=0.5)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            JServeConfig(**kw)
        with pytest.raises(ValueError) as terr:
            ServeConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    good = [dict(spec_decode=4), dict(spec_decode=4, decode_steps_per_call=8),
            dict(prefix_pages=2, prefix_page_tokens=8,
                 decode_kernel="pallas", decode_block_k=8),
            dict(spec_decode=0, temperature=0.5, prefix_pages=1)]
    for kw in good:
        assert ServeConfig(**kw).decode_window == \
            JServeConfig(**kw).decode_window
    fields = ("spec_decode", "spec_stages", "prefix_pages",
              "prefix_page_tokens")
    for sd, pp in (("4@1", "4x8"), ("3", "2"), ("0", "0x16")):
        monkeypatch.setenv("BLUEFOG_SPEC_DECODE", sd)
        monkeypatch.setenv("BLUEFOG_PREFIX_PAGES", pp)
        t, j = ServeConfig.from_env(), JServeConfig.from_env()
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]
    for env, val in (("BLUEFOG_SPEC_DECODE", "k@1"),
                     ("BLUEFOG_SPEC_DECODE", "2@-1"),
                     ("BLUEFOG_PREFIX_PAGES", "2xq")):
        monkeypatch.setenv(env, val)
        with pytest.raises(ValueError) as jerr:
            JServeConfig.from_env()
        with pytest.raises(ValueError) as terr:
            ServeConfig.from_env()
        assert str(terr.value) == str(jerr.value)
        monkeypatch.delenv(env)


# ---------------------------------------------------------------------------
# The dense engine at pp 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense(cpu_devices):
    jcfg = jcompose.LMConfig(**_CFG)
    m = jcompose.compose_parallelism(1, 2, 1, 1, devices=cpu_devices[:2])
    tree = jcompose.init_lm_params(jcfg, m, seed=3)
    cfg = tcompose.LMConfig(**_CFG)
    model = tcompose.params_from_jax(tree, cfg, device="cpu")
    return m, jcfg, tree, cfg, model


def _engines(dense, **kw):
    m, jcfg, tree, cfg, model = dense
    scfg = dict(_SCFG, **kw)
    return (JServeEngine(m, jcfg, tree, JServeConfig(**scfg)),
            ServeEngine(cfg, model, ServeConfig(**scfg), pp=2,
                        device="cpu"))


def _drain(sched_cls, engine, prompts, max_new=6):
    sched = sched_cls(engine)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.drain()
    if hasattr(sched, "close"):
        sched.close()
    assert all(r.state == "done" for r in reqs)
    return sched, reqs


def test_pp_carved_tree_loads_in_stage_order(dense):
    _, _, tree, cfg, model = dense
    want = tcompose.init_lm_params(cfg, 3, device="cpu")
    for a, b in zip(model.parameters(), want.parameters()):
        assert torch.equal(a, b)
    assert tcompose.draft_carve(2, cfg, 1).layers == 2
    bad = {"blocks": {"wqkv": np.zeros((2, 2, 16, 96), np.float32)},
           "shared": tree["shared"]}                # a tp-2 carving's rows
    with pytest.raises(ValueError, match="tp = 1 carving"):
        tcompose.params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="at pp = 1"):
        tcompose.params_from_jax(tree, cfg, device="cpu", stacked=True)
    with pytest.raises(ValueError, match=r"layers \(4\) % pp \(3\)"):
        ServeEngine(cfg, model, ServeConfig(**_SCFG), pp=3, device="cpu")


def test_spec_decode_and_chunk_prefill_calls_match_jax(dense):
    jeng, teng = _engines(dense, **_FAST)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        first, _ = eng.prefill(0, 0, PROMPTS[4])
        trash = eng.cache_cfg.trash_slot
        emitted, counts = eng.spec_decode(
            np.array([[first, 0]]), np.array([[0, trash]]),
            np.array([[len(PROMPTS[4]), 0]]))
        row = eng.cache_cfg.slots
        eng.seal_prefix(0, row, SHARED)
        chunk_first = eng.chunk_prefill(0, 1, PROMPTS[1][4:], 4, row)
        out[name] = (np.asarray(emitted), np.asarray(counts), chunk_first)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][0].shape == (1, 2, 3)
    assert out["port"][2] == out["jax"][2]
    # the chunked prefill equals a plain prefill of the whole prompt
    assert out["port"][2] == teng.prefill(0, 2, PROMPTS[1])[0]
    with pytest.raises(ValueError, match="prefix row 3 out of range"):
        teng.seal_prefix(0, 3, SHARED)
    with pytest.raises(ValueError, match="not whole pages"):
        teng.seal_prefix(0, 4, SHARED[:3])


def test_fast_drain_matches_jax_and_plain_greedy(dense):
    jeng, teng = _engines(dense, **_FAST)
    jsched, jreqs = _drain(JScheduler, jeng, PROMPTS)
    jdrafted = _metric("bluefog_serve_spec_drafted_total")
    jaccepted = _metric("bluefog_serve_spec_accepted_total")
    jhits = _metric("bluefog_serve_prefix_hits_total")
    tsched, treqs = _drain(Scheduler, teng, PROMPTS)
    got = [r.generated for r in treqs]
    assert got == [r.generated for r in jreqs]
    assert [(r.prefix_row, r.prefix_len) for r in treqs] == \
        [(r.prefix_row, r.prefix_len) for r in jreqs]
    assert (_tmetric("bluefog_serve_spec_drafted_total"),
            _tmetric("bluefog_serve_spec_accepted_total")) == \
        (jdrafted, jaccepted)
    assert _tmetric("bluefog_serve_prefix_hits_total") == jhits == 3
    assert [r.prefix_hit for r in treqs] == [False, True, False, True,
                                             False, True]
    assert tsched._prefix[0].describe() == jsched._prefix[0].describe()
    plain = ServeEngine(dense[3], dense[4], ServeConfig(**_SCFG), pp=2,
                        device="cpu")
    assert [r.generated for r in _drain(Scheduler, plain, PROMPTS)[1]] == got


def test_prefix_cow_no_cross_contamination(dense):
    """Two sharers of one sealed prefix page diverge into private slots:
    both streams equal an engine with sharing off (the JAX test's
    copy-on-write case)."""
    _, fast = _engines(dense, **_FAST)
    _, plain = _engines(dense)
    a, b = PROMPTS[0], PROMPTS[1]
    want = [r.generated for r in _drain(Scheduler, plain, [a, b])[1]]
    sched, reqs = _drain(Scheduler, fast, [a, b])
    assert [r.generated for r in reqs] == want
    assert _tmetric("bluefog_serve_prefix_hits_total") == 1
    assert [r.prefix_len for r in reqs] == [4, 4]


def test_prefix_rows_need_prefix_pages(dense):
    _, teng = _engines(dense)
    z = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError, match="prefix_pages > 0"):
        teng.decode(z, z, z, prefix_rows=z, prefix_lens=z)
    with pytest.raises(ValueError, match="spec_decode is not armed"):
        teng.spec_decode(z, z, z)


# ---------------------------------------------------------------------------
# The MoE engine at pp 1: the expert-mean draft
# ---------------------------------------------------------------------------

def test_moe_spec_and_prefix_drain_matches_jax(cpu_devices):
    E = 4
    ckw = dict(_CFG, layers=2, num_experts=E, top_k=2, dispatch="dropless",
               group_tile=4)
    m = jcompose.compose_parallelism(1, 1, 1, 1, 1, num_experts=E,
                                     devices=cpu_devices[:1])
    tree = jinit_moe(JMoELMConfig(**ckw), m, seed=5)
    scfg = dict(_SCFG, batch_buckets=(2, 4), moe_experts=E, moe_top_k=2,
                **_FAST)
    jeng = JServeEngine(m, JMoELMConfig(**ckw), tree, JServeConfig(**scfg))
    _, jreqs = _drain(JScheduler, jeng, PROMPTS)
    jcounts = (_metric("bluefog_serve_spec_drafted_total"),
               _metric("bluefog_serve_spec_accepted_total"))
    cfg = MoELMConfig(**ckw)
    model = moe_params_from_jax(tree, cfg, device="cpu")
    teng = ServeEngine(cfg, model, ServeConfig(**scfg), device="cpu")
    _, treqs = _drain(Scheduler, teng, PROMPTS)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert (_tmetric("bluefog_serve_spec_drafted_total"),
            _tmetric("bluefog_serve_spec_accepted_total")) == jcounts
    assert teng.draft.layers == cfg.layers          # pp 1: every layer
    j, t = jeng.moe_load()[0], teng.moe_load()[0]   # the last verify chunk
    np.testing.assert_array_equal(t["counts"], j["counts"])
    assert t["tokens"] == j["tokens"]


# ---------------------------------------------------------------------------
# K3's chunk form past 64 query rows
# ---------------------------------------------------------------------------

def test_flash_attend_chunk_beyond_64_rows_matches_pallas():
    """T 40 x G 2 = 80 query rows a kv head (two 64-row tiles on the
    card), lanes attached to a prefix row and one of length 0."""
    rng = np.random.default_rng(6)
    rows, Hkv, L, Dh, H, T = 5, 2, 128, 8, 4, 40
    k, v = (rng.normal(size=(rows, Hkv, L, Dh)).astype(np.float32)
            for _ in range(2))
    q = rng.normal(size=(3, T, H, Dh)).astype(np.float32)
    slots, lens = np.array([0, 4, 2], np.int32), np.array([48, 0, 80],
                                                         np.int32)
    ps, pl = np.array([3, 3, 3], np.int32), np.array([32, 0, 16], np.int32)
    want = jpd.flash_attend_chunk(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(slots), jnp.asarray(lens), prefix_slots=jnp.asarray(ps),
        prefix_lens=jnp.asarray(pl), block_k=16, interpret=True)
    got = tfd.flash_attend_chunk(
        torch.from_numpy(q), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v)},
        torch.from_numpy(slots), torch.from_numpy(lens),
        prefix_slots=torch.from_numpy(ps), prefix_lens=torch.from_numpy(pl),
        block_k=16)
    assert tfd.row_tiles(T * H // Hkv) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
