"""The port's dense serving slice vs the JAX engine, end to end on the CPU.

A JAX ``ServeEngine`` on one CPU device (dp = pp = tp = 1) and the port's
``ServeEngine(device="cpu")`` built from the same weights through
``params_from_jax``:

* ``init_lm_params`` draws bit-identical arrays on both sides;
* the pieces under the engine (``_ln``, ``dense_attention``) agree in f32;
* prefill's last-position logits agree to 1e-4 (f32, eight matmuls deep);
* greedy token streams through ``Scheduler.drain()`` are identical for
  four mixed-length requests with raw and int8 KV pages — the port's
  decode attention on the CPU is the plain version of the flash-decode
  kernel, the JAX engine's is its ``"xla"`` gather-then-attend path;
* the config surface keeps the JAX rules; speculative decoding, prefix
  pages and expert-parallel MoE serving are accepted and parse as the
  JAX config parses them (their engine paths:
  tests/test_torch_serve_fast.py and tests/test_torch_serve_carved.py).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.ops.ulysses import dense_attention as jdense
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.serve import Scheduler as JScheduler
from bluefog_tpu.serve import ServeConfig as JServeConfig
from bluefog_tpu.serve import ServeEngine as JServeEngine
from bluefog_tpu.utils import flight as bfflight
from bluefog_tpu.utils import metrics as bfm
from bluefog_tpu_torch.ops.ulysses import dense_attention as tdense
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
from bluefog_tpu_torch.serve.engine import _parse_buckets
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_CFG = dict(vocab=64, d_model=32, heads=4, layers=2)
_SCFG = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16), slots=4,
             max_len=32, decode_steps_per_call=2)
PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [31, 4],
           [27, 18, 28, 18, 28, 45, 23, 53, 60, 28, 74 % 64, 71 % 64, 35]]


@pytest.fixture(scope="module")
def jax_side(cpu_devices):
    cfg = jcompose.LMConfig(**_CFG)
    m = jcompose.compose_parallelism(1, devices=cpu_devices[:1])
    return cfg, m, jcompose.init_lm_params(cfg, m, seed=4)


def _port(jax_side, kv_dtype="raw"):
    jcfg, _, params = jax_side
    cfg = tcompose.LMConfig(**_CFG)
    model = tcompose.params_from_jax(params, cfg, device="cpu")
    return ServeEngine(cfg, model, ServeConfig(kv_dtype=kv_dtype, **_SCFG),
                       device="cpu")


def _streams(sched_cls, engine, max_new=6):
    sched = sched_cls(engine)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in PROMPTS]
    sched.drain()
    if hasattr(sched, "close"):
        sched.close()
    assert all(r.state == "done" for r in reqs)
    return [r.generated for r in reqs]


def test_init_lm_params_bit_identical(cpu_devices):
    jcfg = jcompose.LMConfig(**_CFG)
    m = jcompose.compose_parallelism(1, devices=cpu_devices[:1])
    tree = jcompose.init_lm_params(jcfg, m, seed=9)
    model = tcompose.init_lm_params(tcompose.LMConfig(**_CFG), 9,
                                    device="cpu")
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(tree["shared"]["embed"])[0])
    np.testing.assert_array_equal(model.head.numpy(),
                                  np.asarray(tree["shared"]["head"])[0])
    for name in ("wqkv", "wo", "w1", "w2"):
        want = np.asarray(tree["blocks"][name])[0]
        for i, blk in enumerate(model.blocks):
            np.testing.assert_array_equal(getattr(blk, name).numpy(),
                                          want[i])
    assert tcompose.LMConfig(**_CFG).n_params == jcfg.n_params


def test_ln_and_dense_attention_match_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        tcompose._ln(torch.from_numpy(z)).numpy(),
        np.asarray(jcompose._ln(jnp.asarray(z))), atol=1e-5, rtol=0)
    q, k, v = (rng.normal(size=(2, 7, 4, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        want = np.asarray(jdense(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal))
        got = tdense(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_prefill_logits_match_jax(jax_side):
    cfg, m, params = jax_side
    jeng = JServeEngine(m, cfg, params, JServeConfig(**_SCFG))
    teng = _port(jax_side)
    for slot, prompt in enumerate(PROMPTS[:2]):
        jtok, jlog = jeng.prefill(0, slot, prompt)
        ttok, tlog = teng.prefill(0, slot, prompt)
        np.testing.assert_allclose(tlog, np.asarray(jlog), atol=1e-4,
                                   rtol=0)
        assert ttok == jtok
    # the engine's cached prefill equals the module's cache-free forward
    ref = teng.model(torch.tensor([PROMPTS[1]]))[0, -1].numpy()
    np.testing.assert_allclose(tlog, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["raw", "int8"])
def test_greedy_streams_identical_to_jax(jax_side, kv_dtype):
    cfg, m, params = jax_side
    bfm.reset_metrics()
    bfflight.reset()
    jeng = JServeEngine(m, cfg, params,
                        JServeConfig(kv_dtype=kv_dtype, **_SCFG))
    want = _streams(JScheduler, jeng)
    bfflight.reset()
    bfm.reset_metrics()
    got = _streams(Scheduler, _port(jax_side, kv_dtype))
    assert got == want
    assert [len(g) for g in got] == [6] * 4


def test_decode_surface_and_slot_reuse(jax_side):
    """The [replicas, S] host surface, a padded bucket, and a recycled
    slot giving the same stream as a fresh engine."""
    eng = _port(jax_side)
    first, _ = eng.prefill(0, 1, PROMPTS[0])
    tok, trash, _ = eng.idle_lane()
    out = eng.decode(np.array([[first, tok]]), np.array([[1, trash]]),
                     np.array([[len(PROMPTS[0]), 0]]))
    assert out.shape == (1, 2, 2) and out.dtype == np.int32
    with pytest.raises(ValueError, match="not a declared bucket"):
        eng.decode(np.zeros((1, 3)), np.zeros((1, 3)), np.zeros((1, 3)))
    with pytest.raises(ValueError, match="replicas=1"):
        eng.decode(np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="prefix_pages > 0"):
        eng.decode(np.zeros((1, 2)), np.zeros((1, 2)), np.zeros((1, 2)),
                   prefix_rows=np.zeros((1, 2)))
    fresh = _streams(Scheduler, _port(jax_side))
    eng.warmup()                                  # dirties every slot
    assert _streams(Scheduler, eng) == fresh


def test_sampling_is_seeded(jax_side):
    cfg = tcompose.LMConfig(**_CFG)
    model = tcompose.params_from_jax(jax_side[2], cfg, device="cpu")
    runs = []
    for seed in (1, 1, 2):
        eng = ServeEngine(cfg, model, ServeConfig(
            temperature=1.0, top_p=0.9, seed=seed, **_SCFG), device="cpu")
        runs.append(_streams(Scheduler, eng))
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_serve_config_rules_match_jax(monkeypatch):
    assert _parse_buckets("1,2,4@8,16") == ((1, 2, 4), (8, 16))
    with pytest.raises(ValueError, match="expected"):
        _parse_buckets("a,b@c")
    # each case builds both sides with the same decode_kernel: the block
    # is checked only under "pallas"
    bad = [dict(batch_buckets=(4, 2)), dict(batch_buckets=(1, 16)),
           dict(prefill_buckets=(8, 128)), dict(batch_buckets=()),
           dict(kv_dtype="int4"), dict(decode_kernel="triton"),
           dict(decode_kernel="pallas", decode_block_k=24),
           dict(decode_kernel="pallas", max_len=200,
                prefill_buckets=(8, 16)),
           dict(decode_kernel="pallas", max_len=60, decode_block_k=12),
           dict(temperature=-1.0), dict(top_p=0.0),
           dict(decode_steps_per_call=0)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            JServeConfig(**kw)
        with pytest.raises(ValueError) as terr:
            ServeConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    good = [dict(max_len=200, prefill_buckets=(8, 16)),
            dict(max_len=60, decode_block_k=12), dict(decode_block_k=24),
            dict(decode_kernel="pallas", max_len=64, decode_block_k=16)]
    for kw in good:
        jcfg, tcfg = JServeConfig(**kw), ServeConfig(**kw)
        assert (tcfg.max_len, tcfg.decode_block_k) == \
            (jcfg.max_len, jcfg.decode_block_k)
        assert tcfg.kernel_block_k == (
            tcfg.decode_block_k if tcfg.decode_kernel == "pallas"
            else tcfg.max_len)
    monkeypatch.setenv("BLUEFOG_SERVE_BUCKETS", "1,2@4,32")
    monkeypatch.setenv("BLUEFOG_KV_DTYPE", "fp8")
    monkeypatch.setenv("BLUEFOG_DECODE_KERNEL", "pallas@16")
    cfg = ServeConfig.from_env(slots=4)
    assert (cfg.batch_buckets, cfg.prefill_buckets, cfg.kv_dtype,
            cfg.decode_kernel, cfg.decode_block_k) == \
        ((1, 2), (4, 32), "fp8", "pallas", 16)


_FAST_FIELDS = ("spec_decode", "spec_stages", "prefix_pages",
                "prefix_page_tokens", "decode_window")
_MOE_FIELDS = ("moe_experts", "moe_top_k", "moe_ep", "moe_tile")


@pytest.mark.parametrize("kw,env,match", [
    (dict(spec_decode=2), ("BLUEFOG_SPEC_DECODE", "2@1"), None),
    (dict(prefix_pages=2), ("BLUEFOG_PREFIX_PAGES", "2x8"), None),
    (dict(moe_experts=4, moe_ep=2), ("BLUEFOG_SERVE_MOE", "4@2"),
     "MoE serving"),
])
def test_later_slices_refused_by_name(monkeypatch, kw, env, match):
    """Speculative decoding, prefix pages and expert-parallel MoE serving
    (``match`` names that case: its fields are the MoE knobs) are ported:
    the same kwargs and env strings are accepted and parse as the JAX
    config's."""
    names = _MOE_FIELDS if match else _FAST_FIELDS

    def fields(c):
        return [getattr(c, f) for f in names]
    assert fields(ServeConfig(**kw)) == fields(JServeConfig(**kw))
    monkeypatch.setenv(*env)
    assert fields(ServeConfig.from_env()) == fields(JServeConfig.from_env())
    if match:
        assert ServeConfig.from_env().moe_ep == 2


def test_demo_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BLUEFOG_")}
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.serve", "--device", "cpu",
         "--requests", "3", "--layers", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert doc["completed"] == 3 and doc["tokens"] == 12
    assert doc["device"] == "cpu"


@pytest.mark.parametrize("argv,moe,want", [
    (["--dp", "2", "--tp", "2"], "", (2, 1, 2, 1)),
    (["--dp", "2"], "4x2@2", (2, 1, 1, 2)),
])
def test_demo_carved_on_cpu(argv, moe, want):
    """The demo carves ``--dp`` replicas x ``--tp`` (x the ``@ep`` of
    ``BLUEFOG_SERVE_MOE``) and prints the JAX demo's carving fields."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BLUEFOG_")}
    if moe:
        env["BLUEFOG_SERVE_MOE"] = moe
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.serve", "--device", "cpu",
         "--requests", "4", "--layers", "2"] + argv,
        cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert (doc["replicas"], doc["pp"], doc["tp"], doc["ep"]) == want
    assert doc["completed"] == 4 and doc["tokens"] == 16


def test_serve_calls_tool_on_cpu(monkeypatch, capsys):
    """``tools/serve_calls.py`` times decode calls and counts the host's
    operators a call; ``--ab`` runs two checkouts alternately (here this
    one twice).  Run in process: the fresh process of each ``--ab`` run
    is replaced by the measurement it would make."""
    from bluefog_tpu_torch.tools import serve_calls
    for key in [k for k in os.environ if k.startswith("BLUEFOG_")]:
        monkeypatch.delenv(key)
    roots = []

    def run_here(cmd, cwd, capture_output, text):
        root = cmd[cmd.index("--root") + 1]
        assert root == cwd
        roots.append(root)
        doc = serve_calls.measure("--moe" in cmd,
                                  int(cmd[cmd.index("--calls") + 1]),
                                  cmd[cmd.index("--device") + 1])
        return subprocess.CompletedProcess(cmd, 0, json.dumps(doc) + "\n",
                                           "")

    monkeypatch.setattr(serve_calls.subprocess, "run", run_here)
    threads = torch.get_num_threads()
    try:
        assert serve_calls.main(["--device", "cpu", "--calls", "2", "--ab",
                                 REPO, "--pairs", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    docs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert roots == [REPO, REPO]
    assert [d["tree"] for d in docs] == ["parent", "change"]
    for d in docs:
        assert d["model"] == "dense" and d["ops_per_decode_call"] > 0
        assert d["decode_call_ms_min"] <= d["decode_call_ms_median"]
