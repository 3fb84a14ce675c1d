"""The carved serving engine vs the JAX engine, end to end on the CPU.

The JAX ``ServeEngine`` over a carving of the 8 virtual CPU devices and
the port's ``ServeEngine(device="cpu")`` over the same tree, loaded with
``params_from_jax(tree, cfg, m=m)`` / ``moe_params_from_jax(tree, cfg,
m=m)``.  Replica 1's rows come from another seed's tree (trained
replicas diverge, and a lane of one replica that read another's weights,
prefix pages or trash row would show).  Carvings:

* dense dp 2 x pp 2 x tp 2 (the config of tests/test_serve.py's engine
  fixture);
* MoE dp 2 x ep 2 (tests/test_serve_moe.py's fixture: 4 experts top-2);
* MoE dp 1 x pp 2 x tp 2 x ep 2 (tp and ep together: each owner's
  experts cut F / tp), on all 8 devices.

For each: the loader keeps every replica's rows and the tp / ep shards
as JAX cuts them; prefill logits per replica agree to 1e-4 and equal the
replica's joined module (``ServingParams.replica``, the carving of size
1); greedy ``Scheduler.drain()`` streams and replica assignments are
identical at raw and int8 pages; for MoE the decode tile and
``moe_load()`` per replica equal JAX's.  Also: speculative decoding with
prefix pages at the dense carving, ``update_params`` with a perturbed
tree on both engines, the loaders' and the engine's refusals with JAX's
texts (sp > 1, the ``moe_ep`` cross-check).  The port's decode attention on
the CPU is K3's plain version and its expert FFN K4's; the JAX engines
run ``decode_kernel="xla"``.
"""
import jax
import numpy as np
import pytest
import torch

from bluefog_tpu.moe.model import MoELMConfig as JMoELMConfig
from bluefog_tpu.moe.model import init_moe_params as jinit_moe
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.serve import Scheduler as JScheduler
from bluefog_tpu.serve import ServeConfig as JServeConfig
from bluefog_tpu.serve import ServeEngine as JServeEngine
from bluefog_tpu.utils import flight as bfflight
from bluefog_tpu.utils import metrics as bfm
from bluefog_tpu_torch.moe.model import MoELMConfig, moe_params_from_jax
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
from bluefog_tpu_torch.utils import metrics as tbm
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

E = 4
_DENSE = dict(vocab=32, d_model=32, heads=4, layers=4, seq_len=32)
_MOE = dict(vocab=32, d_model=16, heads=4, layers=2, seq_len=32, micro=1,
            batch=2, num_experts=E, top_k=2, dispatch="dropless")
CARVINGS = {                   # name: (dp, pp, tp, ep), model config
    "dense_dp2_pp2_tp2": ((2, 2, 2, 1), None),
    "moe_dp2_ep2": ((2, 1, 1, 2), _MOE),
    "moe_pp2_tp2_ep2": ((1, 2, 2, 2), dict(_MOE, layers=4)),
}
_SCFG = dict(batch_buckets=(1, 2), prefill_buckets=(8,), slots=4,
             max_len=32, decode_steps_per_call=1)
PROMPTS = [[5, 11, 2, 7, 19, 3], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2],
           [4, 4], [3, 1, 4, 1, 5], [27, 18, 28, 18, 28, 4, 5]]
SHARED = [3, 1, 4, 1]                             # one prefix page of 4
FAST_PROMPTS = [SHARED + [5, 9, 2], SHARED + [6, 5, 3, 5], [7, 7, 1],
                SHARED + [2, 7], [9, 2, 6, 5, 3, 5, 8], SHARED + [8, 1]]
_FAST_COUNTERS = ("bluefog_serve_spec_drafted_total",
                  "bluefog_serve_spec_accepted_total",
                  "bluefog_serve_prefix_hits_total")


@pytest.fixture(autouse=True)
def _clean():
    bfm.reset_metrics()
    bfflight.reset()
    yield
    bfflight.reset()
    bfm.reset_metrics()


def _replica_of(m):
    return np.unravel_index(np.arange(m.size),
                            (m.dp, m.pp, m.tp, m.sp, m.ep))[0]


def _tree(cfg, m, seeds, moe):
    """The JAX tree of ``m`` at ``seeds[0]`` with every row of replica r
    >= 1 taken from the tree at ``seeds[r]`` (each draw is consistent
    within its replica: shared leaves and sp / ep copies agree)."""
    init = jinit_moe if moe else jcompose.init_lm_params
    trees = [jax.tree.map(np.asarray, init(cfg, m, seed=s)) for s in seeds]
    r = _replica_of(m)

    def pick(*leaves):
        out = leaves[0].copy()
        for k in range(1, len(leaves)):
            out[r == k] = leaves[k][r == k]
        return out
    return jax.tree.map(pick, *trees)


class _Carving:
    """One carving's JAX tree, mesh, configs and the port's params, with
    engines built once per serving config."""

    def __init__(self, name, devices):
        (dp, pp, tp, ep), mcfg = CARVINGS[name]
        self.moe = mcfg is not None
        n = dp * pp * tp * ep
        if self.moe:
            self.jcfg, self.cfg = JMoELMConfig(**mcfg), MoELMConfig(**mcfg)
            self.m = jcompose.compose_parallelism(
                dp, pp, tp, 1, ep, num_experts=E, devices=devices[:n])
            self.tm = tcompose.compose_parallelism(
                dp, pp, tp, 1, ep, num_experts=E, device="cpu")
            self.scfg = dict(_SCFG, moe_experts=E, moe_top_k=2, moe_ep=ep)
        else:
            self.jcfg = jcompose.LMConfig(**_DENSE)
            self.cfg = tcompose.LMConfig(**_DENSE)
            self.m = jcompose.compose_parallelism(dp, pp, tp, 1,
                                                  devices=devices[:n])
            self.tm = tcompose.compose_parallelism(dp, pp, tp, 1,
                                                   device="cpu")
            self.scfg = dict(_SCFG)
        self.tree = _tree(self.jcfg, self.m, (3, 7), self.moe)
        self.params = self.load(self.tree)
        self._engines = {}

    def load(self, tree):
        if self.moe:
            return moe_params_from_jax(tree, self.cfg, m=self.tm)
        return tcompose.params_from_jax(tree, self.cfg, m=self.tm)

    def engines(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._engines:
            scfg = dict(self.scfg, **kw)
            self._engines[key] = (
                JServeEngine(self.m, self.jcfg, self.tree,
                             JServeConfig(**scfg)),
                ServeEngine(self.cfg, self.params, ServeConfig(**scfg),
                            device="cpu"))
        return self._engines[key]


@pytest.fixture(scope="module")
def carving(cpu_devices):
    built = {}

    def get(name):
        if name not in built:
            built[name] = _Carving(name, cpu_devices)
        return built[name]
    return get


def _drain(sched_cls, engine, prompts=PROMPTS, max_new=6):
    sched = sched_cls(engine)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.drain()
    if hasattr(sched, "close"):
        sched.close()
    assert all(r.state == "done" for r in reqs)
    return sched, reqs


def _streams(sched_cls, engine, prompts=PROMPTS):
    return [(r.replica, r.generated)
            for r in _drain(sched_cls, engine, prompts)[1]]


@pytest.mark.parametrize("name", list(CARVINGS))
def test_carved_tree_loads_every_replica(carving, name):
    """Every replica's rows and every peer's shard, bit for bit: layer
    ``s * Lps + i`` of replica r, tp peer t (and ep owner e) is device
    ``(((r * pp + s) * tp + t) * sp) * ep + e``'s block i."""
    c = carving(name)
    m, p = c.m, c.params
    idx = np.arange(m.size).reshape(m.dp, m.pp, m.tp, m.sp, m.ep)
    Lps = c.cfg.layers // m.pp
    names = [("blocks", "wqkv", "wqkv"), ("blocks", "wo", "wo")]
    names += ([("router", "wr", "wr"), ("experts", "w1", "w1e"),
               ("experts", "w2", "w2e")] if c.moe else
              [("blocks", "w1", "w1"), ("blocks", "w2", "w2")])
    for r in range(m.dp):
        dev0 = idx[r, 0, 0, 0, 0]
        np.testing.assert_array_equal(p.embed[r].numpy(),
                                      c.tree["shared"]["embed"][dev0])
        np.testing.assert_array_equal(p.head[r].numpy(),
                                      c.tree["shared"]["head"][dev0])
        for layer in range(c.cfg.layers):
            s, i = divmod(layer, Lps)
            for group, leaf, key in names:
                got = p.blocks[key][layer][r].numpy()
                src = c.tree[group][leaf]
                if key == "wr":
                    want = src[idx[r, s, 0, 0, 0]][i]
                elif key in ("w1e", "w2e"):
                    want = np.stack([np.stack([src[idx[r, s, t, 0, e]][i]
                                               for e in range(m.ep)])
                                     for t in range(m.tp)])
                else:
                    want = np.stack([src[idx[r, s, t, 0, 0]][i]
                                     for t in range(m.tp)])
                np.testing.assert_array_equal(got, want)
    if m.dp > 1:                          # replica 1 is its own draw
        assert not torch.equal(p.blocks["wqkv"][0][0],
                               p.blocks["wqkv"][0][1])
    other = tcompose.compose_parallelism(m.size, device="cpu",
                                         num_experts=E if c.moe else None)
    loader = moe_params_from_jax if c.moe else tcompose.params_from_jax
    with pytest.raises(ValueError, match="the carving dp"):
        loader(c.tree, c.cfg, m=other)


@pytest.mark.parametrize("name", list(CARVINGS))
def test_prefill_logits_match_jax(carving, name):
    """Per replica: the logits agree with JAX to 1e-4 and with the
    replica's joined module's cache-free forward to 1e-5."""
    c = carving(name)
    jeng, teng = c.engines()
    for r in range(c.m.dp):
        for slot, prompt in enumerate(PROMPTS[:2]):
            jtok, jlog = jeng.prefill(r, slot, prompt)
            ttok, tlog = teng.prefill(r, slot, prompt)
            np.testing.assert_allclose(tlog, np.asarray(jlog), atol=1e-4,
                                       rtol=0)
            assert ttok == jtok
        joined = c.params.replica(r)
        ref = joined(torch.tensor([PROMPTS[1]]))[0, -1].numpy()
        np.testing.assert_allclose(tlog, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match=r"out of range \[0, "):
        teng.prefill(c.m.dp, 0, PROMPTS[0])


@pytest.mark.parametrize("kv_dtype", ["raw", "int8"])
@pytest.mark.parametrize("name", list(CARVINGS))
def test_greedy_streams_identical_to_jax(carving, name, kv_dtype):
    """Every request's stream and the replica it was admitted to (prefix
    affinity, load, the MoE skew tiebreak) equal the JAX scheduler's."""
    c = carving(name)
    jeng, teng = c.engines(kv_dtype=kv_dtype)
    want = _streams(JScheduler, jeng)
    got = _streams(Scheduler, teng)
    assert got == want
    assert {r for r, _ in got} == set(range(c.m.dp))
    assert [len(g) for _, g in got] == [6] * len(PROMPTS)


@pytest.mark.parametrize("name", ["moe_dp2_ep2", "moe_pp2_tp2_ep2"])
def test_decode_tile_and_moe_load_match_jax(carving, name):
    """The decode tile ``decode_tile(ep * S * k, E / ep)``, and one
    decode call's per-replica load with live lanes on every replica and
    a padded one."""
    c = carving(name)
    jeng, teng = c.engines()
    assert teng._moe_tile == jeng._moe_tile
    R = c.m.dp
    out = []
    for eng in (jeng, teng):
        tok, trash, _ = eng.idle_lane()
        toks, slots, lens = (np.full((R, 2), v, np.int32)
                             for v in (tok, trash, 0))
        for r in range(R):
            for lane in range(2 - r):         # replica 1 pads one lane
                p = PROMPTS[2 * r + lane]
                toks[r, lane] = eng.prefill(r, lane, p)[0]
                slots[r, lane], lens[r, lane] = lane, len(p)
        gen = np.asarray(eng.decode(toks, slots, lens))
        out.append((gen, eng.moe_load()))
    (jgen, jload), (tgen, tload) = out
    np.testing.assert_array_equal(tgen, jgen)
    assert len(tload) == len(jload) == R
    for t, j in zip(tload, jload):
        np.testing.assert_array_equal(t["counts"], j["counts"])
        np.testing.assert_array_equal(t["fractions"], j["fractions"])
        assert t["tokens"] == j["tokens"] > 0
        assert abs(t["entropy"] - j["entropy"]) <= 1e-5


def test_spec_and_prefix_streams_match_jax(carving):
    """``spec_decode=2`` (a one-stage draft of the pp-2 carving) with
    prefix pages of 4 tokens: streams, prefix rows, and the drafted /
    accepted / hit counts equal JAX's, each replica with its own prefix
    directory and pages."""
    c = carving("dense_dp2_pp2_tp2")
    jeng, teng = c.engines(spec_decode=2, spec_stages=1, prefix_pages=2,
                           prefix_page_tokens=4)
    jsched, jreqs = _drain(JScheduler, jeng, FAST_PROMPTS)
    jcounts = [int(bfm.get_metric(n).total()) for n in _FAST_COUNTERS]
    t0 = {n: tbm.counter(n).total() for n in _FAST_COUNTERS}
    tsched, treqs = _drain(Scheduler, teng, FAST_PROMPTS)

    def view(reqs):
        return [(r.replica, r.prefix_row, r.prefix_len, r.generated)
                for r in reqs]
    assert view(treqs) == view(jreqs)
    tcounts = [tbm.counter(n).total() - t0[n] for n in _FAST_COUNTERS]
    assert tcounts == jcounts
    assert {r.replica for r in treqs if r.prefix_row >= 0} == {0, 1}
    for r in range(2):
        assert tsched._prefix[r].describe() == jsched._prefix[r].describe()


@pytest.mark.parametrize("name", ["dense_dp2_pp2_tp2", "moe_dp2_ep2"])
def test_update_params_rebinds(carving, name):
    """Both engines rebind a perturbed tree (every replica redrawn): the
    streams stay identical to each other and change; a tree of another
    shape is refused and the served weights stay."""
    c = carving(name)
    jeng, teng = c.engines()
    before = _streams(Scheduler, teng)
    cache = teng.cache["k"]
    fresh = _tree(c.jcfg, c.m, (11, 13), c.moe)
    try:
        jeng.update_params(fresh)
        teng.update_params(c.load(fresh))
        got = _streams(Scheduler, teng)
        assert got == _streams(JScheduler, jeng)
        assert got != before
        assert teng.cache["k"] is cache
        bad = c.load(fresh)
        bad.blocks["wo"][0] = bad.blocks["wo"][0][:, :, :-1]
        with pytest.raises(ValueError, match=r"update_params: wo\[0\]"):
            teng.update_params(bad)
        assert _streams(Scheduler, teng) == got
    finally:
        jeng.update_params(c.tree)
        teng.update_params(c.params)
    assert _streams(Scheduler, teng) == before


def test_refusals_match_jax(carving, cpu_devices):
    """An sp > 1 carving and a ``moe_ep`` knob that disagrees with the ep
    carve are refused with the JAX engine's texts."""
    cfg, jcfg = tcompose.LMConfig(**_DENSE), jcompose.LMConfig(**_DENSE)
    m = jcompose.compose_parallelism(1, 1, 2, 2, devices=cpu_devices[:4])
    tree = jax.tree.map(np.asarray, jcompose.init_lm_params(jcfg, m))
    with pytest.raises(ValueError) as jerr:
        JServeEngine(m, jcfg, tree, JServeConfig(**_SCFG))
    params = tcompose.params_from_jax(
        tree, cfg, m=tcompose.compose_parallelism(1, 1, 2, 2, device="cpu"))
    with pytest.raises(ValueError) as terr:
        ServeEngine(cfg, params, ServeConfig(**_SCFG), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "sp > 1" in str(terr.value)
    c = carving("moe_dp2_ep2")
    scfg = dict(c.scfg, moe_ep=1)
    with pytest.raises(ValueError) as jerr:
        JServeEngine(c.m, c.jcfg, c.tree, JServeConfig(**scfg))
    with pytest.raises(ValueError) as terr:
        ServeEngine(c.cfg, c.params, ServeConfig(**scfg), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "ServeConfig.moe_ep=1" in str(terr.value)
    with pytest.raises(ValueError, match="carved at pp=1"):
        ServeEngine(c.cfg, c.params, ServeConfig(**c.scfg), pp=2,
                    device="cpu")
