"""The port's MoE building blocks against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the JAX function and the port's:

* ``dropless_rows``, ``decode_tile``, ``tile_layout`` and
  ``sort_by_expert`` agree exactly, on random sizes with empty groups,
  with the JAX error texts;
* the grouped expert FFN's plain version (what the port runs on CPU
  tensors; the kernel K4 runs on CUDA tensors) agrees with both JAX
  implementations, ``grouped_ffn_xla`` and the Pallas kernel in
  interpret mode, at tiles 1-16 with random and hostile (all tiles on one
  expert) routing, within rtol = atol = 2e-5 (the JAX test's own);
* ``moe_apply_dropless`` against the JAX function under a one-device
  ``shard_map`` with an ``expert`` axis: the identity roundtrip is bit
  exact, expert scaling follows the closed form, the real grouped FFN
  agrees within 1e-5, an out-of-range id raises with the same text;
* ``router_topk`` and ``moe_dropless_combine`` within 1e-6;
* ``MoELMConfig``'s rules and counts, and ``init_moe_params`` bit for bit.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.moe import dropless as jdl
from bluefog_tpu.moe import layers as jlayers
from bluefog_tpu.moe.model import MoELMConfig as JMoELMConfig
from bluefog_tpu.moe.model import init_moe_params as jinit_moe
from bluefog_tpu.ops.pallas_moe import grouped_ffn_pallas
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.parallel.expert import moe_apply_dropless as jdropless
from bluefog_tpu_torch.moe import dropless as tdl
from bluefog_tpu_torch.moe import layers as tlayers
from bluefog_tpu_torch.moe.model import (MoELMConfig, init_moe_params,
                                         moe_params_from_jax)
from bluefog_tpu_torch.parallel.expert import moe_apply_dropless

E = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# layout: rows, tiles, sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [1, 2, 3, 8])
def test_dropless_rows_and_decode_tile_match_jax(tile):
    for max_rows in (1, 5, 16, 1024):
        for groups in (1, 3, 8):
            assert tdl.dropless_rows(max_rows, groups, tile) == \
                jdl.dropless_rows(max_rows, groups, tile)
            assert tdl.decode_tile(max_rows, groups, cap=tile) == \
                jdl.decode_tile(max_rows, groups, cap=tile)


def test_invalid_tile_errors_match_jax():
    for args in ((4, 2, 0), (4, 2, -1), (4, 2, 2.0)):
        with pytest.raises(ValueError) as jerr:
            jdl.dropless_rows(*args)
        with pytest.raises(ValueError) as terr:
            tdl.dropless_rows(*args)
        assert str(terr.value) == str(jerr.value)
    for args in ((0, 2), (8, 0), (8, 2, 0)):
        with pytest.raises(ValueError) as jerr:
            jdl.decode_tile(*args)
        with pytest.raises(ValueError) as terr:
            tdl.decode_tile(*args)
        assert str(terr.value) == str(jerr.value)
        assert "moe_dropless_invalid_tile" in str(terr.value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tile_layout_and_sort_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_exp = int(rng.integers(1, 9))
    N = int(rng.integers(1, 40))
    # skewed ids so some groups come out empty
    idx = np.minimum(rng.geometric(0.5, size=N) - 1, n_exp - 1).astype(
        np.int32)
    order, sizes, rank = tdl.sort_by_expert(_t(idx), n_exp)
    jorder, jsizes, jrank = jdl.sort_by_expert(jnp.asarray(idx), n_exp)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    for tile in (1, 2, 4, 8):
        ps, eid = tdl.tile_layout(sizes, tile=tile, max_rows=N)
        jps, jeid = jdl.tile_layout(jsizes, tile=tile, max_rows=N)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(jps))
        np.testing.assert_array_equal(eid.numpy(), np.asarray(jeid))
        assert eid.dtype == torch.int32


# ---------------------------------------------------------------------------
# the grouped expert FFN (K4's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("routing", ["random", "hostile"])
def test_grouped_ffn_plain_matches_jax(tile, routing):
    rng = np.random.default_rng(tile)
    D, F, G = 16, 32, 5
    w1 = rng.normal(size=(E, D, F)).astype(np.float32)
    w2 = rng.normal(size=(E, F, D)).astype(np.float32)
    xt = rng.normal(size=(G, tile, D)).astype(np.float32)
    eid = (np.sort(rng.integers(0, E, size=G)) if routing == "random"
           else np.full(G, E - 1)).astype(np.int32)
    got = tdl.grouped_ffn(_t(xt), _t(eid), _t(w1), _t(w2)).numpy()
    args = (jnp.asarray(xt), jnp.asarray(eid), jnp.asarray(w1),
            jnp.asarray(w2))
    for want in (jdl.grouped_ffn_xla(*args),
                 grouped_ffn_pallas(*args, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    assert got.shape == (G, tile, D)


def test_grouped_ffn_impl_token_selects_nothing(monkeypatch):
    rng = np.random.default_rng(0)
    xt = _t(rng.normal(size=(2, 2, 8)).astype(np.float32))
    eid = torch.tensor([0, 1], dtype=torch.int32)
    w1 = _t(rng.normal(size=(2, 8, 16)).astype(np.float32))
    w2 = _t(rng.normal(size=(2, 16, 8)).astype(np.float32))
    want = tdl.grouped_ffn_xla(xt, eid, w1, w2)
    for impl in ("xla", "pallas"):
        assert torch.equal(tdl.grouped_ffn(xt, eid, w1, w2, impl=impl), want)
    with pytest.raises(ValueError) as jerr:
        jdl.grouped_ffn(jnp.asarray(xt.numpy()), jnp.asarray(eid.numpy()),
                        jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()),
                        impl="triton")
    with pytest.raises(ValueError) as terr:
        tdl.grouped_ffn(xt, eid, w1, w2, impl="triton")
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setenv("BLUEFOG_MOE_GROUPED_IMPL", "cuda")
    with pytest.raises(ValueError, match="moe_dropless_unknown_impl"):
        tdl.grouped_ffn(xt, eid, w1, w2)
    with pytest.raises(ValueError, match="tile_eid"):
        tdl.grouped_ffn(xt, eid[:1], w1, w2, impl="xla")


# ---------------------------------------------------------------------------
# dropless dispatch at an expert axis of size 1
# ---------------------------------------------------------------------------

def _jax_dropless(cpu_devices, x, idx, grouped_fn, params, tile):
    mesh = Mesh(np.array(cpu_devices[:1]), ("expert",))

    def f(xb, ib):
        return jdropless(xb[0], ib[0], grouped_fn, params, axis="expert",
                         num_experts=E, tile=tile)[None]

    fn = jax.jit(jax.shard_map(f, mesh=mesh,
                               in_specs=(P("expert"), P("expert")),
                               out_specs=P("expert")))
    return np.asarray(fn(jnp.asarray(x)[None], jnp.asarray(idx)[None]))[0]


@pytest.mark.parametrize("T,tile", [(1, 1), (6, 2), (16, 4), (33, 8)])
def test_moe_apply_dropless_identity_and_scaling(cpu_devices, T, tile):
    rng = np.random.default_rng(T)
    D = 8
    x = rng.normal(size=(T, D)).astype(np.float32)
    for idx in (rng.integers(0, E, size=T).astype(np.int32),
                np.zeros(T, np.int32)):                      # hostile
        ident = moe_apply_dropless(_t(x), _t(idx), lambda p, xt, e: xt,
                                   None, num_experts=E, tile=tile)
        assert torch.equal(ident, _t(x))
        np.testing.assert_array_equal(
            ident.numpy(),
            _jax_dropless(cpu_devices, x, idx, lambda p, xt, e: xt, None,
                          tile))
        scaled = moe_apply_dropless(
            _t(x), _t(idx), lambda p, xt, e: xt * (e + 1)[:, None, None],
            None, num_experts=E, tile=tile)
        np.testing.assert_allclose(scaled.numpy(),
                                   x * (idx + 1)[:, None], rtol=1e-6)


def test_moe_apply_dropless_grouped_ffn_matches_jax(cpu_devices):
    rng = np.random.default_rng(11)
    T, D, F = 12, 16, 32
    x = rng.normal(size=(T, D)).astype(np.float32)
    idx = rng.integers(0, E, size=T).astype(np.int32)
    w1 = rng.normal(size=(E, D, F)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(E, F, D)).astype(np.float32) * 0.3
    got = moe_apply_dropless(
        _t(x), _t(idx), lambda p, xt, e: tdl.grouped_ffn(xt, e, *p),
        (_t(w1), _t(w2)), num_experts=E, tile=4)
    want = _jax_dropless(
        cpu_devices, x, idx, lambda p, xt, e: jdl.grouped_ffn_xla(xt, e, *p),
        (jnp.asarray(w1), jnp.asarray(w2)), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_moe_apply_dropless_refusals_match_jax(cpu_devices):
    x = np.zeros((3, 4), np.float32)
    idx = np.array([0, 5, 1], np.int32)
    mesh = Mesh(np.array(cpu_devices[:1]), ("expert",))
    bad = jnp.asarray(idx)

    def f(xb):                  # ids closed over: the JAX check is eager
        return jdropless(xb[0], bad, lambda p, xt, e: xt,
                         None, axis="expert", num_experts=E, tile=2)[None]

    with pytest.raises(ValueError) as jerr:
        jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("expert"),),
                              out_specs=P("expert")))(jnp.asarray(x)[None])
    with pytest.raises(ValueError) as terr:
        moe_apply_dropless(_t(x), _t(idx), lambda p, xt, e: xt, None,
                           num_experts=E, tile=2)
    assert str(terr.value) == str(jerr.value)
    assert "moe_routing_expert_idx_out_of_range" in str(terr.value)
    with pytest.raises(ValueError, match="must be a positive int"):
        moe_apply_dropless(_t(x), _t(idx), None, None, num_experts=0)
    with pytest.raises(ValueError, match="not yet ported"):
        moe_apply_dropless(_t(x), _t(idx), None, None, num_experts=E,
                           axis_size=2)


# ---------------------------------------------------------------------------
# router and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_router_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(9, 16)).astype(np.float32)
    wr = rng.normal(size=(16, E)).astype(np.float32)
    wr[:, 3] = wr[:, 1]               # exact ties: the lower index first
    got = tlayers.router_topk(_t(x), _t(wr), top_k=k)
    want = jlayers.router_topk(jnp.asarray(x), jnp.asarray(wr), top_k=k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    with pytest.raises(ValueError, match="top_k must be 1 or 2"):
        tlayers.router_topk(_t(x), _t(wr), top_k=3)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_dropless_combine_matches_jax(cpu_devices, k):
    rng = np.random.default_rng(10 + k)
    T, D, F = 7, 16, 24
    x = rng.normal(size=(T, D)).astype(np.float32)
    wr = rng.normal(size=(D, E)).astype(np.float32)
    w1 = rng.normal(size=(E, D, F)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(E, F, D)).astype(np.float32) * 0.3
    _, _, idx, gate = tlayers.router_topk(_t(x), _t(wr), top_k=k)
    got = tlayers.moe_dropless_combine(_t(x), idx, gate, _t(w1), _t(w2),
                                       num_experts=E, tile=2)
    mesh = Mesh(np.array(cpu_devices[:1]).reshape(1, 1), ("expert", "tp"))

    def f(xb, wrb, w1b, w2b):
        _, _, jidx, jgate = jlayers.router_topk(xb, wrb, top_k=k)
        return jlayers.moe_dropless_combine(xb, jidx, jgate, w1b, w2b,
                                            num_experts=E, tile=2)

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(), out_specs=P(),
                               check_vma=False))
    want = fn(*(jnp.asarray(a) for a in (x, wr, w1, w2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# MoELMConfig and the weights
# ---------------------------------------------------------------------------

_CFG = dict(vocab=64, d_model=32, heads=4, layers=2, num_experts=E,
            top_k=2, dispatch="dropless", group_tile=4)


def _jmesh(cpu_devices):
    return jcompose.compose_parallelism(1, 1, 1, 1, 1, num_experts=E,
                                        devices=cpu_devices[:1])


def test_moe_config_rules_match_jax(cpu_devices):
    # a carving that pins no expert count: the rules are the config's own
    m = jcompose.compose_parallelism(1, devices=cpu_devices[:1])
    bad = [dict(top_k=3), dict(num_experts=0), dict(d_model=8, heads=2),
           dict(capacity_factor=0.0), dict(dispatch="sparse"),
           dict(router_mode="hash"), dict(group_tile=0),
           dict(router_mode="expert_choice", dispatch="capacity"),
           dict(router_mode="expert_choice", num_experts=1, top_k=2,
                d_model=32, seq_len=8, lag=2),
           dict(d_model=30)]
    for kw in bad:
        cfg = {**_CFG, **kw}
        with pytest.raises(ValueError) as jerr:
            JMoELMConfig(**cfg).validate(m)
        with pytest.raises(ValueError) as terr:
            MoELMConfig(**cfg).validate()
        assert str(terr.value) == str(jerr.value), kw


def test_moe_config_counts_and_env_match_jax(cpu_devices, monkeypatch):
    m = _jmesh(cpu_devices)
    for kw in (_CFG, dict(_CFG, top_k=1, num_experts=8, ffn_mult=2),
               dict(_CFG, router_mode="expert_choice")):
        j, t = JMoELMConfig(**kw), MoELMConfig(**kw)
        t.validate()
        assert (t.n_params, t.n_active_params, t.flops_per_token(),
                t.ec_capacity()) == \
            (j.n_params, j.n_active_params, j.flops_per_token(),
             j.ec_capacity(m))
        assert asdict(t.dense_twin()) == asdict(j.dense_twin())
    monkeypatch.setenv("BLUEFOG_MOE_EXPERTS", "6")
    monkeypatch.setenv("BLUEFOG_MOE_TOPK", "2")
    monkeypatch.setenv("BLUEFOG_MOE_DISPATCH", "dropless")
    monkeypatch.setenv("BLUEFOG_MOE_TILE", "2")
    assert asdict(MoELMConfig.from_env(layers=3)) == \
        asdict(JMoELMConfig.from_env(layers=3))
    monkeypatch.setenv("BLUEFOG_MOE_TOPK", "two")
    with pytest.raises(ValueError) as jerr:
        JMoELMConfig.from_env()
    with pytest.raises(ValueError) as terr:
        MoELMConfig.from_env()
    assert str(terr.value) == str(jerr.value)


def test_init_moe_params_bit_identical_and_from_jax(cpu_devices):
    m = _jmesh(cpu_devices)
    tree = jinit_moe(JMoELMConfig(**_CFG), m, seed=3)
    cfg = MoELMConfig(**_CFG)
    model = init_moe_params(cfg, 3, device="cpu")
    loaded = moe_params_from_jax(tree, cfg, device="cpu")
    jblocks = {"wqkv": tree["blocks"]["wqkv"], "wo": tree["blocks"]["wo"],
               "wr": tree["router"]["wr"], "w1e": tree["experts"]["w1"],
               "w2e": tree["experts"]["w2"]}
    for mod in (model, loaded):
        np.testing.assert_array_equal(
            mod.embed.numpy(), np.asarray(tree["shared"]["embed"])[0])
        np.testing.assert_array_equal(
            mod.head.numpy(), np.asarray(tree["shared"]["head"])[0])
        for name, leaf in jblocks.items():
            want = np.asarray(leaf)[0]
            for i, blk in enumerate(mod.blocks):
                np.testing.assert_array_equal(getattr(blk, name).numpy(),
                                              want[i])
    with pytest.raises(ValueError, match="pp = tp = ep = 1"):
        moe_params_from_jax(tree, MoELMConfig(**dict(_CFG, num_experts=2)),
                            device="cpu")
