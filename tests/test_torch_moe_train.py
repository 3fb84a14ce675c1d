"""The port's MoE training (dropless top-k, ep = 1) against the JAX package.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py`` under
``shard_map``; the port holds the same peers stacked along dim 0, in the
JAX flat device order.  Inputs are made from a seed with numpy and
handed to both sides.

* K4's autograd function on the CPU (its plain backward, the kernels'
  formulas) against ``jax.vjp`` of ``grouped_ffn_pallas`` in interpret
  mode: out, dxt, dw1, dw2 at atol 1e-5, over tiles 1/3/8, hostile
  routing, empty experts, widths that are not a multiple of 8 and
  stacked-peer weights read through a layer slice;
* ``_router_stats``, ``moe_ffn_dropless`` and ``load_balancing_loss``,
  values and grads, against JAX for k = 1 and 2: atol 1e-5;
* ``validate(m)`` texts, ``capacity``, ``ec_capacity`` and ``describe``;
* ``init_moe_train_params`` and ``make_moe_batch`` bit for bit;
* the first-step loss and every peer's grads against the JAX
  ``make_moe_grad_fn`` at (dp, pp, tp, sp) in {(2,2,2,1), (2,1,2,2),
  (1,2,2,2)} with top-1 and top-2 (one case through JAX's Pallas K4 in
  interpret mode): losses rtol 1e-5, grads atol 1e-5; the carrier rows'
  cotangent reaches stage 0's routers (aux and z weights of 1 against
  0 move them, and JAX agrees);
* ``remat=True`` against ``remat=False``: atol 1e-6;
* a 3-step SGD trajectory through both ``make_train_step``s at
  (2,2,2,1): losses rtol 1e-5, params atol 1e-5;
* the property of ``tests/test_moe_dropless.py``'s float64 trajectory
  oracle for the port: the routed top-1 model trains loss for loss like
  its dense-equivalent twin (atol 1e-12 over 12 SGD steps);
* the probe's keys and values against JAX's; the refusal of a carving
  validated for other experts (bf16 training is held to JAX in
  ``tests/test_torch_moe_bf16.py``); an
  ``lm_bench --moe --dropless --device cpu`` smoke.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import bluefog_tpu.optimizers as jopt
from bluefog_tpu.moe import layers as jlayers
from bluefog_tpu.moe import model as jmoe
from bluefog_tpu.ops.pallas_moe import grouped_ffn_pallas
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.parallel import expert as jexpert
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.fusion import tree_flatten
from bluefog_tpu_torch.moe import layers as tlayers
from bluefog_tpu_torch.moe import model as tmoe
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.parallel import expert as texpert
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

CARVINGS = [(2, 2, 2, 1), (2, 1, 2, 2), (1, 2, 2, 2)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- K4 under autograd --------------------------------------------------

@pytest.mark.parametrize("case", ["tile1", "tile3", "tile8", "hostile",
                                  "empty_experts", "width_12_20", "peers"])
def test_grouped_ffn_backward_matches_jax_vjp(case):
    rng = np.random.default_rng(len(case))
    E, D, F, tile = 4, 16, 24, 3
    eid = np.sort(rng.integers(0, E, 6))
    if case in ("tile1", "tile8"):
        tile = int(case[4:])
    elif case == "hostile":                  # every tile on expert 2
        eid = np.full(7, 2)
    elif case == "empty_experts":            # experts 0 and 3 hold nothing
        eid = np.array([1, 1, 2, 1, 2])
    elif case == "width_12_20":
        D, F = 12, 20
    G = len(eid)
    xt = rng.normal(size=(G, tile, D)).astype(np.float32)
    xt[-1] = 0                               # a clamped tail tile
    w1 = (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(G, tile, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda x, a, b: grouped_ffn_pallas(
        x, jnp.asarray(eid, jnp.int32), a, b, interpret=True),
        *(jnp.asarray(a) for a in (xt, w1, w2)))
    want = (out,) + vjp(jnp.asarray(ct))
    x = _t(xt).requires_grad_()
    if case == "peers":                      # [2 peers, 2 layers, 2, ...]
        big1 = np.zeros((2, 2, 2, D, F), np.float32)
        big2 = np.zeros((2, 2, 2, F, D), np.float32)
        big1[:, 1], big2[:, 1] = w1.reshape(2, 2, D, F), \
            w2.reshape(2, 2, F, D)
        b1, b2 = _t(big1).requires_grad_(), _t(big2).requires_grad_()
        a, b = b1[:, 1], b2[:, 1]
    else:
        a, b = _t(w1).requires_grad_(), _t(w2).requires_grad_()
    got = gf.grouped_ffn(x, torch.tensor(eid, dtype=torch.int32), a, b)
    grads = torch.autograd.grad(got, (x, a, b), _t(ct))
    got = (got,) + tuple(g.reshape(w.shape) for g, w in
                         zip(grads, (xt, w1, w2)))
    for name, g, w in zip(("out", "dxt", "dw1", "dw2"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5, err_msg=name)
    if case == "empty_experts":
        assert not got[2][[0, 3]].any() and not got[3][[0, 3]].any()


# -- the layer: router statistics, the dropless sublayer, aux loss -------

@pytest.mark.parametrize("k", [1, 2])
def test_router_stats_and_dropless_sublayer_match_jax(cpu_devices, k):
    rng = np.random.default_rng(20 + k)
    T, D, F, E = 13, 16, 24, 4
    x = rng.normal(size=(T, D)).astype(np.float32)
    wr = rng.normal(size=(D, E)).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(T, D)).astype(np.float32)
    cs = rng.normal(size=(4 + E,)).astype(np.float32)

    def score(y, st, ctj, csj):
        return ((y * ctj).sum() + st["aux"] * csj[0] + st["z"] * csj[1]
                + st["entropy"] * csj[2] + st["dropped"] * csj[3]
                + (st["usage"] * csj[4:]).sum())

    mesh = Mesh(np.array(cpu_devices[:1]).reshape(1, 1), ("expert", "tp"))

    def f(xb, wrb, w1b, w2b):
        def loss(*a):
            y, st = jlayers.moe_ffn_dropless(*a, num_experts=E, top_k=k,
                                             tile=4)
            return score(y, st, jnp.asarray(ct), jnp.asarray(cs)), (y, st)
        (_, (y, st)), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                             has_aux=True)(
            xb, wrb, w1b, w2b)
        return y, st, g

    jy, jst, jg = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))(
        *(jnp.asarray(a) for a in (x, wr, w1, w2)))
    args = [_t(a).requires_grad_() for a in (x, wr, w1, w2)]
    y, st = tlayers.moe_ffn_dropless(*args, num_experts=E, top_k=k, tile=4)
    tg = torch.autograd.grad(score(y, st, _t(ct), _t(cs)), args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    for key in ("aux", "z", "dropped", "entropy", "usage"):
        np.testing.assert_allclose(st[key].detach().numpy(),
                                   np.asarray(jst[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert float(st["dropped"]) == 0.0
    for name, a, b in zip(("x", "wr", "w1", "w2"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=name)
    # _router_stats alone, on the stacked layout: two peers at once
    logits = rng.normal(size=(2, T, E)).astype(np.float32)
    idx = rng.integers(0, E, size=(2, T, k))
    keep = rng.random((2, k * T)) < 0.8

    def jstats(lg, i, kp):
        return jlayers._router_stats(lg, jax.nn.softmax(lg, -1), i, kp,
                                     num_experts=E, axis="expert")

    jst2 = jax.vmap(jax.vmap(jstats), axis_name="expert")(
        jnp.asarray(logits)[None], jnp.asarray(idx)[None],
        jnp.asarray(keep)[None])
    lt = _t(logits)
    tst2 = tlayers._router_stats(lt, torch.softmax(lt, -1), _t(idx),
                                 _t(keep), num_experts=E)
    for key, v in tst2.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jst2[key])[0],
                                   rtol=0, atol=1e-6, err_msg=key)


def test_load_balancing_loss_matches_jax():
    rng = np.random.default_rng(3)
    probs = jax.nn.softmax(jnp.asarray(rng.normal(size=(11, 5))), -1)
    idx = rng.integers(0, 5, 11)
    jv, jgr = jax.value_and_grad(jexpert.load_balancing_loss)(
        probs, jnp.asarray(idx))
    tp = _t(np.asarray(probs)).requires_grad_()
    tv = texpert.load_balancing_loss(tp, _t(idx))
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgr), atol=1e-7)


# -- the carving and the config ---------------------------------------------

def _cfg(mod, pp, sp, **kw):
    base = dict(vocab=64, d_model=32, heads=4, layers=2 * pp,
                seq_len=16, micro=2 * pp, batch=2, num_experts=4,
                top_k=2, dispatch="dropless", group_tile=4)
    base.update(kw)
    return mod.MoELMConfig(**base)


def _carve(cpu_devices, carving, **cfg_kw):
    dp, pp, tp, sp = carving
    n = dp * pp * tp * sp
    kw = dict(num_experts=4, capacity_factor=1.5)
    jm = jcompose.compose_parallelism(dp, pp, tp, sp, devices=cpu_devices[:n],
                                      **kw)
    tm = tcompose.compose_parallelism(dp, pp, tp, sp, device="cpu", **kw)
    return (_cfg(jmoe, pp, sp, **cfg_kw), _cfg(tmoe, pp, sp, **cfg_kw), jm,
            tm)


def test_config_rules_capacity_and_describe_match_jax(cpu_devices):
    jm = jcompose.compose_parallelism(2, 2, 2, 1, devices=cpu_devices,
                                      num_experts=4, capacity_factor=1.5)
    tm = tcompose.compose_parallelism(2, 2, 2, 1, device="cpu",
                                      num_experts=4, capacity_factor=1.5)
    assert tm.describe() == jm.describe()
    assert (tm.num_experts, tm.capacity_factor) == (4, 1.5)
    jsp = jcompose.compose_parallelism(1, 1, 2, 2, devices=cpu_devices[:4])
    tsp = tcompose.compose_parallelism(1, 1, 2, 2, device="cpu")
    for kw in ({}, dict(top_k=1, num_experts=8, d_model=64),
               dict(capacity_factor=2.0, seq_len=32)):
        for jmesh, tmesh in ((jm, tm), (jsp, tsp)):
            if "num_experts" in kw and jmesh is jm:
                continue
            j, t = _cfg(jmoe, 1, 1, **kw), _cfg(tmoe, 1, 1, **kw)
            assert (t.capacity(tmesh), t.ec_capacity(tmesh)) == \
                (j.capacity(jmesh), j.ec_capacity(jmesh))
    bad = [dict(layers=3), dict(top_k=3), dict(num_experts=0),
           dict(num_experts=8, d_model=64), dict(d_model=8, heads=2),
           dict(capacity_factor=0.0), dict(dispatch="sparse"),
           dict(router_mode="hash"), dict(group_tile=0),
           dict(router_mode="expert_choice", dispatch="capacity"),
           dict(router_mode="expert_choice", num_experts=1, top_k=2,
                seq_len=8, lag=2)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            _cfg(jmoe, 2, 1, **kw).validate(jm)
        with pytest.raises(ValueError) as terr:
            _cfg(tmoe, 2, 1, **kw).validate(tm)
        assert str(terr.value) == str(jerr.value), kw
    with pytest.raises(ValueError) as jerr:          # EC needs sp = 1
        _cfg(jmoe, 1, 2, router_mode="expert_choice").validate(jsp)
    with pytest.raises(ValueError) as terr:
        _cfg(tmoe, 1, 2, router_mode="expert_choice").validate(tsp)
    assert str(terr.value) == str(jerr.value)
    for kw in (dict(num_experts=0), dict(capacity_factor=-1.0)):
        with pytest.raises(ValueError) as jerr:
            jcompose.compose_parallelism(1, devices=cpu_devices[:1], **kw)
        with pytest.raises(ValueError) as terr:
            tcompose.compose_parallelism(1, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("carving", CARVINGS)
def test_init_and_batch_are_bit_identical(cpu_devices, carving):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
    jp = jmoe.init_moe_params(jcfg, jm, seed=3)
    tp = tmoe.init_moe_train_params(tcfg, tm, seed=3)
    assert sorted(tp) == sorted(jp)
    for group, leaves in jp.items():
        assert sorted(tp[group]) == sorted(leaves)
        for k, v in leaves.items():
            assert np.array_equal(tp[group][k].numpy(), np.asarray(v)), k
    for steps in (None, 2):
        assert np.array_equal(
            tmoe.make_moe_batch(tcfg, tm, seed=5, steps=steps).numpy(),
            np.asarray(jmoe.make_moe_batch(jcfg, jm, seed=5, steps=steps)))


# -- the gradient --------------------------------------------------------

def _jax_first_step(jcfg, jm, seed=0):
    grad_fn = jmoe.make_moe_grad_fn(jcfg, jm)

    def f(p, t):
        loss, g = grad_fn(jax.tree.map(lambda x: x[0], p), t[0])
        return loss[None], jax.tree.map(lambda x: x[None], g)

    fn = jax.jit(jax.shard_map(f, mesh=jm.mesh, in_specs=(jm.spec,) * 2,
                               out_specs=(jm.spec,) * 2, check_vma=False))
    loss, grads = fn(jcompose.device_put(jm, jmoe.init_moe_params(
        jcfg, jm, seed=seed)), jmoe.make_moe_batch(jcfg, jm, seed=seed))
    return np.asarray(loss), jax.tree.map(np.asarray, grads)


def _port_first_step(tcfg, tm, seed=0):
    return topt.stacked_grads(
        tmoe.make_moe_grad_fn(tcfg, tm),
        tmoe.init_moe_train_params(tcfg, tm, seed=seed),
        tmoe.make_moe_batch(tcfg, tm, seed=seed), tm.slice_size)


def _assert_grads(tgrads, jgrads, atol=1e-5):
    for group, leaves in jgrads.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tgrads[group][k].numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{group}/{k}")


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("carving", CARVINGS)
def test_first_step_matches_jax(cpu_devices, monkeypatch, carving, top_k):
    if carving == (2, 2, 2, 1) and top_k == 2:       # JAX through K4
        monkeypatch.setenv("BLUEFOG_MOE_GROUPED_IMPL", "pallas")
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving, top_k=top_k)
    jloss, jgrads = _jax_first_step(jcfg, jm)
    tloss, tgrads = _port_first_step(tcfg, tm)
    np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
    _assert_grads(tgrads, jgrads)


def test_carrier_reaches_every_stage(cpu_devices):
    """With the aux and z weights at 1 the routers of stage 0 (which sees
    the loss only through the pipeline) get the JAX gradient, and one
    that differs from the gradient at weight 0 by far more than the
    tolerance: the carrier's cotangent reaches them."""
    got = {}
    for alpha in (1.0, 0.0):
        jcfg, tcfg, jm, tm = _carve(cpu_devices, (1, 2, 2, 1),
                                    aux_alpha=alpha, z_alpha=alpha)
        tloss, tgrads = _port_first_step(tcfg, tm)
        if alpha:
            jloss, jgrads = _jax_first_step(jcfg, jm)
            np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
            _assert_grads(tgrads, jgrads)
        got[alpha] = tgrads["router"]["wr"][:tm.tp]   # stage 0's peers
    assert float((got[1.0] - got[0.0]).abs().max()) > 1e-2


def test_remat_gives_the_same_gradients(cpu_devices):
    """``remat=True`` recomputes each tick's stage forward in the backward
    (K4's forward included) and gives the same loss and grads."""
    _, tcfg, _, tm = _carve(cpu_devices, (2, 2, 2, 1))
    params = tmoe.init_moe_train_params(tcfg, tm)
    toks = tmoe.make_moe_batch(tcfg, tm)
    got = [topt.stacked_grads(tmoe.make_moe_grad_fn(tcfg, tm, remat=r),
                              params, toks, tm.slice_size)
           for r in (False, True)]
    np.testing.assert_allclose(got[1][0].numpy(), got[0][0].numpy(),
                               rtol=1e-6)
    for a, b in zip(tree_flatten(got[1][1])[0], tree_flatten(got[0][1])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_sgd_trajectory_matches_jax(cpu_devices):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 2, 2, 1))
    jstep, jstrat = jcompose.make_train_step(
        jm, jmoe.make_moe_grad_fn(jcfg, jm), optax.sgd(0.1))
    jparams = jmoe.init_moe_params(jcfg, jm)
    jstate = jopt.init_distributed(jstrat, jparams)
    jparams = jcompose.device_put(jm, jparams)
    jtoks = jmoe.make_moe_batch(jcfg, jm)
    tstep, tstrat = tcompose.make_train_step(
        tm, tmoe.make_moe_grad_fn(tcfg, tm), topt.sgd(0.1))
    tparams = tmoe.init_moe_train_params(tcfg, tm)
    tstate = topt.init_distributed(tstrat, tparams)
    ttoks = tmoe.make_moe_batch(tcfg, tm)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jtoks)
        tparams, tstate, tloss = tstep(tparams, tstate, ttoks)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                                   rtol=1e-5)
    _assert_grads(tparams, jax.tree.map(np.asarray, jparams))


def _f64_losses(dense_equiv):
    cfg = tmoe.MoELMConfig(layers=2, num_experts=4, top_k=1,
                           dispatch="dropless", group_tile=4)
    m = tcompose.compose_parallelism(2, 2, 1, 1, device="cpu",
                                     num_experts=4)
    grad_fn = tmoe.make_moe_grad_fn(cfg, m, dense_equiv=dense_equiv)
    params = tmoe.init_moe_train_params(cfg, m)
    params = {g: {k: v.double() for k, v in d.items()}
              for g, d in params.items()}
    batch = tmoe.make_moe_batch(cfg, m, steps=12)
    losses = []
    for s in range(12):
        loss, grads = topt.stacked_grads(grad_fn, params, batch[:, s],
                                         m.slice_size)
        params = {g: {k: v - 0.1 * grads[g][k] for k, v in d.items()}
                  for g, d in params.items()}
        losses.append(loss.tolist())
    assert all(x.dtype == torch.float64 for x in tree_flatten(params)[0])
    return np.array(losses)


def test_float64_routed_equals_dense_equivalent():
    """tests/test_moe_dropless.py's float64 oracle, for the port: the
    routed dropless top-1 model and its dense-equivalent twin (every
    expert on every token, selected by mask) train loss for loss over 12
    SGD steps at dp 2 x pp 2."""
    routed, dense = _f64_losses(False), _f64_losses(True)
    np.testing.assert_allclose(routed, dense, rtol=0, atol=1e-12)
    assert dense[-1].mean() < dense[0].mean()


def test_probe_matches_jax(cpu_devices):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 2, 2, 1))
    jprobe = jmoe.make_moe_probe(jcfg, jm)(
        jcompose.device_put(jm, jmoe.init_moe_params(jcfg, jm)),
        jmoe.make_moe_batch(jcfg, jm))
    tprobe = tmoe.make_moe_probe(tcfg, tm)(
        tmoe.init_moe_train_params(tcfg, tm), tmoe.make_moe_batch(tcfg, tm))
    assert sorted(tprobe) == sorted(jprobe)
    for key, v in jprobe.items():
        np.testing.assert_allclose(tprobe[key], v, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert tprobe["dropped_fraction"] == 0.0
    assert abs(sum(tprobe["usage"]) - 1.0) < 1e-6


def test_refusals(cpu_devices):
    _, tcfg, _, tm = _carve(cpu_devices, (2, 2, 2, 1))
    with pytest.raises(ValueError, match="carving was validated for "
                                         "num_experts=4"):
        tmoe.make_moe_grad_fn(_cfg(tmoe, 2, 1, num_experts=8, d_model=32),
                              tm)


def test_lm_bench_moe_smoke():
    from bluefog_tpu_torch.tools import lm_bench
    doc = lm_bench.main(["--device", "cpu", "--moe", "--dropless",
                         "--experts", "4", "--top-k", "2",
                         "--group-tile", "4", "--iters", "2"])
    assert doc["moe"]["dropped_fraction"] == 0.0
    assert doc["moe"]["dispatch"] == "dropless"
    assert doc["moe"]["n_active_params"] == doc["config"]["n_active_params"]
    assert doc["moe"]["dot_flops"] is None
    assert doc["moe"]["per_step_s_capacity"] is None
    assert doc["mfu"]["flops_source"] == "active"
    assert doc["mesh"]["num_experts"] == 4
    assert all(np.isfinite(doc["losses"]))
    json.dumps(doc)
    for argv, text in ((["--dropless"], "need --moe"),
                       (["--ep", "2"], "--ep > 1 needs --moe"),
                       (["--router", "expert_choice"], "need --moe")):
        with pytest.raises(SystemExit) as err:
            lm_bench.main(["--device", "cpu"] + argv)
        assert err.value.code == 2, (argv, text)
