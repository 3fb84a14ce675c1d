"""The port's expert parallelism (ep > 1), capacity dispatch and
expert-choice routing against the JAX package.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py`` under
``shard_map`` (``check_vma=False`` where it differentiates); the port
holds the same peers stacked along dim 0, in the JAX flat device order
(ep innermost), and runs its kernels' plain versions.  Inputs are made
from a seed with numpy and handed to both sides.

* ``compose_parallelism``'s ep rules, ``MoELMConfig.validate`` at ep and
  the ``dense_equiv`` refusal: the JAX texts;
* ``init_moe_train_params`` and ``make_moe_batch`` bit for bit at (dp,
  pp, tp, sp, ep) in (2,1,1,1,2), (1,2,1,1,2), (1,1,2,1,2), (1,1,1,2,2),
  (2,2,1,1,2);
* ``moe_apply_dropless`` over 2 and 4 stacked peers: the identity round
  trip bit for bit, every row home through its own expert in token order
  (nothing dropped, all rows on one expert too), out-of-range ids refused
  with the JAX text, and the grouped FFN against the JAX ``shard_map`` at
  rtol 1e-6 (atol 1e-6: f32 sums of O(1) terms, summed in another
  order);
* ``moe_dispatch`` / ``moe_combine`` / ``moe_apply`` / ``moe_apply_topk``
  (fused and not) at ep 1 and 2, with a capacity that drops rows, and
  ``_routing``'s two named guards: atol 1e-6 and the JAX texts;
* ``router_expert_choice``, ``moe_ffn_expert_choice`` and
  ``moe_ffn_routed`` at ep 1 and 2: values atol 1e-6, stats rtol 1e-6;
  the expert-choice refusals;
* the first step (loss rtol 1e-5, every peer's grads atol 1e-5) at
  (2,1,1,1,2) and (1,2,2,1,2) for dropless top-1 and top-2, capacity
  dispatch and expert choice, and the dense LM at ep 2;
* float64 trajectories in process, 12 SGD steps at lr 0.1 on dp 2 x pp
  2: the port at ep 1 and at ep 2 equals its dense-equivalent twin, to
  1e-12 (dropless top-1, expert choice) and 1e-9 (capacity), and learns;
* the probe at ep 2 against JAX's; ``moe_params_from_jax`` of an ep-2
  tree; ``lm_bench`` smokes (``--ep 2``, capacity, expert choice);
* trash tiles (id -1): the plain K4 forward and backward give zeros
  there and the unmarked layout's values everywhere else.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu.moe import layers as jlayers
from bluefog_tpu.moe import model as jmoe
from bluefog_tpu.moe.dropless import grouped_ffn_xla
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.parallel import expert as jexpert
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.moe import dropless as tdl
from bluefog_tpu_torch.moe import layers as tlayers
from bluefog_tpu_torch.moe import model as tmoe
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.parallel import expert as texpert
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

CARVINGS = [(2, 1, 1, 1, 2), (1, 2, 1, 1, 2), (1, 1, 2, 1, 2),
            (1, 1, 1, 2, 2), (2, 2, 1, 1, 2)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfg(mod, pp, **kw):
    base = dict(vocab=64, d_model=32, heads=4, layers=2 * pp, seq_len=16,
                micro=2 * pp, batch=4, num_experts=4, top_k=2,
                dispatch="dropless", group_tile=4)
    base.update(kw)
    return mod.MoELMConfig(**base)


def _carve(cpu_devices, carving, **cfg_kw):
    dp, pp, tp, sp, ep = carving
    n = dp * pp * tp * sp * ep
    jm = jcompose.compose_parallelism(dp, pp, tp, sp, ep, num_experts=4,
                                      devices=cpu_devices[:n])
    tm = tcompose.compose_parallelism(dp, pp, tp, sp, ep, num_experts=4,
                                      device="cpu")
    return _cfg(jmoe, pp, **cfg_kw), _cfg(tmoe, pp, **cfg_kw), jm, tm


def _same_error(jfn, tfn, exc=ValueError):
    with pytest.raises(exc) as jerr:
        jfn()
    with pytest.raises(exc) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


# -- the carving and the config ---------------------------------------------

def test_compose_ep_rules_and_config_match_jax(cpu_devices):
    for kw in (dict(ep=2), dict(ep=2, num_experts=3), dict(ep=0),
               dict(ep=2, num_experts=0)):
        _same_error(lambda: jcompose.compose_parallelism(
            2, devices=cpu_devices[:4], **kw),
            lambda: tcompose.compose_parallelism(2, device="cpu", **kw))
    for carving in ((2, 1, 1, 1, 2), (1, 2, 1, 1, 4)):
        jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
        assert tm.describe() == jm.describe()
        assert (tm.size, tm.slice_size, tm.ep) == (jm.size, jm.slice_size,
                                                   jm.ep)
        assert tcfg.capacity(tm) == jcfg.capacity(jm)
        assert tcfg.ec_capacity(tm) == jcfg.ec_capacity(jm)
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 1, 1, 1, 2))
    for kw in (dict(batch=3), dict(num_experts=8, d_model=32),
               dict(router_mode="expert_choice", dispatch="capacity")):
        _same_error(lambda: _cfg(jmoe, 1, **kw).validate(jm),
                    lambda: _cfg(tmoe, 1, **kw).validate(tm))
    _, _, jsp, tsp = _carve(cpu_devices, (1, 1, 1, 2, 2))
    text = _same_error(
        lambda: _cfg(jmoe, 1, router_mode="expert_choice").validate(jsp),
        lambda: _cfg(tmoe, 1, router_mode="expert_choice").validate(tsp))
    assert "sp=1" in text
    text = _same_error(
        lambda: jmoe.init_moe_params(jcfg, jm, dense_equiv=True),
        lambda: tmoe.init_moe_train_params(tcfg, tm, dense_equiv=True))
    assert "dense_equiv keeps every expert local" in text
    with pytest.raises(ValueError, match="carve ep=1, not ep=2"):
        tmoe.make_moe_grad_fn(tcfg, tm, dense_equiv=True)


@pytest.mark.parametrize("carving", CARVINGS)
def test_init_and_batch_are_bit_identical_at_ep(cpu_devices, carving):
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


# -- dropless dispatch over stacked expert peers -----------------------------

def _jax_dropless(cpu_devices, x, idx, grouped_fn, params, E, tile):
    n = x.shape[0]
    mesh = Mesh(np.array(cpu_devices[:n]), ("expert",))

    def f(xb, ib, pb):
        p = jax.tree.map(lambda v: v[0], pb)
        return jexpert.moe_apply_dropless(
            xb[0], ib[0], grouped_fn, p, axis="expert", num_experts=E,
            tile=tile)[None]

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("expert"),
                               out_specs=P("expert")))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(idx), params))


@pytest.mark.parametrize("n", [2, 4])
def test_dropless_over_expert_peers_matches_jax(cpu_devices, n):
    rng = np.random.default_rng(n)
    T, D, F, E, tile = 12, 8, 16, 8, 4
    x = rng.normal(size=(n, T, D)).astype(np.float32)
    routings = (rng.integers(0, E, size=(n, T)), np.zeros((n, T), int),
                np.full((n, T), E - 1))
    for idx in routings:
        ti = torch.tensor(idx, dtype=torch.int32)
        same = texpert.moe_apply_dropless(
            _t(x), ti, lambda p, xt, e: xt, None, axis_size=n,
            num_experts=E, tile=tile)
        assert torch.equal(same, _t(x))              # bit for bit
        # each row through its own expert (scale by id + 1), home in
        # token order: the folded ids are the global expert ids
        got = texpert.moe_apply_dropless(
            _t(x), ti, lambda p, xt, e: xt * (e + 1).to(xt.dtype)[:, None,
                                                                  None],
            None, axis_size=n, num_experts=E, tile=tile)
        assert torch.equal(got, _t(x) * (ti + 1).to(torch.float32)[..., None])
    idx = routings[0]
    w1 = (rng.normal(size=(n, E // n, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(n, E // n, F, D)) * 0.3).astype(np.float32)
    want = _jax_dropless(cpu_devices, x, idx,
                         lambda p, xt, e: grouped_ffn_xla(xt, e, *p),
                         (jnp.asarray(w1), jnp.asarray(w2)), E, tile)
    got = texpert.moe_apply_dropless(
        _t(x), torch.tensor(idx, dtype=torch.int32),
        lambda p, xt, e: tdl.grouped_ffn(xt, e, *p), (_t(w1), _t(w2)),
        axis_size=n, num_experts=E, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    bad = np.array([0] * (T - 1) + [E], np.int32)   # one id past the end

    def jbad():
        mesh = Mesh(np.array(cpu_devices[:n]), ("expert",))
        ids = jnp.asarray(bad)

        def f(xb):          # ids closed over: the JAX check is eager
            return jexpert.moe_apply_dropless(
                xb[0], ids, lambda p, xt, e: xt, None,
                axis="expert", num_experts=E, tile=tile)[None]
        jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("expert"),
                              out_specs=P("expert")))(jnp.asarray(x))

    text = _same_error(jbad, lambda: texpert.moe_apply_dropless(
        _t(x), _t(np.stack([bad] * n)), lambda p, xt, e: xt, None,
        axis_size=n, num_experts=E, tile=tile))
    assert "moe_routing_expert_idx_out_of_range" in text


# -- capacity dispatch -------------------------------------------------------

def _shard(cpu_devices, n, f, *args, axes=("expert",)):
    shape = (n,) + (1,) * (len(axes) - 1)
    mesh = Mesh(np.array(cpu_devices[:n]).reshape(shape), axes)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(axes[0]),
                               out_specs=P(axes[0]), check_vma=False))
    return jax.tree.map(np.asarray, fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("capacity", [2, 9])
def test_capacity_functions_match_jax(cpu_devices, n, capacity):
    rng = np.random.default_rng(10 * n + capacity)
    T, D, E, k = 10, 8, 4, 2
    x = rng.normal(size=(n, T, D)).astype(np.float32)
    idx = rng.integers(0, E, size=(n, T)).astype(np.int32)
    topk = np.stack([rng.permutation(E)[:k] for _ in range(n * T)]
                    ).reshape(n, T, k).astype(np.int32)
    gate = rng.random((n, T, k)).astype(np.float32)
    w = (rng.normal(size=(n, D, D)) * 0.5).astype(np.float32)

    def jfn(p, t):
        return jax.nn.gelu(t @ p)

    def tfn(p, t):
        return torch.nn.functional.gelu(t @ p, approximate="tanh")

    def f(xb, ib, kb, gb, wb):
        kw = dict(capacity=capacity, axis="expert", num_experts=E)
        d, pos, keep = jexpert.moe_dispatch(xb[0], ib[0], **kw)
        back = jexpert.moe_combine(d, ib[0], pos, keep, **kw)
        app = jexpert.moe_apply(xb[0], ib[0], jfn, wb[0], **kw)
        fused = jexpert.moe_apply_topk(xb[0], kb[0], gb[0], jfn, wb[0],
                                       **kw)
        unfused = jexpert.moe_apply_topk(xb[0], kb[0], gb[0], jfn, wb[0],
                                         fused=False, **kw)
        return tuple(v[None] for v in (d, pos, keep, back, app, fused,
                                       unfused))

    want = _shard(cpu_devices, n, f, x, idx, topk, gate, w)
    one = n == 1
    xs, ids, ks, gs, ws = (_t(a[0] if one else a) for a in
                           (x, idx, topk, gate, w))
    kw = dict(capacity=capacity, axis_size=n, num_experts=E)
    d, pos, keep = texpert.moe_dispatch(xs, ids, **kw)
    got = (d, pos, keep, texpert.moe_combine(d, ids, pos, keep, **kw),
           texpert.moe_apply(xs, ids, tfn, ws, **kw),
           texpert.moe_apply_topk(xs, ks, gs, tfn, ws, **kw),
           texpert.moe_apply_topk(xs, ks, gs, tfn, ws, fused=False, **kw))
    names = ("expert_in", "pos", "keep", "combine", "apply", "topk_fused",
             "topk_unfused")
    for name, g, wv in zip(names, got, want):
        wv = wv[0] if one else wv
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   wv.astype(np.float64), rtol=0,
                                   atol=1e-6, err_msg=name)
    if capacity == 2:
        assert not bool(keep.all())              # this capacity drops rows


def test_capacity_routing_guards_match_jax():
    idx = np.array([0, 3, 1, 4], np.int32)
    for cap, ids in ((0, idx % 4), (2.5, idx % 4), (2, idx)):
        text = _same_error(lambda: jexpert._routing(ids, 4, cap),
                           lambda: texpert._routing(_t(ids), 4, cap))
        assert text.startswith("moe_routing_invalid_capacity" if cap != 2
                               else "moe_routing_expert_idx_out_of_range")


# -- the sublayers at ep: capacity and expert choice ----------------------

def _sublayer_case(rng, n, B, T, D, F, E):
    x = rng.normal(size=(n, B, T, D)).astype(np.float32)
    wr = np.broadcast_to(rng.normal(size=(D, E)).astype(np.float32),
                         (n, D, E)).copy()
    w1 = (rng.normal(size=(n, E // n, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(n, E // n, F, D)) * 0.3).astype(np.float32)
    return x, wr, w1, w2


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", ["capacity", "expert_choice"])
def test_routed_and_expert_choice_sublayers_match_jax(cpu_devices, n, mode):
    rng = np.random.default_rng(n + len(mode))
    B, T, D, F, E, k, C = 2, 8, 16, 24, 4, 2, 3
    x, wr, w1, w2 = _sublayer_case(rng, n, B, T, D, F, E)

    def f(xb, wrb, w1b, w2b):
        if mode == "capacity":
            y, st = jlayers.moe_ffn_routed(
                xb[0].reshape(B * T, D), wrb[0], w1b[0], w2b[0],
                num_experts=E, top_k=k, capacity=C)
        else:
            y, st = jlayers.moe_ffn_expert_choice(
                xb[0], wrb[0], w1b[0], w2b[0], num_experts=E, capacity=C)
        return y[None], jax.tree.map(lambda v: v[None], st)

    jy, jst = _shard(cpu_devices, n, f, x, wr, w1, w2,
                     axes=("expert", "tp"))
    args = [_t(a) for a in (x, wr, w1, w2)]
    ep = {} if n == 1 else {"ep_dim": 0}
    if n == 1:
        args = [a[0] for a in args]
    if mode == "capacity":
        xs = args[0].reshape(args[0].shape[:-3] + (B * T, D))
        y, st = tlayers.moe_ffn_routed(xs, *args[1:], num_experts=E,
                                       top_k=k, capacity=C, **ep)
    else:
        y, st = tlayers.moe_ffn_expert_choice(*args, num_experts=E,
                                              capacity=C, **ep)
    np.testing.assert_allclose(y.reshape(jy.shape).numpy(), jy, rtol=0,
                               atol=1e-6)
    for key, v in jst.items():             # z ~ 50: f32 sums, rtol 1e-6
        g = st[key].numpy().reshape(v.shape)
        np.testing.assert_allclose(g, v, rtol=1e-6, atol=1e-6, err_msg=key)
    if mode == "capacity":
        assert float(st["dropped"].max()) > 0      # C 3 drops rows here


def test_expert_choice_router_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    wr = rng.normal(size=(16, 4)).astype(np.float32)
    want = jlayers.router_expert_choice(jnp.asarray(x), jnp.asarray(wr),
                                        capacity=5)
    got = tlayers.router_expert_choice(_t(x), _t(wr), capacity=5)
    for name, g, w in zip(("logits", "probs", "sel", "gate"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=name)
    for xs, cap in ((x[0], 2), (x, 0), (x, 10)):
        _same_error(lambda: jlayers.router_expert_choice(
            jnp.asarray(xs), jnp.asarray(wr), capacity=cap),
            lambda: tlayers.router_expert_choice(_t(xs), _t(wr),
                                                 capacity=cap))


# -- the trainer: first step, trajectories, probe ----------------------------

MODES = {"dropless_top1": dict(top_k=1), "dropless_top2": {},
         "capacity": dict(dispatch="capacity"),
         "expert_choice": dict(router_mode="expert_choice")}


def _jax_first_step(grad_fn, jm, params, toks):
    def f(p, t):
        loss, g = grad_fn(jax.tree.map(lambda x: x[0], p), t[0])
        return loss[None], jax.tree.map(lambda x: x[None], g)

    fn = jax.jit(jax.shard_map(f, mesh=jm.mesh, in_specs=(jm.spec,) * 2,
                               out_specs=(jm.spec,) * 2, check_vma=False))
    loss, grads = fn(jcompose.device_put(jm, params), toks)
    return np.asarray(loss), jax.tree.map(np.asarray, grads)


def _assert_step(tloss, tgrads, jloss, jgrads):
    np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
    for group, leaves in jgrads.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tgrads[group][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=f"{group}/{k}")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("carving", [(2, 1, 1, 1, 2), (1, 2, 2, 1, 2)])
def test_first_step_at_ep2_matches_jax(cpu_devices, carving, mode):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving, **MODES[mode])
    jloss, jgrads = _jax_first_step(
        jmoe.make_moe_grad_fn(jcfg, jm), jm, jmoe.init_moe_params(jcfg, jm),
        jmoe.make_moe_batch(jcfg, jm))
    tloss, tgrads = topt.stacked_grads(
        tmoe.make_moe_grad_fn(tcfg, tm), tmoe.init_moe_train_params(tcfg, tm),
        tmoe.make_moe_batch(tcfg, tm), tm.slice_size)
    _assert_step(tloss, tgrads, jloss, jgrads)
    # the non-expert gradients are equal on every ep peer of a replica
    for group in ("blocks", "router", "shared"):
        for g in tgrads[group].values():
            v = g.view((-1, tm.ep) + tuple(g.shape[1:]))
            assert torch.equal(v, v[:, :1].expand_as(v)), group


def test_dense_lm_at_ep2_matches_jax(cpu_devices):
    """The dense LM on a carving with an expert axis: each ep peer a copy
    of the replica (the JAX dense recipe), same loss and grads."""
    jm = jcompose.compose_parallelism(2, 1, 2, 1, 2, num_experts=4,
                                      devices=cpu_devices)
    tm = tcompose.compose_parallelism(2, 1, 2, 1, 2, num_experts=4,
                                      device="cpu")
    kw = dict(vocab=64, d_model=32, heads=4, layers=2, seq_len=16, micro=2,
              batch=2)
    jcfg, tcfg = jcompose.LMConfig(**kw), tcompose.LMConfig(**kw)
    jloss, jgrads = _jax_first_step(
        jcompose.make_lm_grad_fn(jcfg, jm), jm,
        jcompose.init_lm_params(jcfg, jm), jcompose.make_lm_batch(jcfg, jm))
    tloss, tgrads = topt.stacked_grads(
        tcompose.make_lm_grad_fn(tcfg, tm),
        tcompose.init_lm_train_params(tcfg, tm),
        tcompose.make_lm_batch(tcfg, tm), tm.slice_size)
    _assert_step(tloss, tgrads, jloss, jgrads)


def _f64_losses(ep, dense_equiv, **kw):
    cfg = tmoe.MoELMConfig(layers=2, num_experts=4, top_k=1, **kw)
    m = tcompose.compose_parallelism(2, 2, 1, 1, ep, device="cpu",
                                     num_experts=4)
    grad_fn = tmoe.make_moe_grad_fn(cfg, m, dense_equiv=dense_equiv)
    params = tmoe.init_moe_train_params(cfg, m, dense_equiv=dense_equiv)
    params = {g: {k: v.double() for k, v in d.items()}
              for g, d in params.items()}
    batch = tmoe.make_moe_batch(cfg, m, steps=12)
    losses = []
    for s in range(12):
        loss, grads = topt.stacked_grads(grad_fn, params, batch[:, s],
                                         m.slice_size)
        params = {g: {k: v - 0.1 * grads[g][k] for k, v in d.items()}
                  for g, d in params.items()}
        losses.append(loss.view(m.dp, -1)[:, 0].tolist())  # each replica
    return np.array(losses)


@pytest.mark.parametrize("mode,atol", [
    ("dropless", 1e-12), ("expert_choice", 1e-12), ("capacity", 1e-9)])
def test_float64_trajectories_equal_the_dense_twin(mode, atol):
    """The float64 oracles of tests/test_moe_dropless.py and
    tests/test_moe.py, in process: the routed model at ep 1 and ep 2
    trains loss for loss like its dense-equivalent twin (ample capacity,
    factor 8, so capacity dispatch drops nothing)."""
    kw = {"dropless": dict(dispatch="dropless"),
          "expert_choice": dict(dispatch="dropless",
                                router_mode="expert_choice"),
          "capacity": dict(capacity_factor=8.0)}[mode]
    dense = _f64_losses(1, True, **kw)
    for ep in (1, 2):
        np.testing.assert_allclose(_f64_losses(ep, False, **kw), dense,
                                   rtol=0, atol=atol, err_msg=f"ep {ep}")
    assert (dense[-1] < dense[0]).all()


@pytest.mark.parametrize("mode", ["capacity", "expert_choice"])
def test_probe_at_ep2_matches_jax(cpu_devices, mode):
    kw = dict(top_k=1, capacity_factor=2.0) if mode == "capacity" \
        else MODES["expert_choice"]
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 2, 1, 1, 2), **kw)
    jprobe = jmoe.make_moe_probe(jcfg, jm)(
        jcompose.device_put(jm, jmoe.init_moe_params(jcfg, jm)),
        jmoe.make_moe_batch(jcfg, jm))
    tprobe = tmoe.make_moe_probe(tcfg, tm)(
        tmoe.init_moe_train_params(tcfg, tm), tmoe.make_moe_batch(tcfg, tm))
    assert sorted(tprobe) == sorted(jprobe)
    for key, v in jprobe.items():
        np.testing.assert_allclose(tprobe[key], v, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert abs(sum(tprobe["usage"]) - 1.0) < 1e-6
    if mode == "expert_choice":
        assert tprobe["usage"] == [0.25] * 4 and tprobe["aux_loss"] == 0.0
        assert 0.0 < tprobe["ec_coverage"] <= 1.0


def test_moe_params_from_jax_joins_an_ep2_tree(cpu_devices):
    cfg = _cfg(jmoe, 1)
    trees = [jmoe.init_moe_params(cfg, jcompose.compose_parallelism(
        1, 1, 1, 1, ep, num_experts=4, devices=cpu_devices[:ep]), seed=7)
        for ep in (1, 2)]
    assert np.asarray(trees[1]["experts"]["w1"]).shape[2] == 2
    tcfg = _cfg(tmoe, 1)
    models = [tmoe.moe_params_from_jax(t, tcfg, device="cpu")
              for t in trees]
    for (name, a), (_, b) in zip(models[0].named_parameters(),
                                 models[1].named_parameters()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="pp = tp = 1 carving"):
        tmoe.moe_params_from_jax(
            {**trees[1], "experts": {"w1": np.zeros((2, 2, 3, 32, 128))}},
            tcfg, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--dropless", "--ep", "2"], ["--ep", "2"],
    ["--dropless", "--router", "expert_choice", "--ep", "2"]])
def test_lm_bench_ep_capacity_and_expert_choice_smoke(argv):
    from bluefog_tpu_torch.tools import lm_bench
    doc = lm_bench.main(["--device", "cpu", "--moe", "--experts", "4",
                         "--top-k", "2", "--group-tile", "4", "--pp", "1",
                         "--tp", "1", "--iters", "2"] + argv)
    moe = doc["moe"]
    assert doc["mesh"]["ep"] == moe["ep"] == 2 and doc["mesh"]["n_chips"] == 4
    assert all(np.isfinite(doc["losses"]))
    if "--dropless" not in argv:
        assert moe["dispatch"] == "capacity" and moe["capacity"] > 0
        assert 0.0 <= moe["dropped_fraction"] < 1.0
        assert moe["rows_per_device"] is None
    else:
        assert moe["dropped_fraction"] == 0.0
        rows = moe["rows_per_device"]
        assert rows["row_ratio"] == round(rows["dropless"] /
                                          rows["capacity"], 6)
    if "expert_choice" in argv:
        assert moe["router_mode"] == "expert_choice"
        assert 0.0 < moe["ec_coverage"] <= 1.0 and moe["aux_loss"] == 0.0


# -- trash tiles ---------------------------------------------------------------

def test_plain_k4_skips_trash_tiles():
    """The layout of a two-owner fold: each owner's live tiles, then its
    trash tiles (-1).  The plain forward and backward give zeros there
    (inputs and cotangents non-zero, so nothing but the mark does it) and
    the values of the same layout with the trash tiles clamped onto the
    owner's last expert everywhere else (zero rows there, as the dispatch
    leaves them)."""
    rng = np.random.default_rng(11)
    tile, D, F, el = 4, 8, 12, 2
    ids, clamped = [], []
    for o in range(2):
        live = list(np.sort(rng.integers(0, el, 5)) + o * el)
        ids += live + [-1] * 4
        clamped += live + [o * el + el - 1] * 4
    G = len(ids)
    eid = torch.tensor(ids, dtype=torch.int32)
    trash = eid < 0
    xt = _t(rng.normal(size=(G, tile, D)).astype(np.float32))
    g = _t(rng.normal(size=(G, tile, D)).astype(np.float32))
    w1 = _t((rng.normal(size=(2, el, D, F)) * 0.3).astype(np.float32))
    w2 = _t((rng.normal(size=(2, el, F, D)) * 0.3).astype(np.float32))

    def run(x, e, cot):
        x, a, b = (z.clone().requires_grad_() for z in (x, w1, w2))
        out = gf.grouped_ffn(x, e, a, b)
        return (out.detach(),) + torch.autograd.grad(out, (x, a, b), cot)

    got = run(xt, eid, g)
    assert not got[0][trash].any() and not got[1][trash].any()
    assert torch.equal(gf.grouped_ffn_plain(xt, eid, w1, w2), got[0])
    torch.testing.assert_close(
        gf.grouped_ffn_plain_by_expert(xt, eid, w1, w2), got[0], rtol=0,
        atol=1e-6)
    xz, gz = xt.clone(), g.clone()
    xz[trash], gz[trash] = 0, 0
    ref = run(xz, torch.tensor(clamped, dtype=torch.int32), gz)
    for name, a, b in (("out", got[0][~trash], ref[0][~trash]),
                       ("dxt", got[1][~trash], ref[1][~trash]),
                       ("dw1", got[2], ref[2]), ("dw2", got[3], ref[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
    # the dispatch marks them itself: a fold's layout past each group
    sizes = torch.tensor([[3, 0], [5, 2]])
    _, teid = tdl.tile_layout(sizes, tile=tile, max_rows=8)
    marked = tdl.mark_trash_tiles(sizes, teid, tile=tile)
    assert marked.tolist() == [[0, -1, -1, -1], [0, 0, 1, -1]]
