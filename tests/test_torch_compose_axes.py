"""The port's composed carving (dp x pp x tp x sp, ep = 1) vs the JAX package.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port
holds the same peers stacked along dim 0 of every tensor, in the JAX
flat device order.  Inputs are made from a seed with numpy and handed to
both sides.

* the stacked collectives (``psum``, ``pmean``, ``ppermute``, tiled
  ``all_to_all``) against the ``lax`` primitives inside ``shard_map``,
  row for row, in value and in VJP: atol 1e-6 (f32, a few adds);
* ``pipeline_apply`` against the sequential composition of
  ``tests/test_pipeline.py`` (forward, loss and every stage's grads, with
  and without remat): rtol 1e-5 / atol 1e-6;
* ``TPMlpBlock`` with the JAX module's weights against the JAX output and
  the dense oracle's: atol 1e-5;
* ``ulysses_attention`` at sp 2 and 4 against the JAX function, forward
  and grads, through the plain path and the flash path (the K1/K2 plain
  versions; JAX's Pallas in interpret mode): atol 1e-5;
* ``init_lm_train_params`` / ``make_lm_batch`` bit-identical, the
  first-step loss and every peer's gradients against the JAX
  ``make_lm_grad_fn`` under ``shard_map`` (as ``make_train_step`` runs
  it) at (dp, pp, tp, sp) in {(2,2,2,1), (2,1,2,2), (1,2,2,2), (2,1,1,4)}:
  losses rtol 1e-5, grads atol 1e-5 (the tolerances of
  ``tests/test_torch_train.py``);
* a 3-step SGD trajectory through both ``make_train_step``s at (2,2,2,1):
  losses rtol 1e-5, params atol 1e-5;
* the JAX x64 oracle's property for the port: gossip-DP x PP trains
  loss for loss like flat DP in float64 (atol 1e-9);
* the carving: accepted axes, refusals, ``describe``, the mixing matrix
  and the config rules against JAX's texts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import bluefog_tpu.optimizers as jopt
from bluefog_tpu.ops import ulysses as jul
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu.parallel.tensor_parallel import TPMlpBlock as JTPMlpBlock
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.fusion import tree_flatten
from bluefog_tpu_torch.ops import collectives as tcoll
from bluefog_tpu_torch.ops import ulysses as tul
from bluefog_tpu_torch.parallel import compose as tcompose
from bluefog_tpu_torch.parallel.pipeline import (last_stage_value,
                                                 pipeline_apply)
from bluefog_tpu_torch.parallel.tensor_parallel import TPMlpBlock

CARVINGS = [(2, 2, 2, 1), (2, 1, 2, 2), (1, 2, 2, 2), (2, 1, 1, 4)]


def _cfg(mod, pp, sp):
    return mod.LMConfig(vocab=64, d_model=32, heads=8 if sp == 4 else 4,
                        layers=2 * pp, seq_len=32 if sp == 4 else 16,
                        micro=2 * pp, batch=2)


# -- the stacked collectives --------------------------------------------

def _lax_op(name):
    if name == "psum":
        return lambda x: lax.psum(x, "b")
    if name == "pmean":
        return lambda x: lax.pmean(x, "b")
    if name == "ppermute":
        return lambda x: lax.ppermute(x, "b", [(0, 1), (1, 2), (3, 0)])
    return lambda x: lax.all_to_all(x, "b", 1, 2, tiled=True)


def _port_op(name):
    # the stacked view is [a, b, ...block]: the peer axis "b" is dim 1
    if name == "psum":
        return lambda x: tcoll.psum(x, 1)
    if name == "pmean":
        return lambda x: tcoll.pmean(x, 1)
    if name == "ppermute":
        return lambda x: tcoll.ppermute(x, 1, [(0, 1), (1, 2), (3, 0)])
    return lambda x: tcoll.all_to_all(x, 1, 3, 4)


@pytest.mark.parametrize("name", ["psum", "pmean", "ppermute",
                                  "all_to_all"])
def test_collectives_match_lax(cpu_devices, name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3, 8, 4)).astype(np.float32)
    ct = rng.normal(size=(8, 3, 8, 4)).astype(np.float32)
    if name == "all_to_all":
        ct = rng.normal(size=(8, 3, 2, 16)).astype(np.float32)
    mesh = Mesh(np.array(cpu_devices).reshape(2, 4), ("a", "b"))
    op = _lax_op(name)

    def f(xb, cb):
        y, vjp = jax.vjp(op, xb[0])
        return y[None], vjp(cb[0])[0][None]

    jy, jg = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(("a", "b")),) * 2,
        out_specs=(P(("a", "b")),) * 2, check_vma=False))(x, ct)
    tx = torch.from_numpy(x).view(2, 4, 3, 8, 4).requires_grad_()
    ty = _port_op(name)(tx)
    tg, = torch.autograd.grad(ty, tx, torch.from_numpy(ct).view(ty.shape))
    np.testing.assert_allclose(ty.detach().reshape(jy.shape).numpy(),
                               np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.reshape(jg.shape).numpy(), np.asarray(jg),
                               rtol=0, atol=1e-6)


def test_collectives_refuse_bad_arguments():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="partial permutation"):
        tcoll.ppermute(x, 0, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="into 4 chunks"):
        tcoll.all_to_all(torch.zeros(4, 2, 6), 0, 2, 1)
    with pytest.raises(ValueError, match="differ from the peer axis"):
        tcoll.all_to_all(x, 0, 0, 1)


# -- pipeline_apply against the sequential composition -------------------

@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_matches_sequential(remat):
    S, M, B, D = 4, 6, 2, 5          # tests/test_pipeline.py's sizes
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(S, D, D)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
    mb = rng.normal(size=(M, B, D)).astype(np.float32)
    tgt = rng.normal(size=(M, B, D)).astype(np.float32)

    def seq_loss(params):
        x = jnp.asarray(mb)
        for s in range(S):
            x = jnp.tanh(x @ params["w"][s] + params["b"][s])
        return jnp.mean((x - tgt) ** 2), x

    (jl, jout), jg = jax.value_and_grad(seq_loss, has_aux=True)(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)})

    def stage_fn(p, x):              # k stages at once: x [k, B, D]
        return torch.tanh(torch.bmm(x, p["w"]) + p["b"][:, None])

    tp = {"w": torch.from_numpy(w).requires_grad_(),
          "b": torch.from_numpy(b).requires_grad_()}
    out = pipeline_apply(stage_fn, tp, torch.from_numpy(mb), remat=remat)
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    assert abs(loss.item() - float(jl)) < 1e-6
    for key in ("w", "b"):
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(jg[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    # one microbatch through S stages: the product of the stage scales
    scales = torch.stack([torch.eye(D) * (s + 1) for s in range(S)])
    one = pipeline_apply(lambda p, x: torch.bmm(x, p["w"]), {"w": scales},
                         torch.ones(1, B, D))
    np.testing.assert_allclose(one[0].numpy(), np.full((B, D), 24.0))
    stacked = torch.arange(3.0)[:, None].expand(3, 2)
    assert torch.equal(last_stage_value(stacked), torch.full((3, 2), 2.0))


# -- Megatron tp ----------------------------------------------------------

def test_tp_mlp_matches_dense(cpu_devices):
    """tests/test_tensor_parallel.py's case: the JAX module's weights in
    the port's TPMlpBlock give JAX's output on every tp peer."""
    mesh = Mesh(np.array(cpu_devices[:4]), ("model",))
    B, Din, H, Dout = 2, 6, 8, 5
    x = np.random.default_rng(0).normal(size=(B, Din)).astype(np.float32)
    block = JTPMlpBlock(hidden=H, features=Dout, axis="model")

    def init_and_apply(xb):
        params = block.init(jax.random.key(0), xb)
        return block.apply(params, xb), jax.tree.map(lambda v: v[None],
                                                     params)

    y_tp, params_tp = jax.jit(jax.shard_map(
        init_and_apply, mesh=mesh, in_specs=P(),
        out_specs=(P(), P("model"))))(jnp.asarray(x))
    tblock = TPMlpBlock(Din, H, Dout, tp=4)
    tblock.load_flax(jax.tree.map(np.asarray, params_tp)["params"])
    tx = torch.from_numpy(x).expand(4, B, Din).clone().requires_grad_()
    ty = tblock(tx)
    for t in range(4):
        np.testing.assert_allclose(ty[t].detach().numpy(), np.asarray(y_tp),
                                   rtol=1e-5, atol=1e-5)
    # the input gradient, summed over the peers' copies, is the dense one
    w1 = torch.cat(list(tblock.col.kernel), dim=1).detach()
    b1 = tblock.col.bias.detach().reshape(-1)
    w2 = torch.cat(list(tblock.row.kernel), dim=0).detach()
    xd = torch.from_numpy(x).requires_grad_()
    dense = torch.nn.functional.gelu(xd @ w1 + b1, approximate="tanh") @ w2
    (dense.sum()).backward()
    (ty[0].sum()).backward()
    np.testing.assert_allclose(tx.grad.sum(0).numpy(), xd.grad.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- Ulysses --------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_matches_jax(cpu_devices, sp, use_pallas):
    B, T, H, D = 2, 32, 8, 8
    rng = np.random.default_rng(sp)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    mesh = Mesh(np.array(cpu_devices[:sp]), ("sp",))

    def f(a, b, c, ct):
        def att(a, b, c):
            return jul.ulysses_attention(a, b, c, axis="sp", causal=True,
                                         use_pallas=use_pallas,
                                         pallas_block_q=8)
        out, vjp = jax.vjp(att, a, b, c)
        return (out,) + vjp(ct)

    spec = P(None, "sp")
    jres = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 4,
                                 out_specs=(spec,) * 4, check_vma=False))(
        *(jnp.asarray(a) for a in (q, k, v, g)))

    def stacked(a):                  # [B, T, H, D] -> [sp, B, T/sp, H, D]
        return torch.from_numpy(a).view(B, sp, T // sp, H, D).permute(
            1, 0, 2, 3, 4).contiguous()

    def unstacked(t):
        return t.permute(1, 0, 2, 3, 4).reshape(B, T, H, D).numpy()

    tq, tk, tv = (stacked(a).requires_grad_() for a in (q, k, v))
    out = tul.ulysses_attention(tq, tk, tv, axis=0, causal=True,
                                use_pallas=use_pallas, pallas_block_q=8)
    grads = torch.autograd.grad(out, (tq, tk, tv), stacked(g))
    for got, want in zip((out.detach(),) + grads, jres):
        np.testing.assert_allclose(unstacked(got), np.asarray(want),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible by axis size"):
        tul.ulysses_attention(tq[..., :7, :], tk[..., :7, :],
                              tv[..., :7, :], axis=0)
    with pytest.raises(ValueError, match="equal q/kv head counts"):
        tul.ulysses_attention(tq, tk[..., :4, :], tv[..., :4, :], axis=0)


# -- the composed LM ------------------------------------------------------

def _carve(cpu_devices, carving):
    dp, pp, tp, sp = carving
    n = dp * pp * tp * sp
    jm = jcompose.compose_parallelism(dp, pp, tp, sp,
                                      devices=cpu_devices[:n])
    tm = tcompose.compose_parallelism(dp, pp, tp, sp, device="cpu")
    return _cfg(jcompose, pp, sp), _cfg(tcompose, pp, sp), jm, tm


@pytest.mark.parametrize("carving", CARVINGS)
def test_init_and_batch_are_bit_identical(cpu_devices, carving):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
    jp = jcompose.init_lm_params(jcfg, jm, seed=3)
    tp = tcompose.init_lm_train_params(tcfg, tm, seed=3)
    for group in ("blocks", "shared"):
        for k, v in jp[group].items():
            assert np.array_equal(tp[group][k].numpy(), np.asarray(v)), k
    for steps in (None, 2):
        assert np.array_equal(
            tcompose.make_lm_batch(tcfg, tm, seed=5, steps=steps).numpy(),
            np.asarray(jcompose.make_lm_batch(jcfg, jm, seed=5,
                                              steps=steps)))
    assert tm.describe() == jm.describe()
    assert (tm.size, tm.slice_size) == (jm.size, jm.slice_size)
    np.testing.assert_array_equal(tm.effective_mixing(),
                                  jm.effective_mixing())


def _jax_first_step(jcfg, jm, use_pallas=False):
    """Every device's loss and gradients from the JAX grad fn, run per
    device under shard_map as make_train_step runs it."""
    grad_fn = jcompose.make_lm_grad_fn(jcfg, jm, use_pallas=use_pallas)

    def f(p, t):
        loss, g = grad_fn(jax.tree.map(lambda x: x[0], p), t[0])
        return loss[None], jax.tree.map(lambda x: x[None], g)

    fn = jax.jit(jax.shard_map(f, mesh=jm.mesh, in_specs=(jm.spec,) * 2,
                               out_specs=(jm.spec,) * 2, check_vma=False))
    loss, grads = fn(jcompose.device_put(jm, jcompose.init_lm_params(jcfg,
                                                                     jm)),
                     jcompose.make_lm_batch(jcfg, jm))
    return np.asarray(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("carving", CARVINGS)
def test_first_step_matches_jax(cpu_devices, carving):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
    jloss, jgrads = _jax_first_step(jcfg, jm)
    grad_fn = tcompose.make_lm_grad_fn(tcfg, tm)
    tloss, tgrads = topt.stacked_grads(
        grad_fn, tcompose.init_lm_train_params(tcfg, tm),
        tcompose.make_lm_batch(tcfg, tm), tm.slice_size)
    np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
    for group in ("blocks", "shared"):
        for k, v in jgrads[group].items():
            np.testing.assert_allclose(tgrads[group][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=f"{group}/{k}")


def test_first_step_matches_jax_flash_path(cpu_devices):
    """Ulysses through the K1/K2 plain versions at dp 2 x tp 2 x sp 2
    against JAX's Pallas path in interpret mode."""
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 1, 2, 2))
    jloss, jgrads = _jax_first_step(jcfg, jm, use_pallas=True)
    tloss, tgrads = topt.stacked_grads(
        tcompose.make_lm_grad_fn(tcfg, tm, use_pallas=True),
        tcompose.init_lm_train_params(tcfg, tm),
        tcompose.make_lm_batch(tcfg, tm), tm.slice_size)
    np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
    for group in ("blocks", "shared"):
        for k, v in jgrads[group].items():
            np.testing.assert_allclose(tgrads[group][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=f"{group}/{k}")


def test_sgd_trajectory_matches_jax(cpu_devices):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, (2, 2, 2, 1))
    jstep, jstrat = jcompose.make_train_step(
        jm, jcompose.make_lm_grad_fn(jcfg, jm), optax.sgd(0.1))
    jparams = jcompose.init_lm_params(jcfg, jm)
    jstate = jopt.init_distributed(jstrat, jparams)
    jparams = jcompose.device_put(jm, jparams)
    jtoks = jcompose.make_lm_batch(jcfg, jm)
    tstep, tstrat = tcompose.make_train_step(
        tm, tcompose.make_lm_grad_fn(tcfg, tm), topt.sgd(0.1))
    tparams = tcompose.init_lm_train_params(tcfg, tm)
    tstate = topt.init_distributed(tstrat, tparams)
    ttoks = tcompose.make_lm_batch(tcfg, tm)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jtoks)
        tparams, tstate, tloss = tstep(tparams, tstate, ttoks)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                                   rtol=1e-5)
    for group in ("blocks", "shared"):
        for k, v in jparams[group].items():
            np.testing.assert_allclose(tparams[group][k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5,
                                       err_msg=f"{group}/{k}")
    assert float(tloss.mean()) < float(jnp.mean(jloss)) + 1e-4


def _f64_losses(pp):
    cfg = tcompose.LMConfig(layers=4)
    m = tcompose.compose_parallelism(2, pp, device="cpu")
    step, strategy = tcompose.make_train_step(
        m, tcompose.make_lm_grad_fn(cfg, m), topt.sgd(0.1))
    params = tcompose.init_lm_train_params(cfg, m)
    params = {g: {k: v.double() for k, v in d.items()}
              for g, d in params.items()}
    state = topt.init_distributed(strategy, params)
    toks = tcompose.make_lm_batch(cfg, m)
    losses = []
    for _ in range(6):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss.mean()))
    return losses, params


def test_float64_dp_x_pp_equals_flat_dp():
    """tests/test_compose.py's x64 oracle, for the port: the same 4-layer
    LM as dp 2 x pp 2 and as dp 2 gives the same float64 losses."""
    composed, params = _f64_losses(2)
    flat, _ = _f64_losses(1)
    np.testing.assert_allclose(composed, flat, rtol=0, atol=1e-9)
    assert composed[-1] < composed[0]
    assert all(x.dtype == torch.float64 for x in tree_flatten(params)[0])


def test_carving_contracts(cpu_devices):
    m = tcompose.compose_parallelism(2, 2, 2, 2, device="cpu")
    assert (m.size, m.slice_size, m.ep) == (16, 8, 1)
    with pytest.raises(ValueError, match="not yet ported"):
        tcompose.compose_parallelism(2, 1, 1, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        tcompose.compose_parallelism(2, 2, 2, 1, device="cpu", wire="bf16")
    with pytest.raises(ValueError, match="dp=1 carving"):
        tcompose.compose_parallelism(1, 2, 2, 2, device="cpu", wire="bf16")
    with pytest.raises(ValueError, match="positive int"):
        tcompose.compose_parallelism(2, 0, device="cpu")
    jm = jcompose.compose_parallelism(2, 2, 2, 1, devices=cpu_devices)
    tm = tcompose.compose_parallelism(2, 2, 2, 1, device="cpu")
    jm_sp = jcompose.compose_parallelism(2, 1, 1, 4, devices=cpu_devices)
    tm_sp = tcompose.compose_parallelism(2, 1, 1, 4, device="cpu")
    for kw, jmesh, tmesh in [
            (dict(layers=3), jm, tm), (dict(heads=1), jm, tm),
            (dict(d_model=30, heads=4), jm, tm),
            (dict(heads=2), jm_sp, tm_sp),
            (dict(seq_len=8, lag=2), jm_sp, tm_sp),
            (dict(seq_len=30), jm_sp, tm_sp)]:
        with pytest.raises(ValueError) as jerr:
            jcompose.LMConfig(**kw).validate(jmesh)
        with pytest.raises(ValueError) as terr:
            tcompose.LMConfig(**kw).validate(tmesh)
        assert str(terr.value) == str(jerr.value)
