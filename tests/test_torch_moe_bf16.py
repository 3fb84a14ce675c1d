"""The port's bf16 MoE training against the JAX package.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py`` under
``shard_map``; the port holds the same peers stacked along dim 0.  Inputs
are made from a seed with numpy and handed to both sides.  The yardstick
is JAX's float64 evaluation of the same bf16-rounded inputs: bf16 rounds
at other places in the two frameworks, so each side is held to its
distance from f64 rather than to the other's bits.

* K4 under autograd in bf16 (the port's CPU ``GroupedFFN``: the plain
  forward and :func:`grouped_ffn_backward_plain`, the kernels' rounding
  points) against ``jax.vjp`` of ``grouped_ffn_pallas`` in interpret mode
  on bf16 inputs, and against its f64 evaluation: for each of ``out``,
  ``dxt``, ``dw1``, ``dw2`` the port's max abs error from f64 is at most
  JAX bf16's plus one bf16 ulp of the tensor's max |value|, and the port
  lies within 2 such ulps of JAX.  Cases: steady routing, one hot expert,
  trash tiles (id -1 in the port; JAX's clamped ids on zero rows), and
  stacked-peer weights read through a layer slice.
* ``init_moe_train_params(dtype=torch.bfloat16)`` bit for bit against
  JAX's ``init_moe_params(dtype=jnp.bfloat16)`` (whose numpy cast of the
  float64 draws rounds through f32, as the port's does; a halfway case
  shows it).
* The bf16 first step (loss and every peer's gradients) against JAX's
  ``make_moe_grad_fn`` with K4 through its Pallas kernel, both held to
  JAX's float64 step on the same bf16 params: per leaf the port's
  distance from f64 is at most twice JAX bf16's, the loss within 2 bf16
  ulps of JAX's, and every gradient leaf stays bf16.
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from bluefog_tpu.moe import model as jmoe
from bluefog_tpu.ops.pallas_moe import grouped_ffn_pallas
from bluefog_tpu.parallel import compose as jcompose
from bluefog_tpu_torch import optimizers as topt
from bluefog_tpu_torch.moe import model as tmoe
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.parallel import compose as tcompose
import torch_cpu_threads  # noqa: F401  (the worker's thread share)


def _ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as f32 values."""
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


# -- K4 under autograd in bf16 -------------------------------------------

def _jax_vjp(eid, xt, w1, w2, ct, dtype):
    out, vjp = jax.vjp(lambda x, a, b: grouped_ffn_pallas(
        x, jnp.asarray(eid, jnp.int32), a, b, interpret=True),
        *(jnp.asarray(a, dtype) for a in (xt, w1, w2)))
    return [np.asarray(t, np.float64) for t in (out,) + vjp(
        jnp.asarray(ct, dtype))]


@pytest.mark.parametrize("case", ["steady", "hot_expert", "trash",
                                  "peers"])
def test_grouped_ffn_bf16_matches_jax_and_f64(case):
    rng = np.random.default_rng(161 + len(case))
    G, tile, D, F, E = 12, 8, 64, 256, 4
    eid = np.sort(rng.integers(0, E, G))
    if case == "hot_expert":
        eid = np.full(G, 2)
        eid[:2] = 0
    xt = _bf16(rng.normal(size=(G, tile, D)))
    w1 = _bf16(rng.normal(size=(E, D, F)) * 0.1)
    w2 = _bf16(rng.normal(size=(E, F, D)) * 0.1)
    ct = _bf16(rng.normal(size=(G, tile, D)))
    port_eid = eid.copy()
    if case == "trash":          # the clamped tail: zero rows, no cotangent
        port_eid[-3:] = -1
        eid[-3:] = eid[-4]
        xt[-3:] = 0
        ct[-3:] = 0
    want = _jax_vjp(eid, xt, w1, w2, ct, jnp.bfloat16)
    with jax.enable_x64(True):
        f64 = _jax_vjp(eid, xt, w1, w2, ct, jnp.float64)
    bf = torch.bfloat16
    x = torch.tensor(xt, dtype=bf).requires_grad_()
    if case == "peers":                      # [2 peers, 2 layers, 2, ...]
        big1 = torch.zeros((2, 2, 2, D, F), dtype=bf)
        big2 = torch.zeros((2, 2, 2, F, D), dtype=bf)
        big1[:, 1] = torch.tensor(w1, dtype=bf).view(2, 2, D, F)
        big2[:, 1] = torch.tensor(w2, dtype=bf).view(2, 2, F, D)
        b1, b2 = big1.requires_grad_(), big2.requires_grad_()
        a, b = b1[:, 1], b2[:, 1]
    else:
        a = torch.tensor(w1, dtype=bf).requires_grad_()
        b = torch.tensor(w2, dtype=bf).requires_grad_()
    out = gf.grouped_ffn(x, torch.tensor(port_eid, dtype=torch.int32), a, b)
    grads = torch.autograd.grad(out, (x, a, b), torch.tensor(ct, dtype=bf))
    got = [out] + [g.reshape(w.shape) for g, w in zip(grads, (xt, w1, w2))]
    for name, p, j, r in zip(("out", "dxt", "dw1", "dw2"), got, want, f64):
        assert p.dtype == bf, name
        p = p.detach().double().numpy()
        one = _ulp(float(np.abs(r).max()))
        port_err, jax_err = np.abs(p - r).max(), np.abs(j - r).max()
        assert port_err <= jax_err + one, (name, port_err, jax_err, one)
        assert np.abs(p - j).max() <= 2 * one, (name, np.abs(p - j).max())
    if case == "trash":
        assert not got[0][-3:].any() and not got[1][-3:].any()


# -- the bf16 init -------------------------------------------------------

def _cfg(mod, pp, **kw):
    return mod.MoELMConfig(vocab=64, d_model=32, heads=4, layers=2 * pp,
                           seq_len=16, micro=2 * pp, batch=2, num_experts=4,
                           top_k=2, dispatch="dropless", group_tile=4, **kw)


def _carve(cpu_devices, carving):
    dp, pp, tp, sp, ep = carving
    n = dp * pp * tp * sp * ep
    kw = dict(num_experts=4, capacity_factor=1.5)
    jm = jcompose.compose_parallelism(dp, pp, tp, sp, ep,
                                      devices=cpu_devices[:n], **kw)
    tm = tcompose.compose_parallelism(dp, pp, tp, sp, ep, device="cpu", **kw)
    return _cfg(jmoe, pp), _cfg(tmoe, pp), jm, tm


def test_bf16_cast_rounds_through_f32():
    """1 + 2^-8 + 2^-30 lies just above a bf16 halfway point: rounded
    straight it goes up, rounded through f32 (which drops the 2^-30) it
    ties to even, down.  JAX's numpy cast and the port's both go down."""
    x = np.array([1 + 2 ** -8 + 2 ** -30])
    assert float(x.astype(ml_dtypes.bfloat16)[0]) == 1.0
    assert float(torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16)[0]) == 1.0


@pytest.mark.parametrize("carving", [(2, 2, 2, 1, 1), (2, 1, 1, 1, 2)])
def test_bf16_init_is_bit_identical(cpu_devices, carving):
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
    jp = jmoe.init_moe_params(jcfg, jm, seed=4, dtype=jnp.bfloat16)
    tp = tmoe.init_moe_train_params(tcfg, tm, seed=4, dtype=torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for group, leaves in jp.items():
        assert sorted(tp[group]) == sorted(leaves)
        for k, v in leaves.items():
            t = tp[group][k]
            assert t.dtype == torch.bfloat16, k
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(v).view(np.int16)), k


# -- the bf16 first step -------------------------------------------------

def _jax_step(jcfg, jm, params):
    grad_fn = jmoe.make_moe_grad_fn(jcfg, jm)

    def f(p, t):
        loss, g = grad_fn(jax.tree.map(lambda x: x[0], p), t[0])
        return loss[None], jax.tree.map(lambda x: x[None], g)

    fn = jax.jit(jax.shard_map(f, mesh=jm.mesh, in_specs=(jm.spec,) * 2,
                               out_specs=(jm.spec,) * 2, check_vma=False))
    loss, grads = fn(jcompose.device_put(jm, params),
                     jmoe.make_moe_batch(jcfg, jm, seed=0))
    return (np.asarray(loss, np.float64),
            jax.tree.map(lambda x: np.asarray(x, np.float64), grads))


@pytest.mark.parametrize("carving", [(2, 1, 1, 1, 1), (2, 2, 2, 1, 1),
                                     (2, 1, 1, 1, 2)])
def test_bf16_first_step_matches_jax(cpu_devices, monkeypatch, carving):
    monkeypatch.setenv("BLUEFOG_MOE_GROUPED_IMPL", "pallas")
    jcfg, tcfg, jm, tm = _carve(cpu_devices, carving)
    p16 = jmoe.init_moe_params(jcfg, jm, seed=0, dtype=jnp.bfloat16)
    jloss, jgrads = _jax_step(jcfg, jm, p16)
    with jax.enable_x64(True):
        loss64, g64 = _jax_step(jcfg, jm, jax.tree.map(
            lambda x: np.asarray(x, np.float64), p16))
    tloss, tgrads = topt.stacked_grads(
        tmoe.make_moe_grad_fn(tcfg, tm),
        tmoe.init_moe_train_params(tcfg, tm, seed=0, dtype=torch.bfloat16),
        tmoe.make_moe_batch(tcfg, tm, seed=0), tm.slice_size)
    two = 2 * _ulp(float(np.abs(jloss).max()))
    assert np.abs(tloss.double().numpy() - jloss).max() <= two, \
        (tloss, jloss, loss64)
    for group, leaves in g64.items():
        for k, ref in leaves.items():
            t = tgrads[group][k]
            assert t.dtype == torch.bfloat16, (group, k)
            port_err = np.abs(t.double().numpy() - ref).max()
            jax_err = np.abs(jgrads[group][k] - ref).max()
            assert port_err <= 2 * jax_err, (group, k, port_err, jax_err)
