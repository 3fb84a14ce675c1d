"""The port's flash attention (K1/K2 plain versions, local flash attention,
stacked ring attention) vs the JAX package on the CPU.

* ``attention_block_partial_plain`` / ``attention_block_backward_plain``
  against the JAX Pallas kernels in interpret mode (as
  tests/test_pallas_attention.py runs them) over causal, offsets
  (including all-masked rows), window, GQA, ``block_q`` 8/16 with a Tq
  that does not divide, and bf16 inputs: atol 1e-5 (both sides f32 from
  the same values; -inf exactly where JAX has it);
* ``local_flash_attention`` gradients (the port's autograd Function:
  K1 forward, K2 backward) against ``jax.grad`` through the JAX
  ``local_flash_attention`` custom_vjp: atol 1e-5;
* stacked ``ring_attention`` forward and backward against the JAX
  ``ring_attention(use_pallas=True)`` under ``shard_map`` on 4 devices,
  both the port's kernel-path Function and its plain path: atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu.ops import pallas_attention as jpa
from bluefog_tpu.ops import ring as jring
from bluefog_tpu.ops import ulysses as jul
from bluefog_tpu_torch.ops import flash_attention as tfa
from bluefog_tpu_torch.ops import ring as tring
from bluefog_tpu_torch.ops import ulysses as tul
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

# B, Tq, Tk, H, Hkv, D, causal, q_offset, k_offset, window, block_q, dtype
CASES = [
    (2, 16, 16, 4, 4, 8, False, 0, 0, 0, 512, "f32"),
    (1, 16, 16, 4, 4, 8, True, 0, 0, 0, 8, "f32"),
    (1, 12, 20, 4, 2, 8, True, 20, 4, 0, 8, "f32"),     # GQA, offsets
    (1, 13, 16, 4, 1, 8, True, 0, 0, 0, 16, "f32"),     # Tq % block_q != 0
    (1, 8, 8, 2, 2, 8, True, 0, 8, 0, 8, "f32"),        # all rows masked
    (2, 24, 24, 4, 2, 8, True, 0, 0, 5, 8, "f32"),      # sliding window
    (1, 16, 16, 4, 2, 16, True, 8, 0, 0, 16, "bf16"),
]


def _inputs(seed, B, Tq, Tk, H, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))
    if dtype == "bf16":
        cast = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa
        q, k, v = cast(q), cast(k), cast(v)
    return q, k, v


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = ~np.isneginf(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_plain_kernels_match_pallas_interpret(case):
    B, Tq, Tk, H, Hkv, D, causal, qo, ko, window, bq, dtype = case
    q, k, v = _inputs(0, B, Tq, Tk, H, Hkv, D, dtype)
    scale = D ** -0.5
    jkw = dict(causal=causal, scale=scale, interpret=True, block_q=bq,
               window=window)
    tkw = dict(causal=causal, scale=scale, block_q=bq, window=window)
    want = jpa.attention_block_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo),
        jnp.asarray(ko), **jkw)
    got = tfa.attention_block_partial(_torch(q), _torch(k), _torch(v), qo,
                                      ko, **tkw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
    rng = np.random.default_rng(1)
    do = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    o, l, m = (np.asarray(x) for x in want)
    lse = np.where(l == 0, -np.inf, m + np.log(np.where(l == 0, 1.0, l)))
    delta = rng.normal(size=(B, Tq, H)).astype(np.float32)
    want = jpa.attention_block_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        jnp.asarray(lse, jnp.float32), jnp.asarray(delta), jnp.asarray(qo),
        jnp.asarray(ko), **jkw)
    got = tfa.attention_block_backward(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(do),
        torch.from_numpy(lse.astype(np.float32)), torch.from_numpy(delta),
        qo, ko, **tkw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


def test_kernel_contracts_and_merge_partials():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="q heads 3 not a multiple of kv "
                                         "heads 2"):
        tfa.attention_block_partial(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="block_q"):
        tfa.attention_block_partial(q, q, q, block_q=0)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tfa.flash_fwd_cuda(q, q, q, 0, 0, causal=False, scale=1.0)
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        tfa.attention_block_partial(q.to("meta"), q.to("meta"),
                                    q.to("meta"))
    parts = []
    for seed in (0, 1):
        a, b, c = _inputs(seed, 1, 8, 8, 2, 2, 4, "f32")
        jp = jpa.attention_block_partial(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(0),
            jnp.asarray(0), causal=True, scale=0.5, interpret=True)
        parts.append(jp)
    o0 = np.zeros((1, 8, 2, 4), np.float32)
    l0 = np.zeros((1, 8, 2), np.float32)
    m0 = np.full((1, 8, 2), -np.inf, np.float32)
    want = jpa.merge_partials(jpa.merge_partials(
        (jnp.asarray(o0), jnp.asarray(l0), jnp.asarray(m0)), parts[0]),
        parts[1])
    tp = [tuple(torch.from_numpy(np.array(x)) for x in p) for p in parts]
    got = tfa.merge_partials(tfa.merge_partials(
        (torch.from_numpy(o0), torch.from_numpy(l0), torch.from_numpy(m0)),
        tp[0]), tp[1])
    for g, w in zip(got, want):
        _close(g.numpy(), w, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_local_flash_attention_grads_match_jax(causal):
    B, T, H, D = 2, 24, 4, 8
    q, k, v = _inputs(3, B, T, T, H, H, D, "f32")
    g = np.random.default_rng(4).normal(size=(B, T, H, D)).astype(
        np.float32)
    scale = D ** -0.5

    def jloss(a, b, c):
        out = jul.local_flash_attention(a, b, c, causal, scale, 8, True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tul.local_flash_attention(tq, tk, tv, causal, scale, 8)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    _close(out.detach().numpy(), jout)
    for a, b in zip(tgrads, jgrads):
        _close(a.numpy(), b)
    # the plain path (no kernels) agrees with JAX's jnp local attention
    plain = tul.ulysses_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    want = jul._jnp_local_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale)
    _close(plain.numpy(), want)
    assert tul._chunk_len(24, 10) == jul._chunk_len(24, 10) == 8
    with pytest.raises(ValueError, match="equal q/kv head counts"):
        tul.ulysses_attention(torch.from_numpy(q), torch.from_numpy(k)[:, :,
                              :2], torch.from_numpy(v)[:, :, :2])


def _stack(x, n):
    """[B, n*Tl, H, D] -> [n, B, Tl, H, D] (rank i holds block i)."""
    B, T, H, D = x.shape
    return x.reshape(B, n, T // n, H, D).transpose(1, 0, 2, 3, 4)


@pytest.mark.parametrize("Hkv,causal,window", [
    (4, True, None), (2, True, None), (4, False, None), (2, True, 6)])
def test_stacked_ring_attention_matches_jax(cpu_devices, Hkv, causal,
                                            window):
    n, B, Tl, H, D = 4, 1, 4, 4, 8
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, n * Tl, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, n * Tl, Hkv, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=q.shape).astype(np.float32)
    mesh = Mesh(np.array(cpu_devices[:n]), ("rank",))

    def f(qb, kb, vb, gb):
        def loss(a, b, c):
            out = jring.ring_attention(a, b, c, axis="rank", causal=causal,
                                       use_pallas=True, pallas_block_q=4,
                                       window=window)
            return jnp.sum(out * gb), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(qb, kb, vb)
        return (out,) + grads

    spec = P(None, "rank")
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 4,
                               out_specs=(spec,) * 4, check_vma=False))
    want = [_stack(np.asarray(x), n) for x in fn(q, k, v, g)]
    for use_pallas in (True, False):
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(_stack(x, n)))
                      .requires_grad_() for x in (q, k, v))
        out = tring.ring_attention(tq, tk, tv, causal=causal,
                                   use_pallas=use_pallas, pallas_block_q=4,
                                   window=window)
        grads = torch.autograd.grad(
            out, (tq, tk, tv), torch.from_numpy(np.ascontiguousarray(
                _stack(g, n))))
        for a, b in zip((out.detach(),) + grads, want):
            _close(a.numpy(), b)


def test_ring_contracts():
    x = torch.zeros(2, 1, 4, 2, 8)
    # the zigzag layout runs (its own contracts: test_torch_long_context)
    out = tring.ring_attention(x, x, x, causal=True, layout="zigzag")
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="needs causal=True"):
        tring.ring_attention(x, x, x, window=2)
    with pytest.raises(ValueError, match="expected stacked"):
        tring.ring_attention(x[0], x[0], x[0])
    for args in ((0, 1, 4, 4, True, 0), (3, 0, 4, 4, True, 0),
                 (3, 0, 4, 4, True, 5), (1, 1, 4, 4, False, 0)):
        jv = jring._block_visible(*args)
        assert tring._block_visible(*args) == (None if jv is None
                                               else bool(jv))


def test_kernel_operands_are_16_byte_aligned():
    """The kernels stage rows with 16-byte cp.async copies: the wrapper
    passes an aligned tensor through and copies a misaligned view."""
    base = torch.arange(20, dtype=torch.float32)
    assert tfa._aligned(base) is base
    view = base[1:17]                       # contiguous, 4 bytes off
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = tfa._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_attention_bound_is_taken_at_the_3xtf32_rate():
    """chip_smoke's least time for K1/K2: f32 products at a third of the
    TF32 tensor-core rate (3xTF32), bf16 at the bf16 rate; the CUDA-core
    f32 rate only when asked for."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bound", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B, T, H, D = 4, 2048, 16, 64
    pairs = cs._visible_pairs(T, T, 0, 0, True, 0)
    assert pairs == T * (T + 1) // 2
    fwd, by = cs._attn_bound(B, T, T, H, H, D, 4, pairs, False)
    assert by == "operations"
    assert fwd == pytest.approx(1e3 * 4 * B * H * pairs * D / (495e12 / 3))
    bwd, _ = cs._attn_bound(B, T, T, H, H, D, 4, pairs, True)
    assert bwd == pytest.approx(2.5 * fwd)
    simt, _ = cs._attn_bound(B, T, T, H, H, D, 4, pairs, False, cs.F32_FLOPS)
    assert simt == pytest.approx(fwd * (495e12 / 3) / 67e12)
    bf16, _ = cs._attn_bound(B, T, T, H, H, D, 2, pairs, False)
    assert bf16 == pytest.approx(1e3 * 4 * B * H * pairs * D / 989e12)


@pytest.mark.parametrize("D", [2, 8, 40, 96, 128, 7, 130, 136, 256])
def test_head_dim_padding_route_matches_plain(D):
    """K1/K2 are built for head_dim 64, 128 and 256; the wrappers zero-pad
    every other D (odd ones too) to the next and slice the results back.
    The padding route, run here around the plain versions on CPU tensors,
    gives the unpadded plain results (the zero columns add exact zeros;
    only the einsums' summation order may differ): atol 1e-6."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(D, 2, 12, 20, 4, 2, D, "f32"))
    kw = dict(causal=True, scale=D ** -0.5, window=0)
    got = tfa._padded_fwd(tfa.attention_block_partial_plain, q, k, v, 20,
                          4, **kw)
    want = tfa.attention_block_partial_plain(q, k, v, 20, 4, **kw)
    padded = D not in (64, 128, 256)    # a padded result is sliced back
    assert got[0].shape == q.shape and got[0].is_contiguous() >= padded
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    rng = np.random.default_rng(D)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    lse = torch.from_numpy(rng.normal(size=q.shape[:3]).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=q.shape[:3]).astype(
        np.float32))
    got = tfa._padded_bwd(tfa.attention_block_backward_plain, q, k, v, do,
                          lse, delta, 20, 4, **kw)
    want = tfa.attention_block_backward_plain(q, k, v, do, lse, delta, 20,
                                              4, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous() >= padded
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    assert tfa.kernel_head_dim(D) == (64 if D <= 64 else
                                      128 if D <= 128 else 256)
    for bad in (0, 258):
        with pytest.raises(ValueError, match=f"head_dim {bad}: .* up to 256"):
            tfa.kernel_head_dim(bad)
