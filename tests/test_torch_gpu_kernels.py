"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
elsewhere; this file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu

Flash decode: max abs error 1e-4 with f32 q (same stored values, f32
accumulation, only the summation order differs); with bf16 q one bf16
ulp of each output (rtol 8e-3) plus 1e-5 of f32 noise before rounding.

Flash attention K1/K2 (and the ring and the trainer built on them): both
sides accumulate in f32 from the same values and only the order differs,
so o/l atol 1e-4, l rtol 1e-4, m atol 1e-5 with -inf exactly where the
plain version has it, and dq/dk/dv atol 1e-4 x max|plain| per tensor
(dk/dv sum over up to Tq * G rows).

Grouped expert FFN K4: both sides accumulate in f32 from the same values
and only the order differs, so f32 max abs error 1e-4 x max|plain|; with
bf16 operands one bf16 ulp of each output (rtol 8e-3) on top of that.
"""
import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import flash_attention as fa
from bluefog_tpu_torch.ops import flash_decode as fd
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.ops import ring
from bluefog_tpu_torch.serve import kv_cache as kv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("store,qdt", [
    ("f32", torch.float32), ("bf16", torch.float32),
    ("bf16", torch.bfloat16), ("int8", torch.float32),
    ("fp8", torch.float32)])
@pytest.mark.parametrize("Hkv,T,Dh,block_k", [
    (4, 2, 64, 128), (16, 1, 128, 64), (2, 3, 64, 8)])
@pytest.mark.parametrize("prefix", [False, True])
def test_flash_decode_kernel_matches_plain(cuda, store, qdt, Hkv, T, Dh,
                                           block_k, prefix):
    rng = np.random.default_rng(4)
    rows, H, L = 9, 16, 256
    cl = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=(rows, Hkv, L, Dh)).astype(
            np.float32)).to(cuda)
        if store == "f32":
            cl[name] = x
        elif store == "bf16":
            cl[name] = x.bfloat16()
        else:
            cl[name], sc = kv.quantize_rows(x, store)
            cl[name + "_scale"] = sc.contiguous()
    slots = torch.tensor([0, 3, 8, 5], dtype=torch.int32, device=cuda)
    lens = torch.tensor([0, 100, 0, L - T], dtype=torch.int32, device=cuda)
    pre = {}
    if prefix:
        bk = min(block_k, L)
        pre = dict(prefix_slots=torch.full((4,), 7, dtype=torch.int32,
                                           device=cuda),
                   prefix_lens=(lens // 2) // bk * bk)
    q = torch.from_numpy(rng.normal(size=(4, T, H, Dh)).astype(
        np.float32)).to(cuda, qdt)
    before = fd.flash_decode_cuda.launches
    got = fd.flash_attend_chunk(q, cl, slots, lens, block_k=block_k, **pre)
    want = kv.attend_chunk(q, cl, slots, lens, **pre)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches == before + 1
    assert got.dtype == qdt and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    if qdt == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert bool((diff <= 8e-3 * want.float().abs() + 1e-5).all())
    rows_out = fd.flash_attend_rows(
        q[:, 0].contiguous(), cl["k"], cl["v"], slots, lens,
        k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"),
        block_k=block_k, **pre)
    rows_want = kv.attend_rows(
        q[:, 0], cl["k"], cl["v"], slots, lens, k_scale=cl.get("k_scale"),
        v_scale=cl.get("v_scale"), **pre)
    torch.cuda.synchronize()
    assert float((rows_out.float() - rows_want.float()).abs().max()) <= (
        1e-4 if qdt == torch.float32 else 8e-3 * float(
            rows_want.float().abs().max()))


@pytest.mark.gpu
def test_flash_decode_refuses_what_it_does_not_take(cuda):
    cl = {"k": torch.zeros(2, 1, 16, 32, device=cuda),
          "v": torch.zeros(2, 1, 16, 32, device=cuda)}
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 32"):
        fd.flash_attend_rows(torch.zeros(1, 1, 32, device=cuda), cl["k"],
                             cl["v"], idx, idx, block_k=8)
    cl64 = {"k": torch.zeros(2, 1, 16, 64, device=cuda, dtype=torch.half),
            "v": torch.zeros(2, 1, 16, 64, device=cuda, dtype=torch.half)}
    with pytest.raises(TypeError, match="page dtypes"):
        fd.flash_attend_rows(torch.zeros(1, 1, 64, device=cuda), cl64["k"],
                             cl64["v"], idx, idx, block_k=8)


def _qkv(rng, B, Tq, Tk, H, Hkv, D, dtype, device):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dtype)
    return t(B, Tq, H, D), t(B, Tk, Hkv, D), t(B, Tk, Hkv, D)


def _close_grad(got, want):
    lim = 1e-4 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,causal,qoff,koff,window", [
    (2, 100, 77, 4, 4, 64, False, 0, 0, 0),
    (1, 130, 130, 8, 2, 128, True, 0, 0, 0),
    (2, 64, 192, 4, 1, 64, True, 192, 64, 0),
    (1, 96, 96, 4, 4, 64, True, 0, 96, 0),          # every row masked
    (1, 200, 200, 4, 2, 64, True, 0, 0, 50)])
def test_flash_attention_kernels_match_plain(cuda, dtype, B, Tq, Tk, H, Hkv,
                                             D, causal, qoff, koff, window):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, B, Tq, Tk, H, Hkv, D, dtype, cuda)
    kw = dict(causal=causal, scale=D ** -0.5, window=window)
    before = (fa.fwd_launches, fa.bwd_launches)
    o, l, m = fa.attention_block_partial(q, k, v, qoff, koff, **kw)
    wo, wl, wm = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
    fin = ~torch.isneginf(wm)
    zero = torch.zeros_like(m)
    assert float((torch.where(fin, m, zero) - torch.where(fin, wm, zero))
                 .abs().max()) <= 1e-5
    assert bool(((l - wl).abs() <= 1e-4 * wl.abs()).all())
    den = torch.where(wl == 0, torch.ones_like(wl), wl)[..., None]
    assert float((o / den - wo / den).abs().max()) <= 1e-4
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    lse = torch.where(wl == 0, torch.full_like(wl, float("-inf")),
                      wm + torch.log(den[..., 0]))
    delta = torch.from_numpy(rng.normal(size=q.shape[:3]).astype(
        np.float32)).to(cuda)
    got = fa.attention_block_backward(q, k, v, do, lse, delta, qoff, koff,
                                      **kw)
    want = fa.attention_block_backward_plain(q, k, v, do, lse, delta, qoff,
                                             koff, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close_grad(g, w)


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 32"):
        fa.attention_block_partial(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.half)
    with pytest.raises(TypeError, match="dtype"):
        fa.attention_block_partial(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        fa.attention_block_partial(q, q[:, :, :3], q[:, :, :3])


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv,window", [(4, None), (2, None), (4, 96)])
def test_ring_attention_kernels_match_plain_ring(cuda, Hkv, window):
    rng = np.random.default_rng(3)
    n, B, Tl, H, D = 4, 1, 64, 4, 64

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda).requires_grad_()

    q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    out = ring.ring_attention(q, k, v, causal=True, window=window)
    grads = torch.autograd.grad(out, (q, k, v), g)
    want = ring._plain_ring_attention(q, k, v, True, D ** -0.5, window or 0)
    wgrads = torch.autograd.grad(want, (q, k, v), g)
    torch.cuda.synchronize()
    assert float((out - want).detach().abs().max()) <= 1e-4
    for a, b in zip(grads, wgrads):
        _close_grad(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,tile,D,F,routing", [
    (12, 2, 256, 512, "sorted"), (5, 1, 256, 512, "sorted"),
    (9, 8, 128, 384, "sorted"), (4, 16, 128, 256, "sorted"),
    (12, 2, 256, 512, "hostile"), (7, 3, 96, 200, "sorted")])
def test_grouped_ffn_kernel_matches_plain(cuda, dtype, G, tile, D, F,
                                          routing):
    rng = np.random.default_rng(G * tile)
    E = 8

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda, dtype)

    xt = t(G, tile, D)
    xt[-1] = 0                            # a clamped tail tile: zero rows
    w1, w2 = t(E, D, F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
    eid = (np.sort(rng.integers(0, E, size=G)) if routing == "sorted"
           else np.full(G, 3))
    eid = torch.tensor(eid, dtype=torch.int32, device=cuda)
    before = gf.grouped_ffn_cuda.launches
    got = gf.grouped_ffn(xt, eid, w1, w2)
    want = gf.grouped_ffn_plain(xt, eid, w1, w2)
    torch.cuda.synchronize()
    assert gf.grouped_ffn_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == xt.shape
    assert bool((got[-1] == 0).all())
    diff = (got.float() - want.float()).abs()
    lim = 1e-4 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        lim = lim + 8e-3 * want.float().abs()
    assert bool((diff <= lim).all()), float(diff.max())


@pytest.mark.gpu
def test_grouped_ffn_refuses_what_it_does_not_take(cuda):
    xt = torch.zeros(2, 2, 8, device=cuda)
    eid = torch.zeros(2, dtype=torch.int32, device=cuda)
    w1, w2 = torch.zeros(2, 8, 16, device=cuda), torch.zeros(2, 16, 8,
                                                           device=cuda)
    with pytest.raises(TypeError, match="int32"):
        gf.grouped_ffn(xt, eid.long(), w1, w2)
    with pytest.raises(TypeError, match="dtypes"):
        gf.grouped_ffn(xt.half(), eid, w1.half(), w2.half())
    with pytest.raises(ValueError, match="w1"):
        gf.grouped_ffn(xt, eid, w2, w1)
    with pytest.raises(ValueError, match="contiguous"):
        gf.grouped_ffn(xt.transpose(0, 1), eid, w1, w2)
