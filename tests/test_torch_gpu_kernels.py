"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
elsewhere; this file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu

Flash decode: max abs error 1e-4 with f32 q (same stored values, f32
accumulation, only the summation order differs); with bf16 q one bf16
ulp of each output (rtol 8e-3) plus 1e-5 of f32 noise before rounding.
The kernel splits each lane's keys across CTAs, so the cases put the last
visible key on, before and after split and block boundaries, end prefix
pages inside a split, pad lanes to length 0, and rerun bit-identically.

Flash attention K1/K2 (and the ring and the trainer built on them): both
sides accumulate in f32 from the same values and only the order differs,
so o/l atol 1e-4, l rtol 1e-4, m atol 1e-5 with -inf exactly where the
plain version has it, and dq/dk/dv atol 1e-4 x max|plain| per tensor
(dk/dv sum over up to Tq * G rows).  The kernels' products are 3xTF32 on
the tensor cores; ``test_flash_attention_is_f32_accurate`` holds them to
these tolerances on inputs where one TF32 pass would fail them, and the
backward must give bit-identical results on two runs (no atomics).

Head dims: K1/K2 are built for 64, 128 and 256 and the wrappers
zero-pad every other head dim up to 256 (odd ones too); K3 takes the
head dim at run time inside buckets of 32/64/128/256.  Both are held to
the tolerances above at head dims they are not built for, and the entry
points that build ``LMConfig()``'s head dim 8 (the serve demos, a
composed train step) run on the card.

Grouped expert FFN K4: both sides accumulate in f32 from the same values
and only the order differs, so f32 max abs error 1e-4 x max|plain|; with
bf16 operands one bf16 ulp of each output (rtol 8e-3) on top of that.
Its blocks are expert-major, so the cases route tiles out of order, leave
experts without tiles, put every tile on one expert or more rows on one
expert than a chunk holds, and rerun bit-identically.  Trash tiles (id
-1, the tail of each expert-parallel owner's buffer): the forward, the
plan, the dgrad and the wgrad skip them and write zeros there, and
every other value equals the same layout's with the trash tiles on a
real expert; the expert-parallel MoE trainer on the card equals the CPU.
K4's bf16 backward (bf16 x bf16 wgmma, exact products, f32 sums) against
its bf16 plain version with the same rounding points: each gradient
within one bf16 ulp of its max |value| (the sums run in other orders
before the same roundings); two runs bit-identical.  K4's forward_gemm
route (the backward's plan, then two persistent wgmma GEMMs) at the
forward's tolerances above, with ``s`` within 1e-4 x max|s| of the f32
pre-activation: steady, trash-tile, stacked-peer, hostile, skewed,
padded and shuffled routings, both routes at one shape, bit-identical
reruns, one plan for a forward and its backward, and a refused launch
raising with nothing run in its place.
"""
import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import flash_attention as fa
from bluefog_tpu_torch.ops import flash_decode as fd
from bluefog_tpu_torch.ops import grouped_ffn as gf
from bluefog_tpu_torch.ops import ring
from bluefog_tpu_torch.serve import kv_cache as kv
from bluefog_tpu_torch.utils import metrics
import torch_plan_routings as routings


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
    cl = {"k": torch.zeros(2, 1, 16, 258, device=cuda),
          "v": torch.zeros(2, 1, 16, 258, device=cuda)}
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim 258"):
        fd.flash_attend_rows(torch.zeros(1, 1, 258, device=cuda), cl["k"],
                             cl["v"], idx, idx, block_k=8)
    cl64 = {"k": torch.zeros(2, 1, 16, 64, device=cuda, dtype=torch.half),
            "v": torch.zeros(2, 1, 16, 64, device=cuda, dtype=torch.half)}
    with pytest.raises(TypeError, match="page dtypes"):
        fd.flash_attend_rows(torch.zeros(1, 1, 64, device=cuda), cl64["k"],
                             cl64["v"], idx, idx, block_k=8)



def _decode_case(cuda, lens, Hkv=4, T=1, Dh=64, L=1024, block_k=128,
                 store="f32", qdt=torch.float32, plens=None, seed=0):
    """One flash_attend_chunk call against its plain version: lane i on
    slot i (lanes with length 0 on the last, trash row), 16 q heads."""
    rng = np.random.default_rng(seed)
    S, H = len(lens), 16
    rows = S + 2
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
    slots = torch.tensor([i if n else rows - 1 for i, n in enumerate(lens)],
                         dtype=torch.int32, device=cuda)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    pre = {}
    if plens is not None:
        pre = dict(prefix_slots=torch.full((S,), S, dtype=torch.int32,
                                           device=cuda),
                   prefix_lens=torch.tensor(plens, dtype=torch.int32,
                                            device=cuda))
    q = torch.from_numpy(rng.normal(size=(S, T, H, Dh)).astype(
        np.float32)).to(cuda, qdt)
    got = fd.flash_attend_chunk(q, cl, slots, lens_t, block_k=block_k,
                                **pre)
    want = kv.attend_chunk(q, cl, slots, lens_t, **pre)
    torch.cuda.synchronize()
    assert got.dtype == qdt and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    if qdt == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert bool((diff <= 8e-3 * want.float().abs() + 1e-5).all())
    return got, (q, cl, slots, lens_t, block_k, pre)


@pytest.mark.gpu
@pytest.mark.parametrize("store,qdt", [("f32", torch.float32),
                                       ("int8", torch.float32),
                                       ("bf16", torch.bfloat16)])
def test_flash_decode_split_boundaries(cuda, store, qdt):
    """8 lanes x 4 kv heads split every 64 keys: the last visible key
    ends a split (63, 127, 255), starts one (64, 128, 256: 128 and 256
    also start 128-key blocks), sits mid-split (31, 32, 50, 95) or is the
    page's last (1023)."""
    assert fd.split_plan(8, 4, 1024) == (16, 64)
    for lens in ([31, 32, 95, 50, 127, 128, 1023, 0],
                 [0, 63, 64, 1000, 255, 256, 3, 1]):
        _decode_case(cuda, lens, store=store, qdt=qdt)


@pytest.mark.gpu
@pytest.mark.parametrize("block_k", [16, 128])
def test_flash_decode_prefix_inside_a_split(cuda, block_k):
    """Prefix pages end inside a split: 16 and 128 keys into splits of 64
    (8 lanes x 4 kv heads) and of 224 keys (8 x 16)."""
    lens = [40, 300, 1023, 200, 700, 16, 0, 129]
    plens = [16, 128, 256, 128, 512, 0, 0, 128]
    plens = [p // block_k * block_k for p in plens]
    for Hkv in (4, 16):
        _decode_case(cuda, lens, Hkv=Hkv, block_k=block_k, plens=plens)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_lane_4_heads", "trash_lanes",
                                  "T4_gqa4", "dh128", "dh128_T3_gqa8_fp8"])
def test_flash_decode_shapes(cuda, case):
    if case == "one_lane_4_heads":      # 1 lane over 4 kv heads fills
        assert fd.split_plan(1, 4, 1024) == (32, 32)
        _decode_case(cuda, [700], Hkv=4)
    elif case == "trash_lanes":         # padded bucket lanes, length 0
        _decode_case(cuda, [500, 0, 0, 0, 900, 0, 0, 0], Hkv=16)
    elif case == "T4_gqa4":
        _decode_case(cuda, [0, 300, 1020, 64], Hkv=4, T=4)
    elif case == "dh128":
        _decode_case(cuda, [5, 512, 1023, 0], Hkv=16, Dh=128,
                     store="bf16")
    else:
        _decode_case(cuda, [77, 600, 0], Hkv=2, T=3, Dh=128, store="fp8",
                     L=512, block_k=64)


@pytest.mark.gpu
def test_flash_decode_reruns_are_bit_identical(cuda):
    lens = [1023, 700, 0, 31, 64, 900, 5, 512]
    got, (q, cl, slots, lens_t, block_k, pre) = _decode_case(
        cuda, lens, Hkv=16, T=2)
    for _ in range(3):
        again = fd.flash_attend_chunk(q, cl, slots, lens_t,
                                      block_k=block_k, **pre)
        assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("T,Hkv,store,qdt", [
    (65, 16, "f32", torch.float32),       # T*G 65: a one-row second tile
    (128, 16, "int8", torch.float32),
    (32, 4, "f32", torch.float32),        # GQA 4: T*G 128
    (64, 2, "fp8", torch.float32),        # GQA 8: T*G 512
    (256, 16, "bf16", torch.bfloat16),
    (512, 16, "f32", torch.float32),      # the chunked prefill's largest
])
def test_flash_decode_beyond_64_rows(cuda, T, Hkv, store, qdt):
    """T*G past one 64-row tile in one call (one launch): ragged lengths
    with a length-0 lane on the trash row and lanes attached to a prefix
    row, against the plain version; reruns bit-identical."""
    lens = [0, 256, 1024 - T, 300]
    plens = [0, 256, 128, 256]
    before = fd.flash_decode_cuda.launches
    got, (q, cl, slots, lens_t, block_k, pre) = _decode_case(
        cuda, lens, Hkv=Hkv, T=T, store=store, qdt=qdt, plens=plens)
    assert fd.flash_decode_cuda.launches == before + 1
    assert fd.row_tiles(T * 16 // Hkv) == -(-T * 16 // Hkv // 64)
    for _ in range(2):
        again = fd.flash_attend_chunk(q, cl, slots, lens_t,
                                      block_k=block_k, **pre)
        assert torch.equal(again, got)

def _qkv(rng, B, Tq, Tk, H, Hkv, D, dtype, device):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dtype)
    return t(B, Tq, H, D), t(B, Tk, Hkv, D), t(B, Tk, Hkv, D)


def _close_grad(got, want):
    lim = 1e-4 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= lim


def _m_err(m, wm):
    """max |m - wm| over the rows where the plain m is finite, after
    checking that both are -inf on the same rows."""
    assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
    fin = ~torch.isneginf(wm)
    zero = torch.zeros_like(m)
    return float((torch.where(fin, m, zero) - torch.where(fin, wm, zero))
                 .abs().max())


def _close_partial(got, want):
    """K1's tolerances: m atol 1e-5, l rtol 1e-4, o/l atol 1e-4."""
    (o, l, m), (wo, wl, wm) = got, want
    assert _m_err(m, wm) <= 1e-5
    assert bool(((l - wl).abs() <= 1e-4 * wl.abs()).all())
    den = torch.where(wl == 0, torch.ones_like(wl), wl)[..., None]
    assert float((o / den - wo / den).abs().max()) <= 1e-4


def _lse(want):
    _, wl, wm = want
    den = torch.where(wl == 0, torch.ones_like(wl), wl)
    return torch.where(wl == 0, torch.full_like(wl, float("-inf")),
                       wm + torch.log(den))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,causal,qoff,koff,window", [
    (2, 100, 77, 4, 4, 64, False, 0, 0, 0),
    (1, 130, 130, 8, 2, 128, True, 0, 0, 0),
    (2, 64, 192, 4, 1, 64, True, 192, 64, 0),
    (1, 96, 96, 4, 4, 64, True, 0, 96, 0),          # every row masked
    (1, 200, 200, 4, 2, 64, True, 0, 0, 50),
    (2, 1, 1, 4, 4, 64, False, 0, 0, 0),            # one row, one key
    (1, 7, 7, 4, 2, 64, True, 0, 0, 0),
    (1, 7, 100, 4, 1, 64, True, 93, 0, 0),
    (1, 100, 7, 4, 4, 128, False, 0, 0, 0),
    (1, 100, 100, 4, 4, 128, True, 0, 0, 0),
    (1, 130, 130, 16, 2, 128, True, 0, 0, 0),       # D 128, G 8
    (1, 200, 200, 4, 2, 64, True, 0, 0, 5),         # window < one tile
    (1, 150, 150, 4, 4, 64, True, 3, 0, 0),         # diagonal mid-fragment
    (1, 150, 160, 4, 2, 128, True, 0, 5, 0)])
def test_flash_attention_kernels_match_plain(cuda, dtype, B, Tq, Tk, H, Hkv,
                                             D, causal, qoff, koff, window):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, B, Tq, Tk, H, Hkv, D, dtype, cuda)
    kw = dict(causal=causal, scale=D ** -0.5, window=window)
    before = (fa.fwd_launches, fa.bwd_launches)
    got = fa.attention_block_partial(q, k, v, qoff, koff, **kw)
    want = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
    torch.cuda.synchronize()
    _close_partial(got, want)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    lse = _lse(want)
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
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_flash_attention_backward_is_deterministic(cuda, dtype, D):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 200, 200, 8, 2, D, dtype, cuda)
    kw = dict(causal=True, scale=D ** -0.5)
    lse = _lse(fa.attention_block_partial_plain(q, k, v, **kw))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    delta = torch.from_numpy(rng.normal(size=q.shape[:3]).astype(
        np.float32)).to(cuda)
    first = fa.attention_block_backward(q, k, v, do, lse, delta, **kw)
    second = fa.attention_block_backward(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _tf32(x):
    """x rounded to TF32 (10-bit mantissa, to nearest, ties away), as one
    tensor-core pass would see it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.gpu
def test_flash_attention_is_f32_accurate(cuda):
    """N(0, 4) entries over 2048 keys: one TF32 pass moves m by more than
    its 1e-5 tolerance, so passing here needs f32-accurate products."""
    rng = np.random.default_rng(5)
    B, Tq, Tk, H, D = 1, 256, 2048, 4, 64

    def t(*shape):
        return torch.from_numpy((2.0 * rng.normal(size=shape)).astype(
            np.float32)).to(cuda)

    q, k, v = t(B, Tq, H, D), t(B, Tk, H, D), t(B, Tk, H, D)
    kw = dict(causal=True, scale=D ** -0.5, window=0)
    want = fa.attention_block_partial_plain(q, k, v, Tk - Tq, 0, **kw)
    one_pass = fa.attention_block_partial_plain(
        _tf32(q * D ** -0.5), _tf32(k), v, Tk - Tq, 0, causal=True)
    assert _m_err(one_pass[2], want[2]) > 1e-5      # the test has teeth
    got = fa.attention_block_partial(q, k, v, Tk - Tq, 0, **kw)
    torch.cuda.synchronize()
    _close_partial(got, want)
    do = t(B, Tq, H, D)
    lse = _lse(want)
    delta = (do * want[0] / want[1][..., None]).sum(-1)
    got = fa.attention_block_backward(q, k, v, do, lse, delta, Tk - Tq, 0,
                                      **kw)
    wgrads = fa.attention_block_backward_plain(q, k, v, do, lse, delta,
                                               Tk - Tq, 0, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, wgrads):
        _close_grad(g, w)


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 258, device=cuda)
    with pytest.raises(ValueError, match="head_dim 258"):
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
@pytest.mark.parametrize("n,Hkv,Tl", [(4, 4, 64), (4, 2, 130), (8, 4, 32),
                                      (1, 4, 64)])
def test_zigzag_ring_through_the_kernels_matches_plain(cuda, n, Hkv, Tl):
    """The zigzag ring through K1/K2: n + 1 launches each way, forward
    and q/k/v grads against its plain path (online softmax, autograd) at
    the tolerances of the ring above."""
    rng = np.random.default_rng(n * Tl + Hkv)
    B, H, D = 2, 4, 64

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda).requires_grad_()

    q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    before = (fa.fwd_launches, fa.bwd_launches)
    out = ring.ring_attention(q, k, v, causal=True, layout="zigzag")
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert (fa.fwd_launches - before[0], fa.bwd_launches - before[1]) == \
        (n + 1, n + 1)
    want = ring._plain_zigzag(q, k, v, D ** -0.5)
    wgrads = torch.autograd.grad(want, (q, k, v), g)
    assert float((out - want).detach().abs().max()) <= 1e-4
    for a, b in zip(grads, wgrads):
        _close_grad(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("sp_mode,layout,kv", [
    ("ring", "contiguous", 2), ("ring", "zigzag", 2),
    ("ulysses", "contiguous", None)])
def test_ring_lm_step_runs_on_the_card(cuda, sp_mode, layout, kv):
    """One long-context training step of ``RingTransformerLM`` (4 ranks,
    rope, head_dim 64) through the kernels, against the same step with
    attention through the K1/K2 plain versions: loss rtol 1e-5, grads
    atol 1e-4 x max|g|; K1/K2 launch layers x (n (n + 1) / 2, n + 1 or 1)
    times."""
    from unittest import mock
    from bluefog_tpu_torch.models.transformer import (RingTransformerLM,
                                                      lm_loss)
    from bluefog_tpu_torch.tools import long_context as lc
    n, Tl, layers = 4, 128, 2
    model = RingTransformerLM(
        vocab_size=512, num_layers=layers, num_heads=4, num_kv_heads=kv,
        d_model=256, max_seq_len=n * Tl, axis="rank", dtype=torch.float32,
        sp_mode=sp_mode, sp_layout=layout, rope=True,
        use_pallas=True).reset_parameters(1).to(cuda)
    zig = layout == "zigzag"
    order = ring.zigzag_order(n, n * Tl) if zig else np.arange(n * Tl)
    seq, tgts = lc.copy_batch(np.random.default_rng(0), n * Tl, 8, 512,
                              order)
    toks, tgts = lc.stack_ranks(seq, n, cuda), lc.stack_ranks(tgts, n, cuda)
    pos = lc.rank_positions(n, Tl, zig, cuda)

    def grads():
        model.zero_grad(set_to_none=True)
        per_rank = lm_loss(model(toks, positions=pos), tgts)
        per_rank.sum().backward()
        return (float(per_rank.detach().mean()),
                {k: p.grad.clone() for k, p in model.named_parameters()})

    before = (fa.fwd_launches, fa.bwd_launches)
    loss, got = grads()
    per = {"contiguous": n * (n + 1) // 2, "zigzag": n + 1}.get(
        layout if sp_mode == "ring" else "", 1)
    assert (fa.fwd_launches - before[0], fa.bwd_launches - before[1]) == \
        (layers * per, layers * per)
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        wloss, want = grads()
    assert np.isfinite(loss) and abs(loss - wloss) <= 1e-5 * abs(wloss)
    for name, w in want.items():
        _close_grad(got[name], w)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, 2])
def test_single_rank_lm_attends_through_the_kernels(cuda, kv):
    """``RingTransformerLM(axis=None)`` with the default ``use_pallas``:
    on the card every layer attends through K1/K2 (one launch each way a
    layer); logits and grads against the same weights on the CPU, where
    the model attends through ``dense_attention``: logits atol 1e-4,
    grads atol 1e-4 x max|g|."""
    from bluefog_tpu_torch.models.transformer import (RingTransformerLM,
                                                      lm_loss)
    T, layers = 256, 2
    kw = dict(vocab_size=512, num_layers=layers, num_heads=4,
              num_kv_heads=kv, d_model=256, max_seq_len=T,
              dtype=torch.float32, rope=True)
    gpu = RingTransformerLM(**kw).reset_parameters(2).to(cuda)
    cpu = RingTransformerLM(**kw).reset_parameters(2)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 512, size=(2, T)))
    tgts = torch.from_numpy(rng.integers(0, 512, size=(2, T)))

    def run(model, dev):
        model.zero_grad(set_to_none=True)
        logits = model(toks.to(dev))
        lm_loss(logits, tgts.to(dev)).sum().backward()
        return logits.detach().cpu(), {
            k: p.grad.cpu() for k, p in model.named_parameters()}

    before = (fa.fwd_launches, fa.bwd_launches)
    logits, got = run(gpu, cuda)
    torch.cuda.synchronize()
    assert (fa.fwd_launches - before[0], fa.bwd_launches - before[1]) == \
        (layers, layers)
    wlogits, want = run(cpu, "cpu")
    assert float((logits - wlogits).abs().max()) <= 1e-4
    for name, w in want.items():
        _close_grad(got[name], w)


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


def _k4_case(cuda, eid, tile, D=256, F=512, E=8, dtype=torch.float32,
             seed=0):
    """K4 on tiles routed by ``eid`` (any order) against its plain
    version; returns the kernel's output and its inputs."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda, dtype)

    G = len(eid)
    xt = t(G, tile, D)
    w1, w2 = t(E, D, F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
    eid = torch.tensor(eid, dtype=torch.int32, device=cuda)
    got = gf.grouped_ffn(xt, eid, w1, w2)
    want = gf.grouped_ffn_plain(xt, eid, w1, w2)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == xt.shape
    diff = (got.float() - want.float()).abs()
    lim = 1e-4 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        lim = lim + 8e-3 * want.float().abs()
    assert bool((diff <= lim).all()), float(diff.max())
    return got, (xt, eid, w1, w2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "unsorted", "interleaved", "expert_without_tiles", "one_expert",
    "G1", "tile1", "tile16", "rows_past_a_chunk_16",
    "rows_past_a_chunk_64", "cols_32", "cols_64"])
def test_grouped_ffn_expert_major_cases(cuda, dtype, case):
    rng = np.random.default_rng(5)
    tile, eid, F = 2, None, 512
    if case == "unsorted":
        eid = rng.permutation(np.arange(12) % 8)
    elif case == "interleaved":
        eid = np.array([3, 1, 3, 0, 1, 3, 7, 0, 3, 1, 7, 3])
    elif case == "expert_without_tiles":     # experts 2 and 5 have none
        eid = np.array([0, 0, 1, 3, 4, 4, 6, 7, 7, 7])
    elif case == "one_expert":
        eid = np.full(12, 6)
    elif case == "G1":
        eid = np.array([4])
    elif case == "tile1":
        tile, eid = 1, rng.integers(0, 8, 16)
    elif case == "tile16":
        tile, eid = 16, np.sort(rng.integers(0, 8, 6))
    elif case == "rows_past_a_chunk_16":     # 60 rows of expert 2, MR 16
        eid = np.array([2] * 30 + [0, 1, 3, 4, 5, 6, 7] * 2)
        assert gf.ffn_plan(len(eid), tile, 8, 256, 512)[:2] == (16, 1)
    elif case == "rows_past_a_chunk_64":     # 400 rows of expert 5, MR 64
        tile, eid = 8, np.array([5] * 50 + list(range(8)) * 2)
        assert gf.ffn_plan(len(eid), tile, 8, 256, 512)[:2] == (64, 2)
    else:                                    # wider up-projection blocks
        F = 2048 if case == "cols_32" else 4096
        eid = np.sort(rng.integers(0, 8, 12))
        assert gf.ffn_plan(12, tile, 8, 256, F)[2] == int(case[-2:])
    _k4_case(cuda, [int(e) for e in eid], tile, F=F, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_reruns_are_bit_identical(cuda, dtype):
    eid = [0, 0, 1, 2, 2, 2, 3, 5, 6, 6, 7, 7] * 3
    got, args = _k4_case(cuda, eid, 4, D=512, F=1024, dtype=dtype)
    for _ in range(3):
        assert torch.equal(gf.grouped_ffn(*args), got)


# -- K4's backward: the dgrad and wgrad kernels ---------------------------


def _k4_grad_case(cuda, eid, tile, D, F, E, seed=0, peers=None,
                  splits=None):
    """K4's forward and backward through the kernels on tiles routed by
    ``eid`` against the per-expert plain version under autograd: out,
    dxt, dw1, dw2 within 1e-4 x max|plain| each (f32 products summed in
    another order, the weight gradients over up to every row).  With
    ``peers`` the weights are a layer slice ``[:, 1]`` of stacked
    ``[peers, 2, E / peers, ...]`` tensors (ids over every peer's
    experts); ``splits`` forces the wgrad's split count.  Returns the
    kernel's out and grads and the inputs."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda)

    G = len(eid)
    xt = t(G, tile, D)
    if peers is None:
        w1, w2 = t(E, D, F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
        v1, v2 = w1, w2
    else:
        e = E // peers
        w1 = t(peers, 2, e, D, F, scale=D ** -0.5)
        w2 = t(peers, 2, e, F, D, scale=F ** -0.5)
        v1, v2 = w1[:, 1], w2[:, 1]
    g = t(G, tile, D)
    eid = torch.tensor(eid, dtype=torch.int32, device=cuda)

    def run(fn, wg=None):
        x, a, b = (z.detach().requires_grad_() for z in (xt, v1, v2))
        out = fn(x, eid, a, b)
        return (out.detach(),) + torch.autograd.grad(out, (x, a, b), g)

    got = run(gf.grouped_ffn)
    if splits is not None:                   # the wgrad alone, split
        s = torch.einsum("gtd,gdf->gtf", xt, v1.reshape(-1, D, F)[
            eid.long()])
        dxt, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid, v1, v2, s)
        dw1, dw2 = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid, E,
                                             splits=splits)
        got = got[:2] + (dw1.view(v1.shape), dw2.view(v2.shape))
    want = run(gf.grouped_ffn_plain_by_expert)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dxt", "dw1", "dw2"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1e-30), (name, err)
        assert bool(torch.isfinite(a).all()), name
    return got, (xt, eid, v1, v2, g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "sorted", "unsorted", "tile1", "tile16", "hostile", "padded_widths",
    "peers", "splits", "wide", "one_tile", "skewed", "shuffled_hostile"])
def test_grouped_ffn_backward_matches_plain(cuda, case):
    rng = np.random.default_rng(9)
    tile, D, F, E, kw = 4, 128, 256, 8, {}
    eid = np.sort(rng.integers(0, E, 24))
    if case == "unsorted":
        eid = rng.permutation(eid)
    elif case == "tile1":
        tile, eid = 1, rng.integers(0, E, 40)
    elif case == "tile16":
        tile, eid = 16, np.sort(rng.integers(0, E, 9))
    elif case == "hostile":
        # every row on expert 6 but one tile of expert 1 (fewer rows than
        # a wgrad stage); the other experts hold nothing: exact zeros
        tile, eid = 2, np.array([1] + [6] * 300)
    elif case == "padded_widths":
        D, F = 36, 100
    elif case == "peers":
        E, kw = 16, {"peers": 4}
        eid = np.sort(rng.integers(0, E, 30))
    elif case == "splits":                   # 2 experts, 4096 rows
        tile, D, F, E = 8, 64, 64, 2
        eid = np.sort(rng.integers(0, E, 512))
        # one dw tile an expert: the plan splits each expert's rows
        plan = gf.backward_plan_plain(torch.tensor(eid, dtype=torch.int32),
                                      tile, E, D, F)
        assert len(plan["parts"]) > E and int(plan["slots"]) > 0
    elif case == "wide":                     # D 1024, F 2048, 2 row chunks
        tile, D, F = 8, 1024, 2048
        eid = np.sort(rng.integers(0, E, 64))
    elif case == "one_tile":                 # G 1: one row block, one part
        tile, eid = 4, np.array([3])
    elif case == "skewed":                   # Zipf-like expert sizes
        tile, D, F = 8, 256, 512
        w = 1.0 / np.arange(1, E + 1) ** 1.2
        eid = np.sort(rng.choice(E, 96, p=w / w.sum()))
    elif case == "shuffled_hostile":         # a hot expert in many runs
        tile, eid = 2, rng.permutation(np.array([1] * 5 + [6] * 200))
    got, (xt, eid_t, w1, w2, g) = _k4_grad_case(
        cuda, [int(e) for e in eid], tile, D, F, E, **kw)
    if case in ("hostile", "shuffled_hostile", "one_tile"):
        empty = [e for e in range(E) if e not in set(eid.tolist())]
        assert bool((got[2][empty] == 0).all())
        assert bool((got[3][empty] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_grouped_ffn_wgrad_splits_agree(cuda, splits):
    """The wgrad with every expert's rows forced into ``splits`` parts
    (each a stretch of the expert's rows, summed in part order by a
    second launch) within the tolerance of the plain version; one expert
    holds rows past several parts, one none (exact zeros)."""
    eid = [0] * 3 + [2] * 200 + [3] * 5
    got, _ = _k4_grad_case(cuda, eid, 4, 64, 128, 4, splits=splits)
    assert bool((got[2][1] == 0).all()) and bool((got[3][1] == 0).all())
    parts = gf.backward_plan_plain(torch.tensor(eid, dtype=torch.int32), 4,
                                   4, 64, 128, splits=splits)["parts"]
    assert len(parts) == 2 + min(splits, 25)   # 800 rows of expert 2


@pytest.mark.gpu
def test_grouped_ffn_backward_is_deterministic_and_counted(cuda):
    eid = [0, 0, 1, 2, 2, 2, 3, 5, 6, 6, 7, 7] * 8
    got, (xt, eid_t, w1, w2, g) = _k4_grad_case(cuda, eid, 4, 256, 512, 8)
    before = (gf.grouped_ffn_cuda.launches, gf.grouped_ffn_dgrad_cuda.launches,
              gf.grouped_ffn_wgrad_cuda.launches,
              gf.backward_plan_cuda.launches)
    for _ in range(2):
        x, a, b = (z.detach().requires_grad_() for z in (xt, w1, w2))
        out = gf.grouped_ffn(x, eid_t, a, b)
        again = (out.detach(),) + torch.autograd.grad(out, (x, a, b), g)
        for p, q in zip(got, again):
            assert torch.equal(p, q)
    for splits in (1, 5):
        s = torch.einsum("gtd,gdf->gtf", xt, w1[eid_t.long()])
        _, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid_t, w1, w2, s)
        first = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid_t, 8,
                                          splits=splits)
        second = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid_t, 8,
                                           splits=splits)
        assert all(torch.equal(p, q) for p, q in zip(first, second))
    after = (gf.grouped_ffn_cuda.launches, gf.grouped_ffn_dgrad_cuda.launches,
             gf.grouped_ffn_wgrad_cuda.launches,
             gf.backward_plan_cuda.launches)
    # autograd: one plan for each backward's dgrad and wgrad; called
    # alone, each wrapper builds its own
    assert tuple(b - a for a, b in zip(before, after)) == (2, 4, 6, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("case", routings.CASES)
def test_backward_plan_kernel_matches_plain(cuda, case):
    """The plan built on the card equals its plain version list by list
    (every routing, stacked-peer ids over [0, P * E), forced splits)."""
    ids, tile, E, D, F, splits = routings.routing(case)
    eid = ids.to(cuda)
    before = gf.backward_plan_cuda.launches
    plan = gf.backward_plan_cuda(eid, tile, E, D, F, splits)
    got = gf.unpack_plan(plan)
    want = gf.backward_plan_plain(ids, tile, E, D, F, splits)
    assert gf.backward_plan_cuda.launches == before + 1
    assert plan.slots >= int(want["slots"])
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.gpu
def test_backward_plan_stays_in_its_room(cuda):
    """A plan launched with less room than its routing needs (one row
    block, one part, no scratch slot against 33, 4 and 3) writes no list
    entry past its room, sets its fault word, and ``unpack_plan`` refuses
    it (the GEMMs, which trap on that word, are not run here)."""
    ids, tile, E, D, F, _ = routings.routing("hostile")
    G, rb_max, p_max, slots = len(ids), 1, 1, 0
    off = gf._plan_layout(G, E, rb_max, p_max)
    buf = torch.full((off["total"] + 64,), -7, dtype=torch.int32,
                     device=cuda)
    err = gf.build().bf_grouped_ffn_backward_plan(
        ids.to(cuda).data_ptr(), buf.data_ptr(), G, tile, E, D, F,
        gf.WGRAD_TARGET, gf._MIN_PART, 0, rb_max, p_max, slots,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    host = buf.cpu()
    want = gf.backward_plan_plain(ids, tile, E, D, F)
    assert (len(want["row_blocks"]), len(want["parts"]),
            int(want["slots"])) == (33, 4, 3)
    assert int(host[off["fault"]]) == 1
    assert bool((host[off["total"]:] == -7).all())

    def rows(name, n, width):
        return host[off[name]:off[name] + n * width].reshape(n, width)

    # the lists after the row blocks' and the parts' room are intact
    assert torch.equal(rows("row_blocks", 1, 3), want["row_blocks"][:1])
    assert torch.equal(rows("parts", 1, 4), want["parts"][:1])
    assert torch.equal(rows("part_sums", len(want["part_sums"]), 3),
                       want["part_sums"])
    plan = gf.BackwardPlan(buf, G, tile, E, D, F, rb_max, p_max, slots)
    with pytest.raises(RuntimeError, match="outgrew its room"):
        gf.unpack_plan(plan)


def _ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _k4_bf16_case(cuda, eid, tile, D, F, E, peers=None, splits=None,
                  seed=16):
    """K4 under autograd on bf16 operands (forward kernel, plan, dgrad,
    wgrad) against the bf16 plain version with the same rounding points,
    :func:`grouped_ffn_backward_plain_by_expert`, on the same ``s`` (the
    f32 pre-activation, recomputed by expert): each gradient within one
    bf16 ulp of its max |value| (both sum in f32, in other orders, and
    round at the same points), the output within the forward's bf16
    tolerance.  ``splits`` runs the wgrad alone with that many parts an
    expert.  Returns the kernel's ``(out, dxt, dw1, dw2)`` and inputs."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda).to(bf)

    G = len(eid)
    xt, g = t(G, tile, D), t(G, tile, D)
    if peers is None:
        w1, w2 = t(E, D, F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
        v1, v2 = w1, w2
    else:
        e = E // peers
        w1 = t(peers, 2, e, D, F, scale=D ** -0.5)
        w2 = t(peers, 2, e, F, D, scale=F ** -0.5)
        v1, v2 = w1[:, 1], w2[:, 1]
    eid_t = torch.tensor(eid, dtype=torch.int32, device=cuda)
    x, a, b = (z.detach().requires_grad_() for z in (xt, v1, v2))
    out = gf.grouped_ffn(x, eid_t, a, b)
    got = (out.detach(),) + torch.autograd.grad(out, (x, a, b), g)
    W1 = v1.reshape(-1, D, F)
    s = torch.zeros((G, tile, F), dtype=torch.float32, device=cuda)
    for gi, e_ in enumerate(eid):
        if e_ >= 0:
            s[gi] = xt[gi].float() @ W1[e_].float()
    if splits is not None:
        dxt, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid_t, v1, v2, s)
        dw1, dw2 = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid_t, E,
                                             splits=splits)
        got = got[:2] + (dw1.view(v1.shape), dw2.view(v2.shape))
    want = (gf.grouped_ffn_plain_by_expert(xt, eid_t, v1, v2),) + \
        gf.grouped_ffn_backward_plain_by_expert(xt, eid_t, v1, v2, s, g)
    torch.cuda.synchronize()
    for name, p, q in zip(("out", "dxt", "dw1", "dw2"), got, want):
        assert p.shape == q.shape and p.dtype == bf, name
        p, q = p.float(), q.float()
        top = float(q.abs().max())
        if name == "out":
            assert bool(((p - q).abs() <= 8e-3 * q.abs() + 1e-4 * top)
                        .all()), name
        else:
            err = float((p - q).abs().max())
            assert err <= _ulp(top), (name, err, top)
        assert bool(torch.isfinite(p).all()), name
    return got, (xt, eid_t, v1, v2, g, s)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "steady", "hostile", "skewed", "trash_tiles", "peers", "splits",
    "padded_widths", "tile1"])
def test_grouped_ffn_backward_bf16_matches_plain(cuda, case):
    """The bf16 backward (backward_gemm16) against the bf16 plain
    version: steady sorted routing at D 1024 x F 2048, a hostile routing
    (one tile on one expert, the rest on another, the others empty: exact
    zeros), Zipf-skewed expert sizes, two expert-parallel owners' trash
    tiles (zero rows of dxt, no rows in any expert), stacked-peer weights
    read in place, forced wgrad splits, widths that are not multiples of
    64 (and of 8: padded by the wrapper), one-row tiles out of order."""
    rng = np.random.default_rng(10)
    kw = {}
    if case == "steady":
        eid, tile, D, F, E = np.sort(rng.integers(0, 8, 256)), 8, 1024, \
            2048, 8
    elif case == "hostile":
        eid, tile, D, F, E = np.array([1] + [6] * 300), 2, 128, 256, 8
    elif case == "skewed":
        w = 1.0 / np.arange(1, 17) ** 1.2
        eid, tile, D, F, E = np.sort(rng.choice(16, 192, p=w / w.sum())), \
            8, 256, 512, 16
    elif case == "trash_tiles":
        ids, tile, E, D, F, _ = routings.routing("trash_tiles")
        eid = ids.numpy()
    elif case == "peers":
        eid, tile, D, F, E = np.sort(rng.integers(0, 16, 60)), 8, 256, \
            512, 16
        kw = {"peers": 4}
    elif case == "splits":
        eid, tile, D, F, E = [0] * 3 + [2] * 200 + [3] * 5, 4, 64, 128, 4
        kw = {"splits": 3}
    elif case == "padded_widths":
        eid, tile, D, F, E = np.sort(rng.integers(0, 4, 30)), 4, 36, 100, 4
    else:
        eid, tile, D, F, E = rng.integers(0, 6, 90), 1, 72, 136, 6
    eid = [int(e) for e in eid]
    got, _ = _k4_bf16_case(cuda, eid, tile, D, F, E, **kw)
    named = set(eid)
    empty = [e for e in range(E) if e not in named]
    if empty and "peers" not in kw:
        assert not bool(got[2][empty].any()) and \
            not bool(got[3][empty].any())
    if case == "trash_tiles":
        dead = [i for i, e in enumerate(eid) if e < 0]
        assert not bool(got[0][dead].any()) and not bool(got[1][dead].any())


@pytest.mark.gpu
def test_grouped_ffn_backward_bf16_is_deterministic_and_counted(cuda):
    """Two bf16 autograd round trips are bit-identical; each launches the
    forward once and the plan, dgrad and wgrad once; forced splits rerun
    bit-identically too."""
    eid = [0, 0, 1, 2, 2, 2, 3, 5, 6, 6, 7, 7] * 8
    got, (xt, eid_t, w1, w2, g, s) = _k4_bf16_case(cuda, eid, 8, 256, 512,
                                                   8)
    before = (gf.grouped_ffn_cuda.launches,
              gf.backward_plan_cuda.launches,
              gf.grouped_ffn_dgrad_cuda.launches,
              gf.grouped_ffn_wgrad_cuda.launches)
    for _ in range(2):
        x, a, b = (z.detach().requires_grad_() for z in (xt, w1, w2))
        out = gf.grouped_ffn(x, eid_t, a, b)
        again = (out.detach(),) + torch.autograd.grad(out, (x, a, b), g)
        for p, q in zip(got, again):
            assert p.dtype == torch.bfloat16 and torch.equal(p, q)
    after = (gf.grouped_ffn_cuda.launches,
             gf.backward_plan_cuda.launches,
             gf.grouped_ffn_dgrad_cuda.launches,
             gf.grouped_ffn_wgrad_cuda.launches)
    assert tuple(q - p for p, q in zip(before, after)) == (2, 2, 2, 2)
    _, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid_t, w1, w2, s)
    first = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid_t, 8, splits=5)
    second = gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid_t, 8, splits=5)
    assert all(torch.equal(p, q) for p, q in zip(first, second))


# -- K4's forward on the routing plan (the forward_gemm route) -----------


def _k4_route_case(cuda, eid, tile, D, F, E, dtype, peers=None, seed=23,
                   route="forward_gemm"):
    """K4's forward on ``route`` (``_forward_cuda``, ``s`` kept) against
    the per-expert plain version: out within 1e-4 x max|plain| (f32: both
    f32 accurate, sums in other orders; bf16: plus one bf16 ulp of each
    output, 8e-3 x |plain|), ``s`` within 1e-4 x max|s| of the f32
    pre-activation on every live row, trash rows of out exactly 0.  With
    ``peers`` the weights are a layer slice ``[:, 1]`` of stacked ``[peers,
    2, E / peers, ...]`` tensors.  Returns ``(out, s, plan)`` and the
    inputs."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda).to(dtype)

    G = len(eid)
    xt = t(G, tile, D)
    if peers is None:
        v1, v2 = t(E, D, F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
    else:
        e = E // peers
        v1 = t(peers, 2, e, D, F, scale=D ** -0.5)[:, 1]
        v2 = t(peers, 2, e, F, D, scale=F ** -0.5)[:, 1]
    eid_t = torch.tensor(eid, dtype=torch.int32, device=cuda)
    out, s, plan = gf._forward_cuda(*gf._padded(xt, eid_t, v1, v2),
                                    keep_s=True, route=route)
    out, s = out[..., :D], s[..., :F]
    want = gf.grouped_ffn_plain_by_expert(xt, eid_t, v1, v2)
    s_want = torch.zeros((G, tile, F), dtype=torch.float32, device=cuda)
    W1 = v1.reshape(-1, D, F)
    for gi, e_ in enumerate(eid):
        if e_ >= 0:
            s_want[gi] = xt[gi].float() @ W1[e_].float()
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == xt.shape
    diff = (out.float() - want.float()).abs()
    lim = 1e-4 * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        lim = lim + 8e-3 * want.float().abs()
    assert bool((diff <= lim).all()), float(diff.max())
    live = eid_t >= 0
    assert float((s[live] - s_want[live]).abs().max()) <= 1e-4 * float(
        s_want.abs().max())
    assert not bool(out[~live].any())
    return (out, s, plan), (xt, eid_t, v1, v2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "steady", "trash_tiles", "peers", "hostile", "skewed", "padded_widths",
    "shuffled", "one_tile"])
def test_grouped_ffn_forward_gemm_matches_plain(cuda, dtype, case):
    """The forward_gemm route (the plan, then forward_gemm /
    forward_gemm16) against the per-expert plain version: the steady
    tick's proportions scaled down (sorted routing, 256 rows an expert,
    D 256, F 512: several row blocks an expert, 4 column tiles up), two
    expert-parallel owners' trash tiles, stacked-peer weights read in
    place, every row but one tile on one expert (the rest empty),
    Zipf-skewed expert sizes, widths the wrapper pads (D 36, F 100), a
    shuffled tile order (many runs an expert), one tile."""
    rng = np.random.default_rng(11)
    kw = {}
    tile, D, F, E = 8, 256, 512, 8
    if case == "steady":
        eid = np.sort(rng.integers(0, E, 256))
    elif case == "trash_tiles":
        ids, tile, E, D, F, _ = routings.routing("trash_tiles")
        eid = ids.numpy()
    elif case == "peers":
        E, kw = 16, {"peers": 4}
        eid = np.sort(rng.integers(0, E, 300))
    elif case == "hostile":
        eid = np.array([1] + [6] * 200)
    elif case == "skewed":
        w = 1.0 / np.arange(1, E + 1) ** 1.2
        eid = np.sort(rng.choice(E, 300, p=w / w.sum()))
    elif case == "padded_widths":
        D, F = 36, 100
        eid = np.sort(rng.integers(0, E, 160))
    elif case == "shuffled":
        eid = rng.integers(0, E, 200)
    else:
        eid = np.array([3])
    _k4_route_case(cuda, [int(e) for e in eid], tile, D, F, E, dtype, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_routes_agree_and_rerun_bit_identical(cuda, dtype):
    """At one shape (an even share of 160 rows an expert), the shapes'
    route is forward_gemm; expert_rows forced at the same shape agrees
    with it within the tolerances; each route reruns bit-identically (no
    atomics on data: the plan's item counter only hands out tiles)."""
    eid = [int(e) for e in np.sort(np.random.default_rng(3).integers(
        0, 8, 160))]
    assert gf.ffn_route(160, 8, 8) == "forward_gemm"
    (out, s, plan), args = _k4_route_case(cuda, eid, 8, 256, 512, 8, dtype)
    assert plan is not None
    (rows_out, rows_s, no_plan), _ = _k4_route_case(
        cuda, eid, 8, 256, 512, 8, dtype, route="expert_rows")
    assert no_plan is None
    lim = 2e-4 * float(rows_out.float().abs().max())
    if dtype == torch.bfloat16:
        lim = lim + 8e-3 * rows_out.float().abs()
    assert bool(((out.float() - rows_out.float()).abs() <= lim).all())
    for route, first in (("forward_gemm", out), ("expert_rows", rows_out)):
        for _ in range(2):
            again = gf._forward_cuda(*args, keep_s=False, route=route)[0]
            assert torch.equal(again, first), route


@pytest.mark.gpu
def test_grouped_ffn_forward_gemm_shares_its_plan_under_autograd(cuda):
    """A trained call at a forward_gemm shape launches one plan for the
    forward and its backward (the backward takes the forward's), the
    forward's two GEMMs once, the dgrad and the wgrad once; out, dxt,
    dw1, dw2 within 1e-4 x max|plain| of the per-expert plain version
    under autograd."""
    eid = [int(e) for e in np.sort(np.random.default_rng(4).integers(
        0, 8, 160))]
    assert gf.ffn_route(160, 8, 8) == "forward_gemm"
    counters = ((gf.grouped_ffn_cuda, "launches"),
                (gf.grouped_ffn_cuda, "gemm_launches"),
                (gf.backward_plan_cuda, "launches"),
                (gf.grouped_ffn_dgrad_cuda, "launches"),
                (gf.grouped_ffn_wgrad_cuda, "launches"))
    before = [getattr(o, a) for o, a in counters]
    _k4_grad_case(cuda, eid, 8, 128, 256, 8)
    after = [getattr(o, a) for o, a in counters]
    assert [q - p for p, q in zip(before, after)] == [1, 1, 1, 1, 1]


@pytest.mark.gpu
def test_grouped_ffn_forward_gemm_failure_raises(cuda, monkeypatch):
    """A refused forward_gemm launch (the library's -3: no TMA encoder)
    raises; nothing falls back to expert_rows or the plain version, and
    no launch is counted.  An unknown route is refused by name."""
    lib = gf.build()
    calls = []

    class Refusing:
        def __getattr__(self, name):
            if name == "bf_grouped_ffn":
                calls.append(name)
            return getattr(lib, name)

        @staticmethod
        def bf_grouped_ffn_gemm(*args):
            return -3

    eid = torch.tensor(np.sort(np.random.default_rng(5).integers(
        0, 8, 160)), dtype=torch.int32, device=cuda)
    xt = torch.randn(160, 8, 64, device=cuda)
    w1, w2 = torch.randn(8, 64, 128, device=cuda), torch.randn(
        8, 128, 64, device=cuda)
    before = (gf.grouped_ffn_cuda.launches, gf.grouped_ffn_cuda.gemm_launches)
    monkeypatch.setattr(gf, "build", lambda: Refusing())
    with pytest.raises(RuntimeError, match="forward_gemm.*error -3"):
        gf.grouped_ffn(xt, eid, w1, w2)
    assert not calls
    assert (gf.grouped_ffn_cuda.launches,
            gf.grouped_ffn_cuda.gemm_launches) == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="route 'xla'"):
        gf._forward_cuda(xt, eid, w1, w2, keep_s=False, route="xla")


# -- every even head dim up to 128 ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 16, 32, 40, 96])
@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,causal,qoff,koff", [
    (2, 100, 77, 4, 4, False, 0, 0),
    (1, 130, 130, 8, 2, True, 0, 0),                # GQA 4, causal
    (2, 64, 192, 4, 1, True, 192, 64)])             # GQA 4, offsets
def test_flash_attention_other_head_dims(cuda, D, B, Tq, Tk, H, Hkv,
                                         causal, qoff, koff):
    """K1/K2 at head dims they are not built for: the wrappers pad to 64
    or 128; tolerances as for the built ones."""
    rng = np.random.default_rng(D)
    q, k, v = _qkv(rng, B, Tq, Tk, H, Hkv, D, torch.float32, cuda)
    kw = dict(causal=causal, scale=D ** -0.5)
    before = (fa.fwd_launches, fa.bwd_launches)
    got = fa.attention_block_partial(q, k, v, qoff, koff, **kw)
    want = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == q.shape
    _close_partial(got, want)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    lse = _lse(want)
    delta = (do * want[0] / torch.where(want[1] == 0, torch.ones_like(
        want[1]), want[1])[..., None]).sum(-1)
    got = fa.attention_block_backward(q, k, v, do, lse, delta, qoff, koff,
                                      **kw)
    want = fa.attention_block_backward_plain(q, k, v, do, lse, delta, qoff,
                                             koff, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_grad(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [7, 130, 192, 256])
@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,causal,qoff,koff", [
    (2, 100, 77, 8, 2, False, 0, 0),                # GQA 4, ragged
    (1, 130, 130, 8, 2, True, 0, 0),                # GQA 4, causal
    (1, 64, 200, 8, 2, True, 136, 0)])              # GQA 4, offsets
def test_flash_attention_wide_and_odd_head_dims(cuda, dtype, D, B, Tq, Tk,
                                                H, Hkv, causal, qoff,
                                                koff):
    """K1/K2 at D 256 (built: 32-row tiles, two column halves) and at
    head dims padded to 128 or 256 (130, 192) or to 64 (an odd 7), f32
    and bf16: the tolerances of the built head dims, one launch each, and
    a bit-identical backward on a rerun."""
    rng = np.random.default_rng(D)
    q, k, v = _qkv(rng, B, Tq, Tk, H, Hkv, D, dtype, cuda)
    kw = dict(causal=causal, scale=D ** -0.5)
    before = (fa.fwd_launches, fa.bwd_launches)
    got = fa.attention_block_partial(q, k, v, qoff, koff, **kw)
    want = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == q.shape
    _close_partial(got, want)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        cuda)
    lse = _lse(want)
    delta = (do * want[0] / torch.where(want[1] == 0, torch.ones_like(
        want[1]), want[1])[..., None]).sum(-1)
    got = fa.attention_block_backward(q, k, v, do, lse, delta, qoff, koff,
                                      **kw)
    again = fa.attention_block_backward(q, k, v, do, lse, delta, qoff,
                                        koff, **kw)
    want = fa.attention_block_backward_plain(q, k, v, do, lse, delta, qoff,
                                             koff, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 2)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
        _close_grad(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["f32", "int8", "bf16", "fp8"])
@pytest.mark.parametrize("Dh", [8, 32, 40, 2, 7, 130, 256])
@pytest.mark.parametrize("lens,T,L", [
    ([5, 0, 700, 1023 - 1], 1, 1024),               # splits, trash lane
    ([0, 31, 33, 60], 2, 64)])                      # one split, T 2
def test_flash_decode_other_head_dims(cuda, store, Dh, lens, T, L):
    """K3 at head dims inside its 32/64/128/256 buckets, on the 16-byte
    staging path (f32 at Dh 8, int8 at Dh 32, every page type at Dh 256)
    and the value-by-value one (int8 at Dh 8, every page type at Dh 2 and
    at the odd Dh 7)."""
    _decode_case(cuda, lens, Hkv=4, T=T, Dh=Dh, L=L, block_k=min(128, L),
                 store=store, seed=Dh)


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["f32", "int8", "bf16", "fp8"])
def test_flash_decode_head_dim_256_at_the_row_cap(cuda, store):
    """Dh 256 at T x G = 64 (T 4 over one kv head of 16 q heads): the
    4-row groups and the largest shared-memory tile (231,936 bytes with
    int8 / e4m3 pages) of the kernel."""
    lib = fd.build()
    assert lib.bf_flash_decode_smem_bytes(64, 256, fd._PAGE_DTYPES[
        {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
         "fp8": torch.float8_e4m3fn}[store]]) <= fd._MAX_SMEM
    _decode_case(cuda, [0, 500, 1019], Hkv=1, T=4, Dh=256, store=store,
                 seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("sp,H,D", [(2, 8, 64), (4, 8, 8), (2, 4, 40)])
def test_ulysses_through_the_kernels_matches_plain(cuda, sp, H, D):
    """Ulysses over stacked sp peers (and two more peers folded in front):
    K1 in the forward, K2 in the backward, one launch each, against the
    plain online-softmax path with autograd."""
    from bluefog_tpu_torch.ops import ulysses as ul
    rng = np.random.default_rng(sp * H + D)
    shape = (2, sp, 2, 96 // sp, H, D)          # [peers, sp, B, Tl, H, D]

    def t():
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda).requires_grad_()

    q, k, v = t(), t(), t()
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    before = (fa.fwd_launches, fa.bwd_launches)
    out = ul.ulysses_attention(q, k, v, axis=1, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    with torch.no_grad():
        scattered = [ul._scatter_heads(x, 1) for x in (q, k, v)]
    qs, ks, vs = (ul._fold(x).detach().cpu().requires_grad_()
                  for x in scattered)
    plain = ul._plain_local_attention(qs, ks, vs, True, D ** -0.5)
    want = ul._gather_heads(plain.view(scattered[0].shape), 1)
    # the gather is the scatter's inverse: want's VJP of g is plain's of
    # the scattered g
    wgrads = torch.autograd.grad(plain, (qs, ks, vs),
                                 ul._fold(ul._scatter_heads(g, 1)).cpu())
    torch.cuda.synchronize()
    assert float((out.detach().cpu() - want.detach()).abs().max()) <= 1e-4
    for a, b in zip(grads, wgrads):
        _close_grad(ul._fold(ul._scatter_heads(a, 1)).cpu(), b)


_REPO = str(__import__("pathlib").Path(__file__).resolve().parents[1])


@pytest.mark.gpu
@pytest.mark.parametrize("moe", ["", "8x2"])
def test_serve_demo_runs_on_the_card(cuda, moe):
    """``python -m bluefog_tpu_torch.serve`` builds ``LMConfig(layers=4)``
    (head_dim 8) on the card; with ``BLUEFOG_SERVE_MOE`` the MoE LM."""
    import json
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    if moe:
        env["BLUEFOG_SERVE_MOE"] = moe
    p = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.serve",
                        "--requests", "4"], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert doc["completed"] == 4 and doc["tokens"] == 16
    assert doc["device"] == torch.cuda.get_device_name(0)


def _first_token_gap(model, tokens):
    with torch.inference_mode():
        lg = model(torch.tensor([tokens], device=model.embed.device))[0, -1]
    top = torch.topk(lg.float(), 2).values
    return float(top[0] - top[1])


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True])
def test_spec_and_prefix_streams_equal_plain_on_the_card(cuda, moe):
    """The serving fast path on the card at a small width: speculative
    decoding (k 3; dense at pp 2, a 2-layer draft; MoE at pp 1, the
    expert-mean draft) with prefix pages (16-token pages) gives the plain
    engine's streams (4 steps a call, no prefix pages), or diverges first
    where the cache-free forward's top-2 logit gap is below 1e-3 (the two
    paths attend through K3's chunk and row forms: the same values summed
    in another order).  K3 launches through both forms, K4 (MoE) too."""
    from unittest import mock
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    from bluefog_tpu_torch.parallel.compose import LMConfig, init_lm_params
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    if moe:
        cfg = MoELMConfig(vocab=256, d_model=64, heads=4, layers=2,
                          num_experts=4, top_k=2, dispatch="dropless",
                          group_tile=4)
        model, pp = init_moe_params(cfg, 1, device=cuda), 1
        extra = dict(moe_experts=4, moe_top_k=2)
    else:
        cfg = LMConfig(vocab=256, d_model=64, heads=4, layers=4)
        model, pp, extra = init_lm_params(cfg, 1, device=cuda), 2, {}
    base = dict(slots=4, max_len=128, batch_buckets=(1, 2, 4),
                prefill_buckets=(16, 32), decode_kernel="pallas",
                decode_block_k=16, **extra)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 16).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in (3, 9, 16, 1, 12)] + [[5, 7, 9]]

    def drain(eng):
        sched = Scheduler(eng)
        reqs = [sched.submit(p, max_new_tokens=12) for p in prompts]
        sched.drain()
        return sched, reqs

    fast = ServeEngine(cfg, model, ServeConfig(
        spec_decode=3, prefix_pages=2, prefix_page_tokens=16, **base),
        pp=pp, device=cuda)
    calls = {"rows": 0, "chunk": 0}

    def counting(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    before = (fd.flash_decode_cuda.launches, gf.grouped_ffn_cuda.launches)
    hits0 = metrics.counter("bluefog_serve_prefix_hits_total").total()
    with mock.patch.object(fd, "flash_attend_rows",
                           counting("rows", fd.flash_attend_rows)), \
            mock.patch.object(fd, "flash_attend_chunk",
                              counting("chunk", fd.flash_attend_chunk)):
        sched, got = drain(fast)
    torch.cuda.synchronize()
    assert fd.flash_decode_cuda.launches - before[0] == \
        calls["rows"] + calls["chunk"]
    assert calls["rows"] > 0 and calls["chunk"] > 0
    assert (gf.grouped_ffn_cuda.launches > before[1]) == moe
    assert metrics.counter("bluefog_serve_prefix_hits_total").total() \
        - hits0 == 4
    _, want = drain(ServeEngine(cfg, model, ServeConfig(
        decode_steps_per_call=4, **base), device=cuda))
    for a, b in zip(got, want):
        assert len(a.generated) == len(b.generated) == 12
        if a.generated != b.generated:
            i = next(j for j, (x, y) in enumerate(zip(a.generated,
                                                      b.generated)) if x != y)
            assert _first_token_gap(model, a.prompt + a.generated[:i]) < 1e-3


@pytest.mark.gpu
def test_default_lm_config_trains_on_the_card(cuda):
    """One step of ``make_lm_grad_fn(LMConfig())`` (head_dim 8) at dp 2 x
    pp 2 x tp 2 through the kernels, against the same step with attention
    through the K1/K2 plain versions: loss rtol 1e-5, grads atol 1e-4 x
    max|g|."""
    from unittest import mock
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig()
    m = compose.compose_parallelism(2, 2, 2, 1, device=cuda)
    grad_fn = compose.make_lm_grad_fn(cfg, m)
    params = compose.init_lm_train_params(cfg, m)
    toks = compose.make_lm_batch(cfg, m)
    before = (fa.fwd_launches, fa.bwd_launches)
    loss, grads = bfopt.stacked_grads(grad_fn, params, toks, m.slice_size)
    torch.cuda.synchronize()
    per_step = m.dp * (cfg.micro + m.pp - 1) * cfg.layers // m.pp
    assert (fa.fwd_launches - before[0], fa.bwd_launches - before[1]) == \
        (per_step, per_step)
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        wloss, wgrads = bfopt.stacked_grads(grad_fn, params, toks,
                                            m.slice_size)
    assert bool(torch.isfinite(loss).all())
    torch.testing.assert_close(loss, wloss, rtol=1e-5, atol=0)
    for group in ("blocks", "shared"):
        for k, w in wgrads[group].items():
            _close_grad(grads[group][k], w)
    step, strategy = compose.make_train_step(m, grad_fn, bfopt.adam(5e-3))
    state = bfopt.init_distributed(strategy, params)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss.mean()))
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_moe_grad_fn_on_the_card_matches_the_cpu(cuda):
    """One ``make_moe_grad_fn`` call (dropless top-2, 4 experts, group
    tile 4) at dp 2 x pp 2 x tp 2 on the card, through K1/K2, K4 and its
    backward pair, each launched dp x (micro + pp - 1) x layers / pp
    times, against the same call on the CPU (plain versions): loss rtol
    1e-5, grads atol 1e-4 x max|g|."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    cfg = moe_model.MoELMConfig(num_experts=4, top_k=2, dispatch="dropless",
                                group_tile=4)
    out = {}
    for dev in ("cpu", cuda):
        m = compose.compose_parallelism(2, 2, 2, 1, device=dev,
                                        num_experts=4)
        counters = (fa, "fwd_launches"), (fa, "bwd_launches"), \
            (gf.grouped_ffn_cuda, "launches"), \
            (gf.grouped_ffn_dgrad_cuda, "launches"), \
            (gf.grouped_ffn_wgrad_cuda, "launches")
        before = [getattr(o, a) for o, a in counters]
        out[str(dev)] = bfopt.stacked_grads(
            moe_model.make_moe_grad_fn(cfg, m),
            moe_model.init_moe_train_params(cfg, m),
            moe_model.make_moe_batch(cfg, m), m.slice_size)
        torch.cuda.synchronize()
        got = [getattr(o, a) - b for (o, a), b in zip(counters, before)]
        want = 0 if dev == "cpu" else \
            m.dp * (cfg.micro + m.pp - 1) * cfg.layers // m.pp
        assert got == [want] * 5, got
    (closs, cgrads), (kloss, kgrads) = out["cpu"], out["cuda"]
    torch.testing.assert_close(kloss.cpu(), closs, rtol=1e-5, atol=0)
    for group, leaves in cgrads.items():
        for k, w in leaves.items():
            _close_grad(kgrads[group][k].cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["fold_ep2", "fold_ep4", "all_trash_tail"])
def test_grouped_ffn_trash_tiles_match_plain(cuda, dtype, case):
    """Trash tiles (id -1) get zero output rows (their input rows are
    not zero here, so nothing but the skip makes them so); every live
    row equals the plain version's and the same layout's with the trash
    tiles clamped onto the owner's last expert, as ``tile_layout`` leaves
    them; the forward plan sized by the live rows launches once."""
    rng = np.random.default_rng(case.__len__())
    owners = {"fold_ep2": 2, "fold_ep4": 4, "all_trash_tail": 1}[case]
    el, tile, D, F = 2, 4, 256, 512
    ids, clamped = [], []
    for o in range(owners):
        live = np.sort(rng.integers(0, el, 6 if case != "all_trash_tail"
                                    else 1)) + o * el
        ids += list(live) + [-1] * 5
        clamped += list(live) + [o * el + el - 1] * 5
    _, (xt, eid, w1, w2) = _k4_case(cuda, ids, tile, D, F, owners * el,
                                    dtype=dtype)
    trash = eid < 0
    before = gf.grouped_ffn_cuda.launches
    got = gf.grouped_ffn(xt, eid, w1, w2, rows=int((~trash).sum()) * tile)
    torch.cuda.synchronize()
    assert gf.grouped_ffn_cuda.launches == before + 1
    assert bool((got[trash] == 0).all())
    xz = xt.clone()
    xz[trash] = 0                     # what the dispatch leaves there
    ref = gf.grouped_ffn(xz, torch.tensor(clamped, dtype=torch.int32,
                                          device=cuda), w1, w2)
    diff = (got[~trash].float() - ref[~trash].float()).abs()
    lim = 1e-4 * float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        lim = lim + 8e-3 * ref[~trash].float().abs()
    assert bool((diff <= lim).all()), float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fold_ep2", "fold_ep4"])
def test_grouped_ffn_backward_trash_tiles_match_plain(cuda, case):
    """K4's backward on a folded expert-parallel layout with trash tiles:
    out, dxt, dw1, dw2 against the per-expert plain version (which
    answers trash tiles with zeros), dxt exactly 0 on them, the device
    plan equal to its plain version, and the weight gradients equal to
    those of the same layout with the trash tiles clamped onto a real
    expert (zero rows of xt and g there, as in the trainer)."""
    owners = {"fold_ep2": 2, "fold_ep4": 4}[case]
    rng = np.random.default_rng(owners)
    el, tile, D, F = 2, 8, 128, 256
    ids, clamped = [], []
    for o in range(owners):
        live = np.sort(rng.integers(0, el, 20)) + o * el
        ids += list(live) + [-1] * 18
        clamped += list(live) + [o * el + el - 1] * 18
    E = owners * el
    got, (xt, eid, w1, w2, g) = _k4_grad_case(cuda, ids, tile, D, F, E)
    trash = eid < 0
    assert bool((got[0][trash] == 0).all())
    assert bool((got[1][trash] == 0).all())
    want = gf.backward_plan_plain(eid.cpu(), tile, E, D, F)
    plan = gf.unpack_plan(gf.backward_plan_cuda(eid, tile, E, D, F))
    for key, value in want.items():
        assert torch.equal(plan[key], value), key
    xz, gz = xt.clone(), g.clone()
    xz[trash], gz[trash] = 0, 0
    x, a, b = (z.detach().requires_grad_() for z in (xz, w1, w2))
    out = gf.grouped_ffn(x, torch.tensor(clamped, dtype=torch.int32,
                                         device=cuda), a, b)
    ref = torch.autograd.grad(out, (x, a, b), gz)
    for name, p, q in (("dxt", got[1][~trash], ref[0][~trash]),
                       ("dw1", got[2], ref[1]), ("dw2", got[3], ref[2])):
        err = float((p - q).abs().max())
        assert err <= 1e-4 * float(q.abs().max()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(dispatch="dropless"),
                                dict(dispatch="capacity"),
                                dict(dispatch="dropless",
                                     router_mode="expert_choice")])
def test_moe_grad_fn_ep2_on_the_card_matches_the_cpu(cuda, kw):
    """One ``make_moe_grad_fn`` call at dp 2 x tp 2 x ep 2 (top-2, 4
    experts, batch 4) on the card against the same call on the CPU: the
    dropless sublayer through K4 and its backward pair (one launch a
    tick and layer each, every tp and ep peer folded in), capacity
    dispatch and expert choice without K4; loss rtol 1e-5, grads atol
    1e-4 x max|g|."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    cfg = moe_model.MoELMConfig(num_experts=4, top_k=2, group_tile=4,
                                batch=4, **kw)
    out = {}
    for dev in ("cpu", cuda):
        m = compose.compose_parallelism(2, 1, 2, 1, 2, device=dev,
                                        num_experts=4)
        before = (gf.grouped_ffn_cuda.launches,
                  gf.grouped_ffn_dgrad_cuda.launches)
        out[str(dev)] = bfopt.stacked_grads(
            moe_model.make_moe_grad_fn(cfg, m),
            moe_model.init_moe_train_params(cfg, m),
            moe_model.make_moe_batch(cfg, m), m.slice_size)
        torch.cuda.synchronize()
        got = (gf.grouped_ffn_cuda.launches - before[0],
               gf.grouped_ffn_dgrad_cuda.launches - before[1])
        per_call = m.dp * cfg.micro * cfg.layers
        want = per_call if dev != "cpu" and kw == {"dispatch": "dropless"} \
            else 0
        assert got == (want, want), got
    (closs, cgrads), (kloss, kgrads) = out["cpu"], out["cuda"]
    torch.testing.assert_close(kloss.cpu(), closs, rtol=1e-5, atol=0)
    for group, leaves in cgrads.items():
        for k, w in leaves.items():
            _close_grad(kgrads[group][k].cpu(), w)


@pytest.mark.gpu
def test_moe_grad_fn_remat_on_the_card(cuda):
    """``make_moe_grad_fn(remat=True)`` on the card: K4's forward runs
    twice a tick (the recompute under ``torch.utils.checkpoint``), its
    backward pair once, and the grads equal the plain call's (atol 1e-4
    x max|g|; the recompute repeats the same launches)."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    cfg = moe_model.MoELMConfig(num_experts=4, top_k=2, dispatch="dropless",
                                group_tile=4)
    m = compose.compose_parallelism(2, 2, 2, 1, device=cuda, num_experts=4)
    params = moe_model.init_moe_train_params(cfg, m)
    toks = moe_model.make_moe_batch(cfg, m)
    per_call = m.dp * (cfg.micro + m.pp - 1) * cfg.layers // m.pp
    out = []
    for remat in (False, True):
        before = (gf.grouped_ffn_cuda.launches,
                  gf.grouped_ffn_dgrad_cuda.launches)
        out.append(bfopt.stacked_grads(
            moe_model.make_moe_grad_fn(cfg, m, remat=remat), params, toks,
            m.slice_size))
        torch.cuda.synchronize()
        assert (gf.grouped_ffn_cuda.launches - before[0],
                gf.grouped_ffn_dgrad_cuda.launches - before[1]) == \
            ((2 if remat else 1) * per_call, per_call)
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for group, leaves in out[0][1].items():
        for k, w in leaves.items():
            _close_grad(out[1][1][group][k], w)


# ---------------------------------------------------------------------------
# The carved serving engine: dp replicas x tp (x ep) peers on one card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("tile", [2, 4, 8])
def test_grouped_ffn_decode_tiles_with_trash_match_plain(cuda, tile):
    """K4 at the carved engine's decode tiles: 4 owners' buffers over
    stacked-peer weights ``[4, 2, D, F]``, the back half of each owner's
    tiles trash (id -1, input rows not zero here); every live row equals
    the plain version's, the trash rows are zeros, one launch with the
    plan sized by the live rows."""
    rng = np.random.default_rng(tile)
    P, el, per, D, F = 4, 2, 8, 256, 512
    ids = []
    for o in range(P):
        ids += sorted(int(i) + o * el for i in rng.integers(0, el, per // 2))
        ids += [-1] * (per // 2)
    xt = torch.from_numpy(rng.normal(size=(len(ids), tile, D)).astype(
        np.float32)).to(cuda)
    w1 = torch.from_numpy((rng.normal(size=(P, el, D, F)) * D ** -0.5)
                          .astype(np.float32)).to(cuda)
    w2 = torch.from_numpy((rng.normal(size=(P, el, F, D)) * F ** -0.5)
                          .astype(np.float32)).to(cuda)
    eid = torch.tensor(ids, dtype=torch.int32, device=cuda)
    trash = eid < 0
    before = gf.grouped_ffn_cuda.launches
    got = gf.grouped_ffn(xt, eid, w1, w2,
                         rows=int((~trash).sum()) * tile)
    want = gf.grouped_ffn_plain(xt, eid, w1, w2)
    torch.cuda.synchronize()
    assert gf.grouped_ffn_cuda.launches == before + 1
    assert bool((got[trash] == 0).all())
    diff = (got - want).abs()
    assert float(diff.max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["f32", "int8"])
def test_flash_decode_folded_replicas_stay_apart(cuda, store):
    """K3 over two replicas' caches folded into one (rows ``r * rows
    ..``, the carved engine's layout): replica 1's lanes, attached to its
    own prefix row or idle on its own trash row, give outputs bit for bit
    independent of replica 0's rows (filled with other values, large
    ones, between two launches), equal to the plain version's."""
    rng = np.random.default_rng(5)
    R, rows, Hkv, H, Lk, Dh = 2, 6, 4, 8, 128, 64   # 4 slots, prefix, trash
    cl = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=(R * rows, Hkv, Lk, Dh))
                             .astype(np.float32)).to(cuda)
        if store == "f32":
            cl[name] = x
        else:
            cl[name], sc = kv.quantize_rows(x, store)
            cl[name + "_scale"] = sc.contiguous()
    S = 4                                   # lanes a replica
    slots = np.array([[0, 1, 2, 5], [0, 2, 3, 5]]) + \
        np.arange(R)[:, None] * rows        # the last lane: trash row
    lens = np.array([[70, 33, 127, 0], [64, 90, 17, 0]])
    prows = np.array([[4, 5, 4, 5], [4, 4, 5, 5]]) + \
        np.arange(R)[:, None] * rows        # prefix row 4, trash row 5
    plens = np.array([[32, 0, 64, 0], [64, 32, 0, 0]])

    def t(a):
        return torch.tensor(a.reshape(-1), dtype=torch.int32, device=cuda)
    q = torch.from_numpy(rng.normal(size=(R * S, H, Dh)).astype(
        np.float32)).to(cuda)
    args = (t(slots), t(lens))
    kw = dict(k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"),
              prefix_slots=t(prows), prefix_lens=t(plens), block_k=32)
    first = fd.flash_attend_rows(q, cl["k"], cl["v"], *args, **kw)
    want = kv.attend_rows(q, cl["k"], cl["v"], *args,
                          **{k: v for k, v in kw.items() if k != "block_k"})
    for name in ("k", "v"):                 # replica 0's rows change
        cl[name][:rows] = (cl[name][:rows].float() * 3 + 5).to(
            cl[name].dtype)
    second = fd.flash_attend_rows(q, cl["k"], cl["v"], *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[S:], second[S:])
    assert not torch.equal(first[:S], second[:S])
    assert float((first - want).abs().max()) <= 1e-4


def _carved_params(moe, device):
    """Small carved params (JAX-equal draws through the loader), replica
    1 redrawn from another seed: dense dp 2 x pp 2 x tp 2, or MoE dp 2 x
    tp 2 x ep 2."""
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    if moe:
        cfg = moe_model.MoELMConfig(vocab=256, d_model=64, heads=4,
                                    layers=2, num_experts=8, top_k=2,
                                    dispatch="dropless", group_tile=4)
        m = compose.compose_parallelism(2, 1, 2, 1, 2, num_experts=8,
                                        device=device)
        params = moe_model.moe_params_from_jax(
            moe_model.init_moe_train_params(cfg, m, 2), cfg, m=m)
    else:
        cfg = compose.LMConfig(vocab=256, d_model=64, heads=4, layers=4)
        m = compose.compose_parallelism(2, 2, 2, device=device)
        params = compose.params_from_jax(
            compose.init_lm_train_params(cfg, m, 2), cfg, m=m)
    g = torch.Generator(device=device)
    g.manual_seed(9)
    with torch.no_grad():
        for _, w in params.tensors():
            w[1].normal_(0.0, 0.1, generator=g)
    return cfg, params


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True])
def test_carved_engine_on_the_card_matches_the_cpu(cuda, moe):
    """The carved engine (dense dp 2 x pp 2 x tp 2; MoE dp 2 x tp 2 x ep
    2) on the card against the same engine on the CPU: the same replica
    for every request and the same streams, or a first divergence where
    the replica's joined module has a top-2 logit gap below 1e-3 (K3 and
    K4 sum in another order than their plain versions); K3 launches
    layers x decode steps (one launch for both replicas and tp peers),
    K4 layers x (prefills + decode steps)."""
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    cfg, params = _carved_params(moe, "cpu")
    extra = dict(moe_experts=8, moe_top_k=2, moe_ep=2) if moe else {}
    scfg = ServeConfig(slots=4, max_len=128, batch_buckets=(1, 2, 4),
                       prefill_buckets=(16, 32), decode_steps_per_call=2,
                       decode_kernel="pallas", decode_block_k=16, **extra)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in (3, 9, 16, 30, 12, 5, 21, 8)]

    def drain(device):
        eng = ServeEngine(cfg, params, scfg, device=device)
        sched = Scheduler(eng)
        reqs = [sched.submit(p, max_new_tokens=10) for p in prompts]
        sched.drain()
        return sched, reqs

    before = (fd.flash_decode_cuda.launches, gf.grouped_ffn_cuda.launches)
    sched, got = drain(cuda)
    torch.cuda.synchronize()
    k3 = fd.flash_decode_cuda.launches - before[0]
    k4 = gf.grouped_ffn_cuda.launches - before[1]
    assert k3 == cfg.layers * sched.decode_steps
    assert k4 == (cfg.layers * (len(prompts) + sched.decode_steps)
                  if moe else 0)
    _, want = drain("cpu")
    models = [params.replica(r).to(cuda) for r in range(2)]
    assert {a.replica for a in got} == {0, 1}
    for a, b in zip(got, want):
        assert a.replica == b.replica
        assert len(a.generated) == len(b.generated) == 10
        if a.generated != b.generated:
            i = next(j for j, (x, y) in enumerate(zip(a.generated,
                                                      b.generated)) if x != y)
            assert _first_token_gap(models[a.replica],
                                    a.prompt + a.generated[:i]) < 1e-3
