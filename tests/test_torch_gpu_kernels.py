"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
elsewhere; this file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu

Flash decode: max abs error 1e-4 with f32 q (same stored values, f32
accumulation, only the summation order differs); with bf16 q one bf16
ulp of each output (rtol 8e-3) plus 1e-5 of f32 noise before rounding.
"""
import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import flash_decode as fd
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
