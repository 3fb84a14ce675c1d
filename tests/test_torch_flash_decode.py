"""bluefog_tpu_torch.ops.flash_decode vs bluefog_tpu.ops.pallas_decode.

On the CPU the port's ``flash_attend_rows`` / ``flash_attend_chunk`` run
their plain version (gather the pages, then attend); the JAX entry points
run the Pallas kernel in interpret mode, as tests/test_pallas_decode.py
runs it.  Both must agree in f32 to 1e-5 across raw/int8/fp8 stores, GQA,
block-aligned prefix-page lanes, a zero-length lane and ``block_k`` 8 and
16 (the kernel's block-count invariance is what makes the plain
whole-cache version its oracle).  ``_block_k_for`` and
``_common_checks`` raise the same errors as the JAX ones.

The CUDA kernel itself runs only on the card: see
tests/test_torch_gpu_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.ops import pallas_decode as jpd
from bluefog_tpu.serve import kv_cache as jkv
from bluefog_tpu_torch.ops import flash_decode as tfd
from bluefog_tpu_torch.serve import kv_cache as tkv

ROWS, L, Dh, H, T = 6, 32, 8, 4, 3
SLOTS = np.array([5, 0, 2, 3], np.int32)
LENS = np.array([8, 0, 20, 27], np.int32)
PSLOTS = np.array([1, 1, 1, 1], np.int32)
PLENS = np.array([16, 0, 16, 0], np.int32)      # multiples of 8 and 16


def _pages(store, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(ROWS, Hkv, L, Dh)).astype(np.float32)
    v = rng.normal(size=(ROWS, Hkv, L, Dh)).astype(np.float32)
    jcl, tcl = {}, {}
    for name, x in (("k", k), ("v", v)):
        jq, js = jkv.quantize_rows(jnp.asarray(x), store)
        tq, ts = tkv.quantize_rows(torch.from_numpy(x), store)
        jcl[name], tcl[name] = jq, tq
        if js is not None:
            jcl[name + "_scale"], tcl[name + "_scale"] = js, ts
    return jcl, tcl


def _idx(prefix):
    j = dict(prefix_slots=jnp.asarray(PSLOTS), prefix_lens=jnp.asarray(
        PLENS)) if prefix else {}
    t = dict(prefix_slots=torch.from_numpy(PSLOTS),
             prefix_lens=torch.from_numpy(PLENS)) if prefix else {}
    return j, t


@pytest.mark.parametrize("block_k", [8, 16])
@pytest.mark.parametrize("store", ["raw", "int8", "fp8"])
def test_flash_attend_rows_matches_pallas(store, block_k):
    """GQA (4 q heads over 2 kv heads) with prefix-page lanes."""
    jcl, tcl = _pages(store, Hkv=2)
    pj, pt = _idx(prefix=True)
    q = np.random.default_rng(1).normal(size=(4, H, Dh)).astype(np.float32)
    want = jpd.flash_attend_rows(
        jnp.asarray(q), jcl["k"], jcl["v"], jnp.asarray(SLOTS),
        jnp.asarray(LENS), k_scale=jcl.get("k_scale"),
        v_scale=jcl.get("v_scale"), block_k=block_k, interpret=True, **pj)
    got = tfd.flash_attend_rows(
        torch.from_numpy(q), tcl["k"], tcl["v"], torch.from_numpy(SLOTS),
        torch.from_numpy(LENS), k_scale=tcl.get("k_scale"),
        v_scale=tcl.get("v_scale"), block_k=block_k, **pt)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("block_k", [8, 16])
@pytest.mark.parametrize("store,Hkv,prefix", [
    ("raw", 4, False), ("int8", 2, True), ("fp8", 1, False)])
def test_flash_attend_chunk_matches_pallas(store, Hkv, prefix, block_k):
    jcl, tcl = _pages(store, Hkv=Hkv, seed=2)
    pj, pt = _idx(prefix)
    q = np.random.default_rng(3).normal(size=(4, T, H, Dh)).astype(
        np.float32)
    want = jpd.flash_attend_chunk(jnp.asarray(q), jcl, jnp.asarray(SLOTS),
                                  jnp.asarray(LENS), block_k=block_k,
                                  interpret=True, **pj)
    got = tfd.flash_attend_chunk(torch.from_numpy(q), tcl,
                                 torch.from_numpy(SLOTS),
                                 torch.from_numpy(LENS), block_k=block_k,
                                 **pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bf16_q_keeps_its_dtype():
    _, tcl = _pages("raw", Hkv=2)
    q = torch.randn(4, H, Dh, generator=torch.Generator().manual_seed(0))
    out = tfd.flash_attend_rows(q.bfloat16(), tcl["k"], tcl["v"],
                                torch.from_numpy(SLOTS),
                                torch.from_numpy(LENS), block_k=8)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("block_k,match", [(24, "does not tile"),
                                           (4, "sublane"), (0, "tile")])
def test_block_k_for_same_errors(block_k, match):
    with pytest.raises(ValueError, match=match) as jerr:
        jpd._block_k_for(L, block_k)
    with pytest.raises(ValueError, match=match) as terr:
        tfd._block_k_for(L, block_k)
    assert str(terr.value) == str(jerr.value)
    assert tfd._block_k_for(L, 128) == jpd._block_k_for(L, 128) == L


def test_common_checks_same_errors():
    jcl, tcl = _pages("raw", Hkv=2)
    js, ts = jnp.asarray(SLOTS), torch.from_numpy(SLOTS)
    cases = [
        (3, Dh, {}, {}, "kv heads"),
        (H, 16, {}, {}, "head_dim"),
        (H, Dh, {"k_scale": 1}, {}, "come together"),
        (H, Dh, {}, {"prefix": 1}, "come together"),
    ]
    for heads, dh, extra, pre, match in cases:
        ps = (js, None) if pre else (None, None)
        pt = (ts, None) if pre else (None, None)
        with pytest.raises(ValueError, match=match) as jerr:
            jpd._common_checks(heads, dh, {**jcl, **extra}, js, js, *ps)
        with pytest.raises(ValueError, match=match) as terr:
            tfd._common_checks(heads, dh, {**tcl, **extra}, ts, ts, *pt)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="slots/lengths"):
        tfd._common_checks(H, Dh, tcl, ts, ts[:2], None, None)
    with pytest.raises(ValueError, match="one layer's pages"):
        tfd._common_checks(H, Dh, {"k": tcl["k"][0], "v": tcl["v"][0]},
                           ts, ts, None, None)
