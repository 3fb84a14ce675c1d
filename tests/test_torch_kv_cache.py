"""bluefog_tpu_torch.serve.kv_cache vs bluefog_tpu.serve.kv_cache.

* quantization: int8 and e4m3 payloads bit-identical (both sides round
  to nearest even from the same f32 quotient), amax scales to rtol 1e-6,
  including the all-zero and subnormal rows the ``_amax_scale`` floor
  exists for;
* the page writes (decode append, chunk append, prefill) land the same
  payloads and scales in the same places;
* the plain attention (``attend_rows`` / ``attend_chunk``, the oracle of
  the flash-decode kernel) agrees in f32 to 1e-5 across raw/int8/fp8
  stores, GQA and prefix-page lanes — only the summation order differs;
* cache shapes and the slot allocator match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.serve import kv_cache as jkv
from bluefog_tpu_torch.serve import kv_cache as tkv

STORES = ("raw", "int8", "fp8")


def _np(x):
    """torch or jax array -> numpy, fp8 as its raw bytes."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _rows(seed=0, shape=(6, 3, 16)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[0, 0] = 0.0                        # amax 0: scale 1, payload 0
    x[0, 1] = 1e-41                      # subnormal amax: floored scale
    x[1, 2] *= 1e4
    return x


@pytest.mark.parametrize("store", ["int8", "fp8"])
def test_quantize_rows_bit_identical(store):
    x = _rows()
    jq, js = jkv.quantize_rows(jnp.asarray(x), store)
    tq, ts = tkv.quantize_rows(torch.from_numpy(x), store)
    assert tq.dtype == tkv.store_dtype(store)
    np.testing.assert_array_equal(_np(tq), _np(jq))
    # XLA on the CPU flushes subnormals to zero, so JAX sees the subnormal
    # row's amax as 0 and rides scale 1; the port keeps the subnormal (as
    # the GPU does) and rides the floored scale.  Both store a zero row.
    tiny = np.finfo(np.float32).tiny
    assert float(ts[0, 1]) == tiny and float(np.asarray(js)[0, 1]) == 1.0
    assert not _np(tq)[0, 1].any()
    ts_cmp, js_cmp = ts.numpy().copy(), np.asarray(js).copy()
    ts_cmp[0, 1] = js_cmp[0, 1] = 1.0
    np.testing.assert_allclose(ts_cmp, js_cmp, rtol=1e-6, atol=0)
    back_j = np.asarray(jkv.dequantize_rows(jq, js, jnp.float32))
    back_t = tkv.dequantize_rows(tq, ts, torch.float32).numpy()
    np.testing.assert_allclose(back_t, back_j, rtol=1e-6, atol=0)


def test_raw_store_is_identity_and_unknown_store_refused():
    x = torch.from_numpy(_rows())
    q, s = tkv.quantize_rows(x, "raw")
    assert q is x and s is None
    with pytest.raises(ValueError, match="unknown KV store"):
        tkv.quantize_rows(x, "int4")
    with pytest.raises(ValueError, match="unknown KV store"):
        tkv.store_dtype("int4")


def test_cache_config_and_init_match_jax():
    for store in STORES:
        kw = dict(layers=2, slots=3, max_len=16, kv_heads=2, head_dim=8,
                  store=store)
        jc = jkv.KVCacheConfig(**kw)
        tc = tkv.KVCacheConfig(**kw)
        assert (tc.rows, tc.trash_slot, tc.quantized) == \
            (jc.rows, jc.trash_slot, jc.quantized)
        jcache, tcache = jkv.init_cache(jc), tkv.init_cache(tc, device="cpu")
        assert set(jcache) == set(tcache)
        for name in jcache:
            assert tuple(tcache[name].shape) == jcache[name].shape
            assert not tcache[name].float().any()
    with pytest.raises(ValueError, match="positive int"):
        tkv.KVCacheConfig(layers=0, slots=1, max_len=8, kv_heads=1,
                          head_dim=8)
    with pytest.raises(ValueError, match="prefix_slots"):
        tkv.KVCacheConfig(layers=1, slots=1, max_len=8, kv_heads=1,
                          head_dim=8, prefix_slots=-1)


def _layer(store, Hkv=2, rows=5, L=16, Dh=8, seed=3):
    """One layer's cache filled with quantized random rows, as a jax dict
    and a torch dict holding the same values."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(rows, Hkv, L, Dh)).astype(np.float32)
    v = rng.normal(size=(rows, Hkv, L, Dh)).astype(np.float32)
    jk, jks = jkv.quantize_rows(jnp.asarray(k), store)
    jv, jvs = jkv.quantize_rows(jnp.asarray(v), store)
    tk, tks = tkv.quantize_rows(torch.from_numpy(k), store)
    tv, tvs = tkv.quantize_rows(torch.from_numpy(v), store)
    jcl, tcl = {"k": jk, "v": jv}, {"k": tk.clone(), "v": tv.clone()}
    if jks is not None:
        jcl.update(k_scale=jks, v_scale=jvs)
        tcl.update(k_scale=tks.clone(), v_scale=tvs.clone())
    return jcl, tcl


def _assert_same_cache(tcl, jcl, skip_row=None):
    for name in jcl:
        t, j = _np(tcl[name]), _np(jcl[name])
        if skip_row is not None:
            t, j = np.delete(t, skip_row, 0), np.delete(j, skip_row, 0)
        if name.endswith("scale"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("store", STORES)
def test_page_writes_match_jax(store):
    """Decode append, chunk append and prefill write the same payloads and
    scales; lanes 2 and 3 both point at the trash row (4), which is left
    out of the comparison since the duplicate write's winner is
    unspecified."""
    rng = np.random.default_rng(5)
    jcl, tcl = _layer(store)
    slots = np.array([0, 3, 4, 4], np.int32)
    lens = np.array([2, 9, 0, 0], np.int32)
    kn = rng.normal(size=(4, 2, 8)).astype(np.float32)
    vn = rng.normal(size=(4, 2, 8)).astype(np.float32)
    jcl = jkv.layer_append(jcl, jnp.asarray(slots), jnp.asarray(lens),
                           jnp.asarray(kn), jnp.asarray(vn), store=store)
    tkv.layer_append(tcl, torch.from_numpy(slots), torch.from_numpy(lens),
                     torch.from_numpy(kn), torch.from_numpy(vn), store=store)
    _assert_same_cache(tcl, jcl, skip_row=4)

    kc = rng.normal(size=(4, 3, 2, 8)).astype(np.float32)
    vc = rng.normal(size=(4, 3, 2, 8)).astype(np.float32)
    jcl = jkv.layer_append_chunk(jcl, jnp.asarray(slots), jnp.asarray(lens),
                                 jnp.asarray(kc), jnp.asarray(vc),
                                 store=store)
    tkv.layer_append_chunk(tcl, torch.from_numpy(slots),
                           torch.from_numpy(lens), torch.from_numpy(kc),
                           torch.from_numpy(vc), store=store)
    _assert_same_cache(tcl, jcl, skip_row=4)

    kp = rng.normal(size=(8, 2, 8)).astype(np.float32)
    vp = rng.normal(size=(8, 2, 8)).astype(np.float32)
    jcl = jkv.layer_prefill(jcl, jnp.int32(1), jnp.asarray(kp),
                            jnp.asarray(vp), store=store)
    tkv.layer_prefill(tcl, 1, torch.from_numpy(kp), torch.from_numpy(vp),
                      store=store)
    _assert_same_cache(tcl, jcl, skip_row=4)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("Hkv", [1, 4])
@pytest.mark.parametrize("prefix", [False, True])
def test_attend_matches_jax(store, Hkv, prefix):
    """attend_rows and attend_chunk in f32, atol 1e-5."""
    H, Dh, T = 4, 8, 3
    jcl, tcl = _layer(store, Hkv=Hkv, seed=7)
    rng = np.random.default_rng(11)
    slots = np.array([0, 2, 3, 4], np.int32)
    lens = np.array([5, 0, 12, 0], np.int32)
    ps = np.array([1, 1, 1, 4], np.int32)
    pl = np.array([4, 0, 8, 0], np.int32)
    pj = dict(prefix_slots=jnp.asarray(ps), prefix_lens=jnp.asarray(pl)) \
        if prefix else {}
    pt = dict(prefix_slots=torch.from_numpy(ps),
              prefix_lens=torch.from_numpy(pl)) if prefix else {}
    sc = {k: v for k, v in jcl.items() if k.endswith("scale")}
    tsc = {k: v for k, v in tcl.items() if k.endswith("scale")}

    q = rng.normal(size=(4, H, Dh)).astype(np.float32)
    want = jkv.attend_rows(jnp.asarray(q), jcl["k"], jcl["v"],
                           jnp.asarray(slots), jnp.asarray(lens), **sc, **pj)
    got = tkv.attend_rows(torch.from_numpy(q), tcl["k"], tcl["v"],
                          torch.from_numpy(slots), torch.from_numpy(lens),
                          **tsc, **pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)

    qc = rng.normal(size=(4, T, H, Dh)).astype(np.float32)
    want = jkv.attend_chunk(jnp.asarray(qc), jcl, jnp.asarray(slots),
                            jnp.asarray(lens), **pj)
    got = tkv.attend_chunk(torch.from_numpy(qc), tcl,
                           torch.from_numpy(slots), torch.from_numpy(lens),
                           **pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_attend_head_mismatch_refused_like_jax():
    jcl, tcl = _layer("raw", Hkv=4)
    s = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="kv heads"):
        jkv.attend_rows(jnp.zeros((2, 6, 8)), jcl["k"], jcl["v"],
                        jnp.asarray(s), jnp.asarray(s))
    with pytest.raises(ValueError, match="kv heads"):
        tkv.attend_rows(torch.zeros(2, 6, 8), tcl["k"], tcl["v"],
                        torch.from_numpy(s), torch.from_numpy(s))


def test_slot_allocator_matches_jax():
    ja, ta = jkv.SlotAllocator(3), tkv.SlotAllocator(3)
    seq = []
    for a in (ja, ta):
        got = [a.alloc(), a.alloc(), a.alloc(), a.alloc()]
        a.free(1)
        got += [a.alloc(), a.in_use, a.occupancy]
        seq.append(got)
    assert seq[0] == seq[1] == [0, 1, 2, None, 1, 3, 1.0]
    with pytest.raises(ValueError, match="not allocated"):
        ta.free(7)
    with pytest.raises(ValueError, match=">= 1 slot"):
        tkv.SlotAllocator(0)
