"""The port's long-context slice (zigzag ring, ``RingTransformerLM``, the
long-context trainer) vs the JAX package on the CPU.

JAX runs under ``shard_map`` on 4 of the virtual CPU devices of
``tests/conftest.py``; the port holds the same ranks stacked along dim 0.
Inputs are made from a seed with numpy and handed to both sides.

* ``zigzag_order`` / ``zigzag_inverse`` / ``zigzag_positions``,
  ``ring_pass`` and ``ring_allreduce`` equal to JAX's (exact);
* the stacked zigzag ``ring_attention`` forward and q/k/v gradients
  against JAX ``ring_attention(layout="zigzag")``, through the kernel
  path (the K1/K2 plain versions; JAX's Pallas in interpret mode, which
  needs ``check_vma=False``) and the plain path, at Hkv 4 and 2: atol
  1e-5; the kernel path launches K1 and K2 ``n + 1`` times a call;
* the zigzag contract errors, word for word;
* ``RingTransformerLM`` logits and every parameter's gradient against
  the flax model under ``shard_map``, weights carried by
  ``params_from_jax``: ring contiguous and zigzag, Ulysses, learned
  positions and rope, GQA, ``use_pallas`` on and off, the scanned tree:
  logits atol 1e-5, grads atol 1e-5 x max|g| per leaf;
* the decode path against the JAX decode on the same cache (f32, atol
  1e-5) and against the port's own full forward in float64 (1e-12, the
  oracle of ``tests/test_serve.py``);
* one step of ``tools/long_context.py`` against the JAX example's step
  (Adam over psum'd grads): loss and params rtol 1e-5; a 3-step run
  whose loss falls;
* the example's step as it ships (``check_vma=True`` without Pallas)
  counts the replicated params' gradient n times: its psum'd grads are
  n times the port's (1 time with ``check_vma=False``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu.ops import ring as jring
from bluefog_tpu_torch.ops import flash_attention as tfa
from bluefog_tpu_torch.ops import ring as tring
import torch_cpu_threads  # noqa: F401  (the worker's thread share)

N = 4


def _mesh(cpu_devices):
    return Mesh(np.array(cpu_devices[:N]), ("rank",))


def _stack(x, n=N):
    """[B, n*Tl, ...] -> [n, B, Tl, ...] (rank i holds block i)."""
    B, T = x.shape[:2]
    y = x.reshape((B, n, T // n) + x.shape[2:])
    return np.ascontiguousarray(np.moveaxis(y, 1, 0))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


# -- ring helpers ----------------------------------------------------------

@pytest.mark.parametrize("n,T", [(4, 16), (2, 8), (8, 32), (3, 12)])
def test_zigzag_permutations_and_positions_match_jax(n, T):
    np.testing.assert_array_equal(tring.zigzag_order(n, T),
                                  jring.zigzag_order(n, T))
    np.testing.assert_array_equal(tring.zigzag_inverse(n, T),
                                  jring.zigzag_inverse(n, T))
    C = T // (2 * n)
    every = tring.zigzag_positions(torch.arange(n), n, C)
    assert every.dtype == torch.int32 and every.shape == (n, 2 * C)
    for i in range(n):
        want = np.asarray(jring.zigzag_positions(i, n, C))
        np.testing.assert_array_equal(tring.zigzag_positions(i, n, C), want)
        np.testing.assert_array_equal(every[i], want)
    # the positions of the permuted sequence, rank by rank
    np.testing.assert_array_equal(every.reshape(-1),
                                  tring.zigzag_order(n, T))
    with pytest.raises(ValueError, match="not divisible by 2n"):
        tring.zigzag_order(n, T + 1)


@pytest.mark.parametrize("shift", [1, 3])
def test_ring_pass_and_allreduce_match_jax(cpu_devices, shift):
    x = np.random.default_rng(shift).normal(size=(N, 3, 5)).astype(
        np.float32)

    def f(xb):
        return (jring.ring_pass(xb, axis="rank", shift=shift),
                jring.ring_allreduce(xb, axis="rank"),
                jring.ring_allreduce(xb, axis="rank", average=True))

    fn = jax.jit(jax.shard_map(f, mesh=_mesh(cpu_devices),
                               in_specs=P("rank"), out_specs=(P("rank"),) * 3))
    want = [np.asarray(w).reshape(N, 3, 5) for w in fn(x.reshape(N * 3, 5))]
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tring.ring_pass(xt, shift=shift), want[0])
    _close(tring.ring_allreduce(xt), want[1], atol=1e-6)
    _close(tring.ring_allreduce(xt, average=True), want[2], atol=1e-6)


# -- the zigzag ring -------------------------------------------------------

@pytest.mark.parametrize("Hkv", [4, 2])
def test_zigzag_ring_attention_matches_jax(cpu_devices, Hkv):
    B, Tl, H, D = 1, 8, 4, 8
    rng = np.random.default_rng(Hkv)
    q = rng.normal(size=(B, N * Tl, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, N * Tl, Hkv, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=q.shape).astype(np.float32)
    spec = P(None, "rank")
    for use_pallas in (True, False):
        def f(qb, kb, vb, gb):
            def loss(a, b, c):
                out = jring.ring_attention(
                    a, b, c, axis="rank", causal=True, layout="zigzag",
                    use_pallas=use_pallas, pallas_block_q=4)
                return jnp.sum(out * gb), out
            (_, out), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(qb, kb, vb)
            return (out,) + grads

        fn = jax.jit(jax.shard_map(f, mesh=_mesh(cpu_devices),
                                   in_specs=(spec,) * 4,
                                   out_specs=(spec,) * 4,
                                   check_vma=not use_pallas))
        want = [_stack(np.asarray(x)) for x in fn(q, k, v, g)]
        tq, tk, tv = (torch.from_numpy(_stack(x)).requires_grad_()
                      for x in (q, k, v))
        before = (tfa.fwd_launches, tfa.bwd_launches)
        calls = []
        orig = (tfa.attention_block_partial, tfa.attention_block_backward)

        def counting(i):
            def fn_(*a, **kw):
                calls.append(i)
                return orig[i](*a, **kw)
            return fn_

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfa, "attention_block_partial", counting(0))
            mp.setattr(tfa, "attention_block_backward", counting(1))
            out = tring.ring_attention(tq, tk, tv, causal=True,
                                       layout="zigzag",
                                       use_pallas=use_pallas,
                                       pallas_block_q=4)
            grads = torch.autograd.grad(out, (tq, tk, tv),
                                        torch.from_numpy(_stack(g)))
        # the kernel path: n + 1 K1 calls and n + 1 K2 calls
        assert calls.count(0) == (N + 1 if use_pallas else 0)
        assert calls.count(1) == (N + 1 if use_pallas else 0)
        assert (tfa.fwd_launches, tfa.bwd_launches) == before  # CPU: plain
        for a, b in zip((out.detach(),) + grads, want):
            assert a.shape == b.shape
            _close(a.numpy(), b)


def test_zigzag_equals_contiguous_on_the_permuted_sequence():
    """The zigzag ring over the permuted sequence, un-permuted, is the
    contiguous ring over the original one (forward and grads)."""
    B, Tl, H, D = 2, 6, 4, 8
    rng = np.random.default_rng(11)
    T = N * Tl
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    order, inv = tring.zigzag_order(N, T), tring.zigzag_inverse(N, T)
    results = {}
    for layout, perm in (("contiguous", np.arange(T)), ("zigzag", order)):
        xs = [torch.from_numpy(_stack(x[:, perm])).requires_grad_()
              for x in (q, k, v)]
        out = tring.ring_attention(*xs, causal=True, layout=layout,
                                   use_pallas=True)
        grads = torch.autograd.grad(out, xs, torch.from_numpy(
            _stack(g[:, perm])))

        def unstack(t):
            a = t.detach().numpy()
            a = np.moveaxis(a, 0, 1).reshape((B, T) + a.shape[3:])
            return a[:, np.argsort(perm)]

        results[layout] = [unstack(t) for t in (out,) + grads]
    for a, b in zip(results["zigzag"], results["contiguous"]):
        _close(a, b)
    assert np.array_equal(order[inv], np.arange(T))


def test_zigzag_contracts():
    x = torch.zeros(2, 1, 4, 2, 8)
    with pytest.raises(ValueError, match="zigzag layout only pays for "
                                         "causal attention; use the "
                                         "contiguous layout for "
                                         "bidirectional"):
        tring.ring_attention(x, x, x, layout="zigzag")
    odd = torch.zeros(2, 1, 3, 2, 8)
    with pytest.raises(ValueError, match=r"zigzag needs an even per-device "
                                         r"block length \(two chunks per "
                                         r"device\)"):
        tring.ring_attention(odd, odd, odd, causal=True, layout="zigzag")
    with pytest.raises(ValueError, match=r"zigzag needs equal q/k/v block "
                                         r"lengths \(the chunk ids that "
                                         r"drive the visibility table "
                                         r"assume one shard layout\)"):
        tring.ring_attention(x, torch.zeros(2, 1, 6, 2, 8),
                             torch.zeros(2, 1, 6, 2, 8), causal=True,
                             layout="zigzag")
    with pytest.raises(ValueError, match=r"window is a contiguous-layout "
                                         r"feature \(the zigzag visibility "
                                         r"table assumes full causal "
                                         r"attention\)"):
        tring.ring_attention(x, x, x, causal=True, layout="zigzag",
                             window=2)
    with pytest.raises(ValueError, match="unknown layout 'striped'"):
        tring.ring_attention(x, x, x, causal=True, layout="striped")
    # the same texts as the JAX function's
    import inspect
    src = inspect.getsource(jring.ring_attention)
    for text in ("zigzag layout only pays for causal attention",
                 "zigzag needs an even per-device block length",
                 "zigzag needs equal q/k/v block lengths",
                 "window is a contiguous-layout feature"):
        assert text in src


def test_zigzag_pair_classes_cover_the_visible_chunk_pairs():
    """Every (q chunk, k chunk) pair the causal mask leaves visible is
    computed exactly once over the n steps (n + 1 launches), only step
    0's diagonal launch is causal, and the folds put each launch row back
    on its own q and k chunk, a q chunk taking ``q_hi x k_lo`` first and
    a k chunk last."""
    def seq(c):                                   # sequence chunk id
        return c if c < n else 2 * n - 1 - (c - n)

    for n in (1, 2, 3, 4, 8):
        seen, launches_total = [], 0
        for t in range(n):
            launches, q_folds, k_folds = tring._zigzag_plan(n, t)
            launches_total += len(launches)
            rows_of = []
            for causal, q0, rows, kp in launches:
                qs = [(q0 + r) if q0 + r < 2 * n else q0 + r - n
                      for r in range(rows)]
                ks = [c for a, b in kp for c in range(a, b)]
                assert len(ks) == rows
                assert causal == (t == 0 and rows == 2 * n)
                for qc, kc in zip(qs, ks):
                    assert kc % n == (qc % n - t) % n   # K/V of src at t
                    if not causal:                      # wholly visible
                        assert seq(qc) > seq(kc)
                    seen.append((qc, kc))
                rows_of.append((qs, ks))
            for folds, side in ((q_folds, 0), (k_folds, 1)):
                covered = []
                for j, r0, r1, c in folds:
                    assert rows_of[j][side][r0:r1] == list(range(c, c + r1
                                                                 - r0))
                    covered += [(j, r) for r in range(r0, r1)]
                assert sorted(covered) == [(j, r) for j, (qs, _) in
                                           enumerate(rows_of)
                                           for r in range(len(qs))]
                # the q_hi x k_lo pairs: first for a q chunk, last for a k
                order = [(rows_of[j][side][r], seq(rows_of[j][0][r]) >
                          seq(rows_of[j][1][r]) and rows_of[j][0][r] >= n
                          and rows_of[j][1][r] < n)
                         for j, r0, r1, _ in folds for r in range(r0, r1)]
                for chunk in {c for c, _ in order}:
                    kinds = [hl for c, hl in order if c == chunk]
                    if len(kinds) == 2:
                        assert kinds == ([True, False] if side == 0 else
                                         [False, True])
        assert launches_total == n + 1
        want = {(a, b) for a in range(2 * n) for b in range(2 * n)
                if seq(a) >= seq(b)}
        assert len(seen) == len(set(seen)) and set(seen) == want


# -- RingTransformerLM against the flax model -------------------------------

import optax  # noqa: E402

from bluefog_tpu.models.transformer import RingTransformerLM as JLM  # noqa
from bluefog_tpu.models.transformer import (  # noqa: E402
    init_decode_cache as jinit_cache)
from bluefog_tpu_torch.models import transformer as tmod  # noqa: E402
from bluefog_tpu_torch.tools import long_context as tlc  # noqa: E402

V, C, HEADS, TL = 16, 32, 4, 8


def _flat_grads(tree, layers):
    """The flax gradient tree as ``{port parameter name: array}``."""
    params = tree.get("params", tree)
    out = {name: np.asarray(params[m][leaf])
           for (m, leaf), name in tmod._TOP_LEAVES.items()}
    if "Embed_1" in params:
        out["pos_embed"] = np.asarray(params["Embed_1"]["embedding"])
    for i, sub in enumerate(tmod._block_trees(params, layers)):
        for (m, leaf), name in tmod._BLOCK_LEAVES.items():
            out[f"blocks.{i}.{name}"] = np.asarray(sub[m][leaf])
    return out


def _lm_pair(sp_mode="ring", sp_layout="contiguous", rope=False, kv=None,
             use_pallas=False, scan=False, remat=False, axis="rank",
             layers=1):
    kw = dict(vocab_size=V, num_layers=layers, num_heads=HEADS,
              num_kv_heads=kv, d_model=C, max_seq_len=N * TL, rope=rope,
              sp_mode=sp_mode, sp_layout=sp_layout, use_pallas=use_pallas,
              remat=remat)
    jlm = JLM(axis=None if axis is None else "rank", dtype=jnp.float32,
              scan_layers=scan, pallas_interpret=True if use_pallas else None,
              **kw)
    params = jax.jit(jlm.clone(axis=None).init)(
        jax.random.key(3), jnp.zeros((1, TL), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    tlm = tmod.RingTransformerLM(axis=axis, dtype=torch.float32, **kw)
    return jlm, params, tmod.params_from_jax(params, tlm)


LM_CASES = [
    # sp_mode, layout, rope, kv heads, use_pallas, scanned tree, remat
    # (two layers for the scanned tree, whose layers share one subtree)
    ("ring", "contiguous", False, None, False, False, False),
    ("ring", "contiguous", True, 2, True, False, False),
    ("ring", "zigzag", True, 2, True, False, False),
    ("ring", "zigzag", False, None, False, False, True),
    ("ulysses", "contiguous", True, None, True, False, False),
    ("ulysses", "contiguous", False, None, False, True, False),
    ("ring", "zigzag", True, None, False, True, False),
]


@pytest.mark.parametrize("case", LM_CASES)
def test_ring_lm_logits_and_grads_match_jax(cpu_devices, case):
    sp_mode, layout, rope, kv, use_pallas, scan, remat = case
    layers = 2 if scan else 1
    jlm, params, tlm = _lm_pair(sp_mode, layout, rope, kv, use_pallas, scan,
                                remat, layers=layers)
    B, T = 2, N * TL
    rng = np.random.default_rng(7)
    toks = rng.integers(0, V, (B, T)).astype(np.int32)
    tgts = rng.integers(-1, V, (B, T)).astype(np.int32)
    zig = layout == "zigzag"

    def f(p, tb, gb):
        idx = lax.axis_index("rank")
        pos = (jring.zigzag_positions(idx, N, TL // 2) if zig
               else idx * TL + jnp.arange(TL))

        def loss_fn(p):
            logits = jlm.apply(p, tb, positions=pos)
            mask = (gb >= 0).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.maximum(gb, 0))
            return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0), \
                logits
        (loss, logits), grads = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(p)
        grads = jax.tree.map(lambda g: lax.psum(g, "rank"), grads)
        return logits, grads, lax.pmean(loss, "rank")

    # check_vma off: with it on, the gradient of the replicated params
    # arrives already summed over the ring, and the psum would count it
    # n times
    fn = jax.jit(jax.shard_map(
        f, mesh=_mesh(cpu_devices),
        in_specs=(P(), P(None, "rank"), P(None, "rank")),
        out_specs=(P(None, "rank"), P(), P()), check_vma=False))
    jlogits, jgrads, jloss = fn(params, toks, tgts)
    pos = tlc.rank_positions(N, TL, zig, "cpu")
    logits = tlm(torch.from_numpy(_stack(toks)).long(), positions=pos)
    per_rank = tmod.lm_loss(logits, torch.from_numpy(_stack(tgts)))
    per_rank.sum().backward()
    _close(logits.detach().numpy(), _stack(np.asarray(jlogits)))
    np.testing.assert_allclose(float(per_rank.detach().mean()), float(jloss),
                               rtol=1e-5)
    want = _flat_grads(jgrads, layers)
    got = dict(tlm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        assert g.shape == w.shape, name
        _close(g, w, atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("use_pallas,kv", [(False, None), (True, 2)])
def test_single_rank_lm_matches_jax(use_pallas, kv):
    """``axis=None``: one plain [B, T] sequence through dense attention
    or local flash attention (the K1/K2 plain versions)."""
    jlm, params, tlm = _lm_pair(rope=True, kv=kv, use_pallas=use_pallas,
                                axis=None)
    toks = np.random.default_rng(2).integers(0, V, (2, 12)).astype(np.int32)

    def loss_fn(p):
        return jnp.sum(jlm.apply(p, toks) ** 2) * 1e-3
    jgrads = jax.jit(jax.grad(loss_fn))(params)
    want = np.asarray(jax.jit(jlm.apply)(params, toks))
    logits = tlm(torch.from_numpy(toks).long())
    (logits.pow(2).sum() * 1e-3).backward()
    _close(logits.detach().numpy(), want)
    got = dict(tlm.named_parameters())
    for name, w in _flat_grads(jgrads, 1).items():
        _close(got[name].grad.numpy(), w,
               atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


def test_lm_contracts():
    _, params, tlm = _lm_pair()
    with pytest.raises(ValueError, match="stacked ranks want tokens"):
        tlm(torch.zeros(2, 8, dtype=torch.long))
    for bad, text in ((dict(sp_mode="pipe"), "unknown sp_mode 'pipe'"),
                      (dict(sp_layout="striped"),
                       "unknown sp_layout 'striped'"),
                      (dict(sp_mode="ulysses", sp_layout="zigzag"),
                       "sp_layout='zigzag' is a ring-attention layout")):
        m = tmod.RingTransformerLM(vocab_size=V, num_layers=1,
                                   num_heads=HEADS, d_model=C, axis="rank",
                                   dtype=torch.float32, **bad)
        with pytest.raises(ValueError, match=text):
            m(torch.zeros(N, 1, TL, dtype=torch.long))
    with pytest.raises(ValueError, match="rope needs the tokens' global"):
        tmod.RingTransformerLM(vocab_size=V, num_layers=1, num_heads=HEADS,
                               d_model=C, rope=True).blocks[0](
            torch.zeros(1, 4, C, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="not a multiple of num_kv_heads"):
        tmod.RingTransformerBlock(C, 4, 3)
    with pytest.raises(ValueError, match="single-device path"):
        tlm(torch.zeros(N, 1, TL, dtype=torch.long),
            cache=tmod.init_decode_cache(tlm, 1, 16))
    single = tmod.RingTransformerLM(vocab_size=V, num_layers=2,
                                    num_heads=HEADS, d_model=C,
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="cache has 1 layer entries"):
        single(torch.zeros(1, 1, dtype=torch.long),
               cache=tmod.init_decode_cache(single, 1, 8)[:1])
    with pytest.raises(ValueError, match="no RingTransformerBlock_"):
        tmod.params_from_jax({"params": {}}, single)
    with pytest.raises(ValueError, match="the param tree has 1 blocks, "
                                         "the model 2"):
        tmod.params_from_jax(params, single)
    bad = jax.tree.map(lambda x: x, params)
    bad["params"]["Dense_0"] = {"kernel": np.zeros((C, V + 1), np.float32)}
    with pytest.raises(ValueError, match="param of shape"):
        tmod.params_from_jax(bad, tlm)


@pytest.mark.parametrize("kv", [None, 2])
def test_decode_path_matches_jax_and_the_full_forward(kv):
    """Prefill 4 tokens as one cached chunk, then decode token by token:
    the logits against the JAX decode on the same cache (f32, atol 1e-5),
    and in float64 against the port's own full forward (1e-12)."""
    jlm, params, tlm = _lm_pair(rope=True, kv=kv, axis=None, layers=2)
    B, T, L = 2, 12, 32
    toks = np.random.default_rng(0).integers(0, V, (B, T)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jcache = jinit_cache(jlm, B, L, jnp.float32)
    cache = tmod.init_decode_cache(tlm, B, L, torch.float32, device="cpu")
    assert cache[0]["k"].shape == (B, L, kv or HEADS, C // HEADS)
    chunks = [(0, 4)] + [(t, t + 1) for t in range(4, T)]
    japply = jax.jit(lambda p, tk, off, c: jlm.apply(p, tk, pos_offset=off,
                                                     cache=c))
    with torch.no_grad():
        for a, b in chunks:
            jl, jcache = japply(params, toks[:, a:b], a, jcache)
            got, cache = tlm(tt[:, a:b], pos_offset=a, cache=cache)
            _close(got.numpy(), np.asarray(jl))
        np.testing.assert_allclose(cache[1]["v"].numpy(),
                                   np.asarray(jcache[1]["v"]), atol=1e-5)
        # float64: decode is logit-identical to the full forward
        f64 = tmod.RingTransformerLM(
            vocab_size=V, num_layers=2, num_heads=HEADS,
            num_kv_heads=kv, d_model=C, max_seq_len=N * TL, rope=True,
            dtype=torch.float64).double()
        tmod.params_from_jax(params, f64)
        full = f64(tt)
        cache = tmod.init_decode_cache(f64, B, 64)
        worst = 0.0
        for a, b in chunks:
            got, cache = f64(tt[:, a:b], pos_offset=a, cache=cache)
            worst = max(worst, float((got - full[:, a:b]).abs().max()))
    assert full.dtype == torch.float64 and worst < 1e-12, worst


# -- the slice: the long-context trainer ------------------------------------

@pytest.mark.parametrize("layout,rope,use_pallas", [
    ("contiguous", False, False), ("zigzag", True, True)])
def test_long_context_step_matches_jax_example(cpu_devices, layout, rope,
                                               use_pallas):
    """One step of ``tools/long_context.py`` (Adam on the sum over ranks
    of the per-rank losses' grads) against the JAX example's ``step_fn``
    (Adam on psum'd grads) from the same params and tokens: loss and
    updated params rtol 1e-5."""
    T, lag, d_model, lr = N * TL, 6, 16, 3e-3
    zig = layout == "zigzag"
    kw = dict(vocab_size=tlc.VOCAB, num_layers=1, num_heads=2,
              d_model=d_model, max_seq_len=T, sp_mode="ring",
              sp_layout=layout, rope=rope, use_pallas=use_pallas)
    jlm = JLM(axis="rank", dtype=jnp.float32,
              pallas_interpret=True if use_pallas else None, **kw)
    params = jax.jit(jlm.clone(axis=None).init)(
        jax.random.key(0), jnp.zeros((1, TL), jnp.int32))
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def step_fn(params, opt_state, tokens, targets):
        idx = lax.axis_index("rank")
        positions = (jring.zigzag_positions(idx, N, TL // 2) if zig else
                     idx * TL + jnp.arange(TL))

        def loss_fn(p):
            logits = jlm.apply(p, tokens, positions=positions)
            mask = (targets >= 0).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.maximum(targets, 0))
            return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree.map(lambda g: lax.psum(g, "rank"), grads)
        loss = lax.pmean(loss, "rank")
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    # the example turns check_vma on when it runs no Pallas; then the
    # replicated params' gradient arrives already summed over the ring
    # and its psum counts it n times (Adam all but hides the scale, not
    # its eps).  Off, the psum is the one sum over the ranks.
    train = jax.jit(jax.shard_map(
        step_fn, mesh=_mesh(cpu_devices),
        in_specs=(P(), P(), P(None, "rank"), P(None, "rank")),
        out_specs=(P(), P(), P()), check_vma=False))
    order = tlc.zigzag_order(N, T) if zig else np.arange(T)
    seq, tgts = tlc.copy_batch(np.random.default_rng(0), T, lag,
                               tlc.VOCAB, order)
    jparams, _, jloss = train(params, opt_state, jnp.asarray(seq, jnp.int32),
                              jnp.asarray(tgts, jnp.int32))
    model = tmod.params_from_jax(
        jax.tree.map(np.asarray, params),
        tmod.RingTransformerLM(axis="rank", dtype=torch.float32, **kw))
    step = tlc.make_step(model, torch.optim.Adam(model.parameters(), lr=lr),
                         tlc.rank_positions(N, TL, zig, "cpu"))
    loss = step(tlc.stack_ranks(seq, N, "cpu"),
                tlc.stack_ranks(tgts, N, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tmod.params_from_jax(
        jax.tree.map(np.asarray, jparams),
        tmod.RingTransformerLM(axis="rank", dtype=torch.float32, **kw))
    for (name, got), (_, w) in zip(model.named_parameters(),
                                   want.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("check_vma,scale", [(True, N), (False, 1)])
def test_jax_example_grad_scale_under_check_vma(cpu_devices, check_vma,
                                                scale):
    """The JAX example's step as it ships runs ``check_vma=True`` when it
    uses no Pallas.  Then the replicated params' gradient arrives already
    summed over the ring and the example's ``psum`` counts it n times;
    with ``check_vma=False`` the ``psum`` is the one sum.  Pinned here on
    the same params and tokens: the example's psum'd grads equal ``scale``
    times the port's (the sum over ranks of the per-rank losses' grads),
    atol 1e-5 x max|g| per leaf, and the losses agree at rtol 1e-5."""
    T, lag, d_model = N * TL, 6, 16
    kw = dict(vocab_size=tlc.VOCAB, num_layers=1, num_heads=2,
              d_model=d_model, max_seq_len=T, sp_mode="ring",
              sp_layout="contiguous", rope=False, use_pallas=False)
    jlm = JLM(axis="rank", dtype=jnp.float32, **kw)
    params = jax.jit(jlm.clone(axis=None).init)(
        jax.random.key(1), jnp.zeros((1, TL), jnp.int32))

    def grad_fn(params, tokens, targets):
        positions = lax.axis_index("rank") * TL + jnp.arange(TL)

        def loss_fn(p):                  # the example's loss_fn
            logits = jlm.apply(p, tokens, positions=positions)
            mask = (targets >= 0).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.maximum(targets, 0))
            return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree.map(lambda g: lax.psum(g, "rank"), grads)
        return grads, lax.pmean(loss, "rank")

    run = jax.jit(jax.shard_map(
        grad_fn, mesh=_mesh(cpu_devices),
        in_specs=(P(), P(None, "rank"), P(None, "rank")),
        out_specs=(P(), P()), check_vma=check_vma))
    seq, tgts = tlc.copy_batch(np.random.default_rng(1), T, lag,
                               tlc.VOCAB, np.arange(T))
    jgrads, jloss = run(params, jnp.asarray(seq, jnp.int32),
                        jnp.asarray(tgts, jnp.int32))
    model = tmod.params_from_jax(
        jax.tree.map(np.asarray, params),
        tmod.RingTransformerLM(axis="rank", dtype=torch.float32, **kw))
    per_rank = tmod.lm_loss(
        model(tlc.stack_ranks(seq, N, "cpu"),
              positions=tlc.rank_positions(N, TL, False, "cpu")),
        tlc.stack_ranks(tgts, N, "cpu"))
    per_rank.sum().backward()
    np.testing.assert_allclose(float(per_rank.detach().mean()),
                               float(jloss),
                               rtol=1e-5)
    # the JAX grads, carried like params, against scale x the port's
    want = tmod.params_from_jax(
        jax.tree.map(np.asarray, jgrads),
        tmod.RingTransformerLM(axis="rank", dtype=torch.float32, **kw))
    for (name, p), (_, w) in zip(model.named_parameters(),
                                 want.named_parameters()):
        w = w.detach().numpy()
        lim = 1e-5 * float(np.abs(w).max())
        _close(scale * p.grad.numpy(), w, atol=lim)
        if scale > 1:                    # and not the unscaled sum
            assert np.abs(p.grad.numpy() - w).max() > lim, name


def test_long_context_tool_trains_on_the_cpu(capsys):
    doc = tlc.main(["--device", "cpu", "--steps", "3", "--ranks", "4",
                    "--seq-len", "64", "--sp-layout", "zigzag", "--rope"])
    losses = doc["losses"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "[ring-SP/zigzag]" in capsys.readouterr().out
    for bad, text in ((["--seq-len", "63"], "divide the rank count"),
                      (["--sp-mode", "ulysses", "--d-model", "60"],
                       "divisible by the rank count"),
                      (["--sp-mode", "ulysses", "--sp-layout", "zigzag"],
                       "goes with --sp-mode ring"),
                      (["--seq-len", "72"], "even per-rank block")):
        args = ["--device", "cpu", "--ranks", "8", "--steps", "1"] + bad
        if "72" in bad:
            args += ["--sp-layout", "zigzag"]
        with pytest.raises(SystemExit, match=text):
            tlc.main(args)


def test_sp_bench_runs_on_the_cpu(capsys):
    from bluefog_tpu_torch.tools import sp_bench
    doc = sp_bench.main(["--device", "cpu", "--seq", "64", "--heads", "4",
                         "--head-dim", "8", "--ranks", "4", "--iters", "1"])
    assert set(doc["rows"]) == {"contiguous", "zigzag", "ulysses"}
    assert doc["device"] == "cpu" and "host wall" in doc["clock"]
    assert all(r["ms"] > 0 for r in doc["rows"].values())
