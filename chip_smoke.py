#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (add
``--profile`` for a ``torch.profiler`` breakdown of one decode call, of
one training step and of one MoE decode call).

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: the card's name and power limit, torch and CUDA
   versions, and the builds of ``csrc/flash_decode.cu``,
   ``csrc/flash_attention.cu`` and ``csrc/grouped_ffn.cu`` by nvcc (one
   process each, in parallel);
2. flash decode (K3) against its plain PyTorch version on the card at
   full-width shapes (S in {1, 8}, 16 q heads over 16 or 4 kv heads,
   head_dim 64, max_len 1024, block_k 128, T in {1, 4}; f32, bf16, int8
   and e4m3 pages, with and without a prefix row, plus padded lanes on
   the trash row).  Tolerance: max abs error 1e-4 with f32 q (same
   stored values, f32 accumulation, only the summation order differs);
   with bf16 q one bf16 ulp of each output (rtol 8e-3) plus 1e-5 of f32
   noise before the rounding;
3. the serving path at full width (the non-smoke shape of
   tools/serve_bench.py: vocab 32768, d_model 1024, 16 heads, 8 layers,
   random weights from seed 0) through ``ServeEngine`` and
   ``Scheduler.drain()``: 16 greedy requests with raw KV pages and 8 with
   int8 pages.  Every request must complete, the kernel's launch count
   over the drain must equal layers x decode steps, and the first four
   requests replayed with decode attention forced to the plain version
   must give the same tokens (or diverge only at a near tie of the
   reference logits, top-2 gap < 1e-3);
4. flash attention K1 (``flash_fwd``) and K2 (``flash_bwd_dkdv`` +
   ``flash_bwd_dq``) against their plain versions: B in {1, 4}, T 2048,
   16 q heads over 16 or 4 kv heads, head_dim 64 and 128, causal and not,
   f32 and bf16 inputs, plus global offsets (one case with every row
   masked) and a 512-token window.  Both sides accumulate in f32 from the
   same values and only the order differs: the normalized output o/l
   atol 1e-4, l rtol 1e-4, m atol 1e-5 with -inf exactly where the plain
   version has it, dq/dk/dv atol 1e-4 x max|plain| per tensor (dk/dv sum
   over up to 2048 G rows);
5. ring attention over 4 stacked ranks (B 1, 4096 tokens per rank, 16 q
   heads over 16 or 4 kv heads, causal, and a 2048-token window), forward
   and backward through the kernels against the same ring over the plain
   block functions (and the forward against the plain online-softmax
   ring), at the tolerances of phase 4;
6. the decentralized trainer at full width (tools/lm_bench.py's
   non-smoke shape: vocab 32768, d_model 1024, 16 heads, seq 2048, batch
   4, micro 4, 2 layers, dp 4 ranks stacked on the card, Exp2 gossip,
   delayed AWC, Adam 5e-3, random weights from seed 0): 1 warm-up and 4
   timed steps.  K1 and K2 must each launch dp x micro x layers x steps
   times, the mean loss must fall, and the gossip combine must equal
   ``W (x) I`` on one leaf.  A replay of 2 steps from the same init and
   batch with attention forced to the plain version must agree: step-1
   losses rtol 1e-5, step-1 gradients atol 1e-4 x max|g|, step-2 losses
   rtol 1e-3 (Adam's first updates are +-lr wherever |g| >> eps, so
   rounding noise in g can flip a sign only where g ~ 0);
7. the grouped expert FFN K4 (``grouped_ffn``) against its plain version
   (gather + einsum) on inputs laid out by the dropless dispatch itself:
   D 1024, F 4096, 8 experts unless noted; the decode shapes (16 rows at
   tile 2: 12 tiles; 1 lane: 5 tiles), the prefill shape (1024 rows at
   tile 8: 135 tiles), tiles 1, 4 and 16, every row on one expert, bf16
   operands, and D 96 / F 200.  Tolerance: f32 max abs error 1e-4 x
   max|plain| (both accumulate in f32, only the order differs); bf16 one
   bf16 ulp of each output (rtol 8e-3) on top of that.  The library
   yardstick is cuBLAS: ``torch.bmm``, gelu, ``torch.bmm`` over weights
   gathered beforehand (the port never calls it);
8. MoE serving at full width (tools/serve_bench.py's non-smoke widths
   with ``--serve-moe 8x2``: vocab 32768, d_model 1024, 16 heads, 8
   layers, 8 experts of F 4096, top-2, dropless, group tile 8; 637 M
   parameters from seed 0) through ``ServeEngine`` and
   ``Scheduler.drain()`` with phase 3's buckets: 16 greedy requests of
   32-512 prompt tokens and 64 new tokens, raw pages, auto decode tile
   (2).  Every request must complete; K4 must launch layers x (prefills +
   decode steps) times and K3 layers x decode steps; the first four
   requests replayed with K4 forced to its plain version must give the
   same tokens, or diverge only at a near tie: a top-2 logit gap below
   1e-3 at the first divergent token, or a router whose k-th and
   (k+1)-th probabilities lie within 1e-5 at some layer and position up
   to it.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate

H, DH, L, BK = 16, 64, 1024, 128
DEV = "cuda"


def _cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pages(rng, rows, Hkv, store, kv):
    """One layer's pages on the card: raw f32/bf16 or quantized."""
    cl = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=(rows, Hkv, L, DH)).astype(
            np.float32)).to(DEV)
        if store == "f32":
            cl[name] = x
        elif store == "bf16":
            cl[name] = x.bfloat16()
        else:
            cl[name], sc = kv.quantize_rows(x, store)
            cl[name + "_scale"] = sc.contiguous()
    return cl


def _bound_ms(lens, T, Hkv, G, page_item, q_item, quantized, S):
    """Least time for the work: every needed K/V row read once (plus its
    scales), q read and the output written once, against the larger of
    the memory and the f32 arithmetic bound."""
    keys = sum(int(n) + T for n in lens)
    nbytes = keys * Hkv * DH * 2 * page_item
    if quantized:
        nbytes += keys * Hkv * 2 * 4
    nbytes += 2 * S * T * H * DH * q_item + 4 * S * 4
    scored = sum((int(n) + t + 1) for n in lens for t in range(T))
    flops = scored * H * DH * 4                       # q.k and p.v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def kernel_phase(fd, kv):
    """Phase 2: every case once; returns the main-path case's row."""
    import torch.nn.functional as F
    rng = np.random.default_rng(1)
    cases = []
    for S in (1, 8):
        for Hkv in (16, 4):
            for T in (1, 4):
                for store, qdt in (("f32", torch.float32),
                                   ("bf16", torch.float32),
                                   ("bf16", torch.bfloat16),
                                   ("int8", torch.float32),
                                   ("fp8", torch.float32)):
                    for prefix in (False, True):
                        cases.append((S, Hkv, T, store, qdt, prefix, False))
    cases.append((8, 16, 1, "f32", torch.float32, False, True))
    main = None
    for S, Hkv, T, store, qdt, prefix, trash in cases:
        G = H // Hkv
        rows = S + 2                          # S slots, a prefix row, trash
        cl = _pages(rng, rows, Hkv, store, kv)
        if S == 1:
            lens = np.array([(2 * L) // 3])
        else:
            lens = np.linspace(0, L - T, S).astype(np.int64)
        slots = np.arange(S)
        if trash:                              # padded bucket lanes
            slots[5:], lens[5:] = rows - 1, 0
        plens = (lens // 2) // BK * BK if prefix else None
        dev = DEV
        slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        pre = {}
        if prefix:
            pre = dict(prefix_slots=torch.full((S,), S, dtype=torch.int32,
                                               device=dev),
                       prefix_lens=torch.tensor(plens, dtype=torch.int32,
                                                device=dev))
        q = torch.from_numpy(rng.normal(size=(S, T, H, DH)).astype(
            np.float32)).to(DEV, qdt)

        def kern():
            return fd.flash_attend_chunk(q, cl, slots_t, lens_t,
                                         block_k=BK, **pre)

        def plain():
            return kv.attend_chunk(q, cl, slots_t, lens_t, **pre)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if qdt == torch.float32:
            ok, tol = err <= 1e-4, "atol 1e-4"
        else:
            lim = 8e-3 * want.float().abs() + 1e-5
            ok, tol = bool((diff <= lim).all()), "rtol 8e-3 + 1e-5"
        if not (ok and torch.isfinite(got.float()).all()):
            raise AssertionError(
                f"flash decode disagrees with its plain version: S={S} "
                f"Hkv={Hkv} T={T} store={store} q={qdt} prefix={prefix} "
                f"trash={trash}: max abs err {err} ({tol})")
        # the library yardstick: SDPA over pre-gathered, head-expanded pages
        ks, vs = kv._gather_pages(cl, slots_t, pre.get("prefix_slots"),
                                  pre.get("prefix_lens"))
        kh = ks.to(qdt).repeat_interleave(G, dim=1)          # [S, H, L, Dh]
        vh = vs.to(qdt).repeat_interleave(G, dim=1)
        qh = q.transpose(1, 2)                               # [S, H, T, Dh]
        qpos = lens_t[:, None] + torch.arange(T, device=dev)[None]
        mask = (torch.arange(L, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]                # [S, 1, T, L]
        lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        lib_err = float((lib.transpose(1, 2).float() - want.float()).abs()
                        .max())
        ms, plain_ms = _cuda_ms(kern), _cuda_ms(plain)
        lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        bound, bound_by = _bound_ms(
            lens, T, Hkv, G, cl["k"].element_size(), q.element_size(),
            "k_scale" in cl, S)
        row = dict(S=S, Hkv=Hkv, T=T, store=store, q=str(qdt)[6:],
                   prefix=prefix, trash=trash, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   library_ms=lib_ms, library_err=lib_err)
        print("kernel_case " + json.dumps(row), flush=True)
        if (S, Hkv, T, store, qdt, prefix, trash) == \
                (8, 16, 1, "f32", torch.float32, False, False):
            main = row
    return main


def _top2_gap(model, tokens):
    with torch.inference_mode():
        lg = model(torch.tensor([tokens], device=DEV))[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def serve_phase(fd, kv, name, model, cfg, kv_dtype, n_req, max_new):
    """Phase 3: one full-width drain, its launch count, and the replay."""
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    scfg = ServeConfig(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                       prefill_buckets=(64, 256, 512),
                       decode_steps_per_call=4, decode_block_k=BK,
                       kv_dtype=kv_dtype)
    engine = ServeEngine(cfg, model, scfg, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_req)]
    sched = Scheduler(engine)
    fd.flash_decode_cuda.launches = 0
    t0 = time.monotonic()
    for p in prompts:
        sched.submit(p, max_new_tokens=max_new)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fd.flash_decode_cuda.launches
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"{name}: {len(reqs)}/{n_req} requests done")
    if launches != cfg.layers * sched.decode_steps or launches == 0:
        raise AssertionError(
            f"{name}: flash decode launched {launches} times, want layers "
            f"{cfg.layers} x decode steps {sched.decode_steps}")
    # the engine's first token of request 0 against the dense forward
    gap0 = _top2_gap(model, prompts[0])
    with torch.inference_mode():
        ref0 = int(torch.argmax(model(torch.tensor(
            [prompts[0]], device=DEV))[0, -1]))
    if reqs[0].generated[0] != ref0 and gap0 >= 1e-3:
        raise AssertionError(f"{name}: first token {reqs[0].generated[0]} "
                             f"!= dense forward's {ref0}")
    # replay the first 4 with decode attention forced to the plain version
    def plain_rows(q, kl, vl, slots, lengths, scale=None, *, k_scale=None,
                   v_scale=None, prefix_slots=None, prefix_lens=None,
                   block_k=128):
        return kv.attend_rows(q, kl, vl, slots, lengths, scale,
                              k_scale=k_scale, v_scale=v_scale,
                              prefix_slots=prefix_slots,
                              prefix_lens=prefix_lens)

    with mock.patch.object(fd, "flash_attend_rows", plain_rows):
        replay = Scheduler(engine)
        for p in prompts[:4]:
            replay.submit(p, max_new_tokens=max_new)
        before = fd.flash_decode_cuda.launches
        replay.drain()
        if fd.flash_decode_cuda.launches != before:
            raise AssertionError("replay launched the kernel")
    diverged = []
    for r_k, r_p in zip(reqs[:4], sorted(replay.completed,
                                         key=lambda r: r.id)):
        if r_k.generated == r_p.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r_k.generated,
                                                  r_p.generated)) if a != b)
        gap = _top2_gap(model, r_k.prompt + r_k.generated[:i])
        diverged.append({"request": r_k.id, "position": i, "top2_gap": gap})
        if gap >= 1e-3:
            raise AssertionError(f"{name}: kernel and plain streams diverge "
                                 f"at request {r_k.id} token {i} with a "
                                 f"top-2 gap of {gap}")
    tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "run": name, "kv_dtype": kv_dtype, "requests": n_req,
        "max_new_tokens": max_new, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "mean_ttft_s": float(np.mean([r.ttft for r in reqs])),
        "decode_calls": sched.decode_calls,
        "decode_steps": sched.decode_steps,
        "decode_ms_per_step": 1e3 * sched.decode_seconds
        / sched.decode_steps,
        "decode_ms_per_token": 1e3 * sched.decode_seconds
        / (tokens - n_req),
        "kernel_launches": launches, "replay_diverged": diverged,
        "device": torch.cuda.get_device_name(0),
    }
    print("serve " + json.dumps(summary), flush=True)
    return engine, launches


def profile_phase(engine, tag="profile", shares=()):
    """One fused decode call at the full batch bucket: its wall time
    unprofiled (mean of 3), then its device time by kernel under
    torch.profiler (kernel events only: the CPU ops that launch them carry
    the same device time), the device's busy share of the call, and the
    share of device time of each kernel whose name holds one of
    ``shares``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S = engine.scfg.batch_buckets[-1]
    lens = np.linspace(32, 900, S).astype(np.int32)[None]
    toks = np.zeros((1, S), np.int32)
    slots = np.arange(S, dtype=np.int32)[None]
    engine.decode(toks, slots, lens)
    t0 = time.monotonic()
    for _ in range(3):
        engine.decode(toks, slots, lens)
    wall_ms = 1e3 * (time.monotonic() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode(toks, slots, lens)
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:12]:
        print(f"{tag} " + json.dumps({"kernel": key[:90], "calls": count,
                                      "device_us": dt,
                                      "share": dt / total_us}))
    print(f"{tag} " + json.dumps({
        "steps": engine.scfg.decode_steps_per_call, "lanes": S,
        "decode_call_wall_ms": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "kernel_shares": {name: sum(r[0] for r in rows if name in r[1])
                          / total_us for name in shares},
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phases 4-6: flash attention, ring attention, the trainer ------------

def _visible_pairs(Tq, Tk, q_offset, k_offset, causal, window):
    """(query, key) pairs the masks keep: the work K1/K2 must do."""
    if not causal:
        return Tq * Tk
    d0 = q_offset + np.arange(Tq) - k_offset        # key j visible iff
    hi = np.minimum(d0, Tk - 1)                      # 0 <= d0 - j < window
    lo = np.maximum(d0 - window + 1, 0) if window else np.zeros_like(d0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_bound(B, Tq, Tk, H, Hkv, D, item, pairs, backward):
    """Least time: inputs read once and outputs written once against the
    operations (2 FLOP per multiply-add; K1 has 2 products per visible
    pair, K2 5) at the f32 rate, or the bf16 tensor-core rate for bf16
    inputs (the same exact products)."""
    q_b, kv_b, rows = B * Tq * H * D, B * Tk * Hkv * D, B * Tq * H
    if backward:       # q, k, v, do (f32), lse, delta -> dq, dk, dv (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4 \
            + (q_b + 2 * kv_b) * 4
        flops = 10.0 * B * H * pairs * D
    else:              # q, k, v -> o, l, m (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4
        flops = 4.0 * B * H * pairs * D
    rate = BF16_FLOPS if item == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _grad_err(got, want):
    """max |got - want| and whether it is within 1e-4 x max|want|."""
    err = float((got - want).abs().max())
    return err, err <= 1e-4 * float(want.abs().max()) + 1e-6


def _check_partial(got, want):
    """Phase-4 forward tolerances; returns the max abs error of o/l."""
    (o, l, m), (wo, wl, wm) = got, want
    if not torch.equal(torch.isneginf(m), torch.isneginf(wm)):
        raise AssertionError("flash_fwd: m is -inf on other rows than the "
                             "plain version's")
    fin = ~torch.isneginf(wm)
    zero = torch.zeros_like(m)
    m_err = float((torch.where(fin, m, zero) - torch.where(fin, wm, zero))
                  .abs().max())
    l_ok = bool(((l - wl).abs() <= 1e-4 * wl.abs()).all())
    den = torch.where(wl == 0, torch.ones_like(wl), wl)[..., None]
    o_err = float((o / den - wo / den).abs().max())
    if not (o_err <= 1e-4 and l_ok and m_err <= 1e-5
            and bool(torch.isfinite(o).all())):
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"o/l err {o_err} (atol 1e-4), l within rtol "
                             f"1e-4: {l_ok}, m err {m_err} (atol 1e-5)")
    return o_err


def attention_phase(fa):
    """Phase 4: K1 and K2 against their plain versions; returns the rows
    of the trainer's shape (B 4, T 2048, 16 heads, head_dim 64, causal,
    f32)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    T = 2048
    cases = [(B, Hkv, D, causal, dt, 0, 0, 0)
             for B in (1, 4) for Hkv in (16, 4) for D in (64, 128)
             for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(4, 16, 64, True, torch.float32, 2048, 0, 0),
              (4, 16, 64, True, torch.float32, 2048, 4096, 0),
              (4, 16, 64, True, torch.float32, 0, 0, 512)]
    main = None
    for B, Hkv, D, causal, dt, qoff, koff, window in cases:
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = (t(B, T, H, D).to(dt), t(B, T, Hkv, D).to(dt),
                   t(B, T, Hkv, D).to(dt))
        do = t(B, T, H, D)
        kw = dict(causal=causal, scale=D ** -0.5, window=window)
        want = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
        fwd_err = _check_partial(
            fa.attention_block_partial(q, k, v, qoff, koff, **kw), want)
        wo, wl, wm = want
        den = torch.where(wl == 0, torch.ones_like(wl), wl)
        out = wo / den[..., None]
        lse = torch.where(wl == 0, torch.full_like(wl, float("-inf")),
                          wm + torch.log(den))
        delta = (do * out).sum(-1)
        del want, wo, out
        got = fa.attention_block_backward(q, k, v, do, lse, delta, qoff,
                                          koff, **kw)
        wgrads = fa.attention_block_backward_plain(q, k, v, do, lse, delta,
                                                   qoff, koff, **kw)
        bwd_err = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, wgrads):
            err, ok = _grad_err(a, b)
            bwd_err = max(bwd_err, err)
            if not ok:
                raise AssertionError(
                    f"flash_bwd {name} disagrees with its plain version: "
                    f"max abs err {err} > 1e-4 x max|plain| "
                    f"{float(b.abs().max())}")
        del got, wgrads
        torch.cuda.synchronize()
        fwd_ms = _cuda_ms(lambda: fa.attention_block_partial(
            q, k, v, qoff, koff, **kw), iters=10, warmup=2)
        fwd_plain = _cuda_ms(lambda: fa.attention_block_partial_plain(
            q, k, v, qoff, koff, **kw), iters=3, warmup=1)
        bwd_ms = _cuda_ms(lambda: fa.attention_block_backward(
            q, k, v, do, lse, delta, qoff, koff, **kw), iters=5, warmup=1)
        bwd_plain = _cuda_ms(lambda: fa.attention_block_backward_plain(
            q, k, v, do, lse, delta, qoff, koff, **kw), iters=3, warmup=1)
        # the library yardstick: SDPA on [B, H, T, D] with the same mask
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa = dict(scale=D ** -0.5, enable_gqa=Hkv != H)
        if causal and (qoff, koff, window) == (0, 0, 0):
            sdpa["is_causal"] = True
        elif causal:
            sdpa["attn_mask"] = fa._keep(T, T, qoff, koff, window, DEV)
        doh = do.to(dt).transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh, **sdpa)

        def lib_fwd_bwd():
            F.scaled_dot_product_attention(qh, kh, vh, **sdpa).backward(doh)

        lib_fwd_ms = _cuda_ms(lib_fwd, iters=5, warmup=1)
        lib_bwd_ms = _cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
        del qh, kh, vh
        pairs = _visible_pairs(T, T, qoff, koff, causal, window)
        item = q.element_size()
        fb, fby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, False)
        bb, bby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, True)
        row = dict(B=B, T=T, Hkv=Hkv, D=D, causal=causal,
                   dtype=str(dt)[6:], q_offset=qoff, k_offset=koff,
                   window=window, fwd=dict(
                       max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
                       bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms),
                   bwd=dict(max_abs_err=bwd_err, ms=bwd_ms,
                            plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                            library_ms=lib_bwd_ms))
        print("kernel_case " + json.dumps(row), flush=True)
        if (B, Hkv, D, causal, dt, qoff, koff, window) == \
                (4, 16, 64, True, torch.float32, 0, 0, 0):
            main = row
    return main


def ring_phase(fa, ring):
    """Phase 5: the stacked ring through the kernels against the ring
    over the plain block functions."""
    rng = np.random.default_rng(3)
    n, B, Tl, D = 4, 1, 4096, 64
    for Hkv, window in ((16, None), (4, None), (16, 2048)):
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
        g = t(n, B, Tl, H, D)

        def run():
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            out = ring.ring_attention(*xs, causal=True, window=window)
            return (out.detach(),) + torch.autograd.grad(out, xs, g)

        before = (fa.fwd_launches, fa.bwd_launches)
        t0 = time.monotonic()
        got = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        launches = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        with mock.patch.object(fa, "attention_block_partial",
                               fa.attention_block_partial_plain), \
                mock.patch.object(fa, "attention_block_backward",
                                  fa.attention_block_backward_plain):
            want = run()
        if (fa.fwd_launches, fa.bwd_launches) != \
                (before[0] + launches[0], before[1] + launches[1]):
            raise AssertionError("the plain ring launched a kernel")
        with torch.no_grad():
            dense = ring._plain_ring_attention(q, k, v, True, D ** -0.5,
                                               window or 0)
        out_err = float((got[0] - want[0]).abs().max())
        dense_err = float((got[0] - dense).abs().max())
        errs = [_grad_err(a, b) for a, b in zip(got[1:], want[1:])]
        if out_err > 1e-4 or dense_err > 1e-4 or not all(
                ok for _, ok in errs) or launches[0] == 0:
            raise AssertionError(
                f"ring attention (Hkv={Hkv}, window={window}) disagrees: "
                f"out err {out_err} / {dense_err}, grad errs {errs}, "
                f"launches {launches}")
        print("ring_case " + json.dumps({
            "n": n, "B": B, "block_len": Tl, "Hkv": Hkv, "window": window,
            "out_err": out_err, "out_err_vs_online_softmax": dense_err,
            "grad_errs": [e for e, _ in errs], "fwd_launches": launches[0],
            "bwd_launches": launches[1], "fwd_bwd_wall_ms": ms}),
            flush=True)


def _spread(params):
    """Largest |x_r - mean_r x| over the leaves: how far the ranks sit
    from their consensus."""
    from bluefog_tpu_torch.fusion import tree_flatten
    return max(float((x - x.mean(0, keepdim=True)).abs().max())
               for x in tree_flatten(params)[0])


def train_phase(fa, smi):
    """Phase 6: the full-width trainer, its launch counts, the combine
    check and the plain-attention replay."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.ops import collectives as coll
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16, layers=2,
                           seq_len=2048, micro=4, batch=4)
    m = compose.compose_parallelism(4, device=DEV)
    grad_fn = compose.make_lm_grad_fn(cfg, m, use_pallas=True)
    recorded = []

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:
            recorded.append(grads)
        return loss, grads

    record = [True]
    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    init = compose.init_lm_train_params(cfg, m, seed=0)
    toks = compose.make_lm_batch(cfg, m, seed=0)
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()

    # -- the main path: counts at 0, 1 warm-up + 4 timed steps, counts read
    fa.fwd_launches = fa.bwd_launches = 0
    losses = []
    params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(4):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / 4
    launches = (fa.fwd_launches, fa.bwd_launches)
    want = m.dp * cfg.micro * cfg.layers * 5
    if launches != (want, want):
        raise AssertionError(f"trainer launched flash_fwd/flash_bwd "
                             f"{launches} times, want dp x micro x layers x "
                             f"steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"trainer loss did not fall: {mean}")
    leaf = params["blocks"]["wo"]
    mixed = coll.neighbor_allreduce(leaf, m.schedule)
    W = torch.as_tensor(m.effective_mixing(), dtype=torch.float64,
                        device=DEV)
    ref = torch.einsum("sd,s...->d...", W, leaf.double()).float()
    mix_err = float((mixed - ref).abs().max())
    if mix_err > 1e-5 * float(leaf.abs().max()):
        raise AssertionError(f"gossip combine != (W (x) I) x: err {mix_err}")
    spread = _spread(params)
    del params, state, mixed, ref

    # -- replay: 2 steps from the same init and batch, plain attention
    kernel_grads = recorded[:]
    recorded.clear()
    record[0] = True
    params = init
    state = bfopt.init_distributed(strategy, params)
    replay = []
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        for _ in range(2):
            params, state, loss = step(params, state, toks)
            replay.append(loss.tolist())
            record[0] = False
    if (fa.fwd_launches, fa.bwd_launches) != launches:
        raise AssertionError("the plain replay launched a kernel")
    l1, r1 = np.array(losses[0]), np.array(replay[0])
    l2, r2 = np.array(losses[1]), np.array(replay[1])
    if not (np.allclose(r1, l1, rtol=1e-5, atol=0)
            and np.allclose(r2, l2, rtol=1e-3, atol=0)):
        raise AssertionError(f"plain replay losses {replay} != kernel "
                             f"losses {losses[:2]}")
    from bluefog_tpu_torch.fusion import tree_flatten
    grad_err = 0.0
    for gk, gp in zip(kernel_grads, recorded):
        for a, b in zip(tree_flatten(gk)[0], tree_flatten(gp)[0]):
            err, ok = _grad_err(a, b)
            grad_err = max(grad_err, err / float(b.abs().max()))
            if not ok:
                raise AssertionError(f"step-1 gradient of the plain replay "
                                     f"differs: {err} > 1e-4 max|g|")
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "dp": m.dp, "n_params_per_rank": cfg.n_params,
        "per_step_s": per_step, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "losses_mean": mean, "loss_rank_spread": [max(x) - min(x)
                                                   for x in losses],
        "param_rank_spread": spread, "combine_err": mix_err,
        "replay_losses": replay, "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("train " + json.dumps(summary), flush=True)
    return launches, step, strategy, init, toks


def profile_train(step, strategy, init, toks):
    """One full-width train step under torch.profiler: device time by
    kernel and the device's busy share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bluefog_tpu_torch import optimizers as bfopt
    params = init
    state = bfopt.init_distributed(strategy, params)
    params, state, _ = step(params, state, toks)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, toks)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:15]:
        print("profile_train " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    print("profile_train " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phases 7-8: the grouped expert FFN and MoE serving -------------------

def _k4_inputs(rng, rows, E, D, F, tile, dtype, hostile):
    """K4's operands as the dropless dispatch lays them out: ``rows``
    random rows routed at random (or all to the last expert), sorted and
    padded into tiles, plus expert weights at the model's init scale."""
    from bluefog_tpu_torch.parallel.expert import dropless_dispatch
    x = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
    ids = np.full(rows, E - 1) if hostile else rng.integers(0, E, rows)
    seen = {}

    def capture(_, xt, tile_eid):
        seen["xt"], seen["eid"] = xt, tile_eid
        return xt

    dropless_dispatch(x.to(DEV), torch.tensor(ids, device=DEV), capture,
                      None, E, tile)

    def w(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.1).astype(
            np.float32)).to(DEV, dtype)

    return (seen["xt"].to(dtype).contiguous(), seen["eid"], w(E, D, F),
            w(E, F, D))


def _k4_bound(xt, eid, w1):
    """Least time: the weights of every distinct expert the tiles name
    read once, xt read and the output written once, against 4 G tile D F
    operations at the f32 rate, or the bf16 tensor-core rate for bf16."""
    G, tile, D = xt.shape
    Fd, item = w1.shape[2], xt.element_size()
    experts = int(torch.unique(eid).numel())
    nbytes = experts * 2 * D * Fd * item + 2 * G * tile * D * item + 4 * G
    flops = 4.0 * G * tile * D * Fd
    rate = BF16_FLOPS if item == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def grouped_ffn_phase(gf):
    """Phase 7: K4 against its plain version; returns the rows of the
    decode shape (8 lanes, f32) and the prefill shape (f32)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("decode_8_lanes", 16, 1024, 4096, 2, f32, False),
             ("decode_1_lane", 2, 1024, 4096, 2, f32, False),
             ("prefill_512", 1024, 1024, 4096, 8, f32, False),
             ("tile_1", 16, 1024, 4096, 1, f32, False),
             ("tile_4", 16, 1024, 4096, 4, f32, False),
             ("tile_16", 64, 1024, 4096, 16, f32, False),
             ("hostile", 16, 1024, 4096, 2, f32, True),
             ("decode_8_lanes_bf16", 16, 1024, 4096, 2, bf16, False),
             ("prefill_512_bf16", 1024, 1024, 4096, 8, bf16, False),
             ("ragged_D96_F200", 16, 96, 200, 2, f32, False)]
    rows_out = {}
    for name, rows, D, Fd, tile, dt, hostile in cases:
        xt, eid, w1, w2 = _k4_inputs(rng, rows, 8, D, Fd, tile, dt, hostile)
        before = gf.grouped_ffn_cuda.launches
        got = gf.grouped_ffn(xt, eid, w1, w2)
        want = gf.grouped_ffn_plain(xt, eid, w1, w2)
        torch.cuda.synchronize()
        if gf.grouped_ffn_cuda.launches != before + 1:
            raise AssertionError(f"grouped_ffn {name}: the kernel did not "
                                 "launch")
        diff = (got.float() - want.float()).abs()
        err, top = float(diff.max()), float(want.float().abs().max())
        lim = 1e-4 * top
        if dt == bf16:
            lim = lim + 8e-3 * want.float().abs()
        if not (bool((diff <= lim).all())
                and bool(torch.isfinite(got.float()).all())
                and got.dtype == dt and got.shape == xt.shape):
            raise AssertionError(
                f"grouped_ffn disagrees with its plain version: {name} "
                f"G={xt.shape[0]} tile={tile}: max abs err {err} "
                f"(1e-4 x max|plain| = {1e-4 * top}"
                f"{' + rtol 8e-3' if dt == bf16 else ''})")
        idx = eid.long()
        w1g, w2g = w1[idx], w2[idx]                       # cuBLAS yardstick
        G = xt.shape[0]

        def lib():
            u = F.gelu(torch.bmm(xt, w1g), approximate="tanh")
            return torch.bmm(u, w2g)

        ms = _cuda_ms(lambda: gf.grouped_ffn(xt, eid, w1, w2))
        plain_ms = _cuda_ms(lambda: gf.grouped_ffn_plain(xt, eid, w1, w2),
                            iters=5, warmup=1)
        lib_ms = _cuda_ms(lib)
        del w1g, w2g
        bound, bound_by = _k4_bound(xt, eid, w1)
        row = dict(case=name, G=G, tile=tile, D=D, F=Fd, dtype=str(dt)[6:],
                   experts_named=int(torch.unique(eid).numel()),
                   max_abs_err=err, max_abs_plain=top, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   library_ms=lib_ms,
                   library="cuBLAS torch.bmm + gelu + torch.bmm over "
                           "pre-gathered weights")
        print("kernel_case " + json.dumps(row), flush=True)
        rows_out[name] = row
        del xt, w1, w2, got, want
    torch.cuda.empty_cache()
    return rows_out["decode_8_lanes"], rows_out["prefill_512"]


def _router_tie(model, layers_mod, tokens, k):
    """Smallest gap between the k-th and (k+1)-th router probability over
    every layer and position of the cache-free forward over ``tokens``."""
    gaps = []
    orig = layers_mod.router_topk

    def recording(x, wr, *, top_k):
        out = orig(x, wr, top_k=top_k)
        srt = torch.sort(out[1], dim=-1, descending=True).values
        gaps.append(float((srt[:, k - 1] - srt[:, k]).min()))
        return out

    with mock.patch.object(layers_mod, "router_topk", recording), \
            torch.inference_mode():
        model(torch.tensor([tokens], device=DEV))
    return min(gaps)


def moe_serve_phase(fd, gf, layers_mod, smi):
    """Phase 8: the MoE drain at full width, its launch counts, and the
    replay with K4 forced to its plain version."""
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    cfg = MoELMConfig(vocab=32768, d_model=1024, heads=16, layers=8,
                      ffn_mult=4, num_experts=8, top_k=2,
                      dispatch="dropless", group_tile=8)
    t0 = time.monotonic()
    model = init_moe_params(cfg, seed=0, device=DEV)
    init_s = time.monotonic() - t0
    scfg = ServeConfig(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                       prefill_buckets=(64, 256, 512),
                       decode_steps_per_call=4, decode_block_k=BK,
                       moe_experts=8, moe_top_k=2)
    engine = ServeEngine(cfg, model, scfg, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    n_req, max_new = 16, 64
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_req)]
    sched = Scheduler(engine)
    fd.flash_decode_cuda.launches = gf.grouped_ffn_cuda.launches = 0
    t0 = time.monotonic()
    for p in prompts:
        sched.submit(p, max_new_tokens=max_new)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k3, k4 = fd.flash_decode_cuda.launches, gf.grouped_ffn_cuda.launches
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"moe: {len(reqs)}/{n_req} requests done")
    if k4 != cfg.layers * (n_req + sched.decode_steps) or k4 == 0:
        raise AssertionError(
            f"moe: grouped_ffn launched {k4} times, want layers "
            f"{cfg.layers} x (prefills {n_req} + decode steps "
            f"{sched.decode_steps})")
    if k3 != cfg.layers * sched.decode_steps:
        raise AssertionError(f"moe: flash decode launched {k3} times, want "
                             f"layers x decode steps")
    load = engine.moe_load()[0]
    # the engine's first token of request 0 against the cache-free forward
    gap0 = _top2_gap(model, prompts[0])
    with torch.inference_mode():
        ref0 = int(torch.argmax(model(torch.tensor(
            [prompts[0]], device=DEV))[0, -1]))
    if reqs[0].generated[0] != ref0 and gap0 >= 1e-3:
        raise AssertionError(f"moe: first token {reqs[0].generated[0]} != "
                             f"the forward's {ref0}")
    # replay the first 4 with K4 forced to its plain version
    with mock.patch.object(gf, "grouped_ffn", gf.grouped_ffn_plain):
        replay = Scheduler(engine)
        for p in prompts[:4]:
            replay.submit(p, max_new_tokens=max_new)
        before = gf.grouped_ffn_cuda.launches
        replay.drain()
        if gf.grouped_ffn_cuda.launches != before:
            raise AssertionError("the plain-K4 replay launched the kernel")
    diverged = []
    for r_k, r_p in zip(reqs[:4], sorted(replay.completed,
                                         key=lambda r: r.id)):
        if r_k.generated == r_p.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r_k.generated,
                                                  r_p.generated)) if a != b)
        seq = r_k.prompt + r_k.generated[:i]
        gap = _top2_gap(model, seq)
        tie = _router_tie(model, layers_mod, seq, cfg.top_k)
        diverged.append({"request": r_k.id, "position": i, "top2_gap": gap,
                         "router_gap": tie})
        if gap >= 1e-3 and tie >= 1e-5:
            raise AssertionError(
                f"moe: kernel and plain-K4 streams diverge at request "
                f"{r_k.id} token {i} with a top-2 gap of {gap} and a "
                f"router gap of {tie}")
    tokens = sum(len(r.generated) for r in reqs)
    print("serve " + json.dumps({
        "run": "moe", "kv_dtype": "raw", "requests": n_req,
        "max_new_tokens": max_new, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "mean_ttft_s": float(np.mean([r.ttft for r in reqs])),
        "decode_calls": sched.decode_calls,
        "decode_steps": sched.decode_steps,
        "decode_ms_per_step": 1e3 * sched.decode_seconds
        / sched.decode_steps,
        "decode_ms_per_token": 1e3 * sched.decode_seconds
        / (tokens - n_req),
        "decode_tile": engine._moe_tile, "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params, "init_s": init_s,
        "grouped_ffn_launches": k4, "flash_decode_launches": k3,
        "last_call_expert_fractions": load["fractions"].tolist(),
        "last_call_router_entropy": load["entropy"],
        "replay_diverged": diverged,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)
    return engine, k4


def _build_all(builders):
    """Build every kernel library at once: one nvcc process each, all
    started together; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        for f in [pool.submit(b) for b in builders]:
            f.result()
    return time.monotonic() - t0


def _kernel_row(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-batch decode call and one "
                         "training step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from bluefog_tpu_torch.ops import _build
        from bluefog_tpu_torch.ops import flash_attention as fa
        from bluefog_tpu_torch.ops import flash_decode as fd
        from bluefog_tpu_torch.ops import grouped_ffn as gf
        from bluefog_tpu_torch.ops import ring
        from bluefog_tpu_torch.moe import layers as moe_layers
        from bluefog_tpu_torch.parallel.compose import LMConfig, \
            init_lm_params
        from bluefog_tpu_torch.serve import kv_cache as kv
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    # -- phase 1: environment and build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    build_s = _build_all([fd.build, fa.build, gf.build])
    for lib in ("flash_decode", "flash_attention", "grouped_ffn"):
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {lib} " + line.strip())
    print("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "kernel_build_s": build_s}),
        flush=True)
    phase_s = {"build": build_s}

    # -- phase 2: flash decode against its plain version ----------------
    t0 = time.monotonic()
    main_case = kernel_phase(fd, kv)
    phase_s["flash_decode_cases"] = time.monotonic() - t0

    # -- phase 3: the serving path at full width ------------------------
    t0 = time.monotonic()
    cfg = LMConfig(vocab=32768, d_model=1024, heads=16, layers=8,
                   ffn_mult=4)
    model = init_lm_params(cfg, seed=0, device=DEV)
    engine, launches = serve_phase(fd, kv, "raw", model, cfg, "raw", 16, 64)
    _, launches_int8 = serve_phase(fd, kv, "int8", model, cfg, "int8", 8,
                                   32)
    if args.profile:
        profile_phase(engine)
    del engine, model
    torch.cuda.empty_cache()
    phase_s["serve"] = time.monotonic() - t0

    # -- phase 4: flash attention K1/K2 against their plain versions ----
    t0 = time.monotonic()
    attn = attention_phase(fa)
    phase_s["flash_attention_cases"] = time.monotonic() - t0

    # -- phase 5: ring attention over stacked ranks ---------------------
    t0 = time.monotonic()
    ring_phase(fa, ring)
    phase_s["ring"] = time.monotonic() - t0

    # -- phase 6: the decentralized trainer at full width ---------------
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    (fwd_n, bwd_n), step, strategy, init, toks = train_phase(fa, smi)
    if args.profile:
        profile_train(step, strategy, init, toks)
    del step, strategy, init, toks
    torch.cuda.empty_cache()
    phase_s["train"] = time.monotonic() - t0

    # -- phase 7: the grouped expert FFN K4 against its plain version ---
    t0 = time.monotonic()
    k4_decode, k4_prefill = grouped_ffn_phase(gf)
    phase_s["grouped_ffn_cases"] = time.monotonic() - t0

    # -- phase 8: MoE serving at full width -----------------------------
    t0 = time.monotonic()
    engine, k4_launches = moe_serve_phase(fd, gf, moe_layers, smi)
    if args.profile:
        profile_phase(engine, "profile_moe",
                      shares=("grouped_rows", "flash_decode_kernel"))
    del engine
    phase_s["moe_serve"] = time.monotonic() - t0
    phase_s["total"] = time.monotonic() - t_start
    print("phases " + json.dumps(phase_s), flush=True)

    print(smi)
    decode = _kernel_row("flash_decode",
                         "bluefog_tpu_torch/csrc/flash_decode.cu",
                         "bluefog_tpu/ops/pallas_decode.py:136", launches,
                         main_case)
    decode["launches_int8_run"] = launches_int8
    src = "bluefog_tpu_torch/csrc/flash_attention.cu"
    print(json.dumps({"kernels": [
        decode,
        _kernel_row("flash_fwd", src,
                    "bluefog_tpu/ops/pallas_attention.py:134", fwd_n,
                    attn["fwd"]),
        _kernel_row("flash_bwd", src,
                    "bluefog_tpu/ops/pallas_attention.py:275", bwd_n,
                    attn["bwd"]),
        dict(_kernel_row("grouped_ffn",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:61", k4_launches,
                         k4_decode),
             prefill={key: k4_prefill[key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")})]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
