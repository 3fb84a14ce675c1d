#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (add
``--profile`` for a ``torch.profiler`` breakdown of one decode call, of
one training step, with K1's and K2's device time and share, of one
MoE decode call, and of one MoE training step with K1, K2, K4's forward
and K4's backward).

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
   noise before the rounding.  The kernel, its plain version and SDPA
   are timed cold (``_device_ms``: L2 flushed before each call, as each
   layer's call finds its pages in the engine), the kernel and SDPA also
   warm (``warm_ms``); the kernels line carries the f32 and the int8
   main-path cases (8 lanes, 16 kv heads); then head_dim 256 (the widest
   bucket) beside 64 on that shape with f32 and int8 pages, at the f32
   tolerance, timed cold with their bounds (a ``head_dim_case`` line);
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
   same values (the kernels' products are 3xTF32 on the tensor cores, f32
   accurate) and only the order differs: the normalized output o/l atol
   1e-4, l rtol 1e-4, m atol 1e-5 with -inf exactly where the plain
   version has it, dq/dk/dv atol 1e-4 x max|plain| per tensor (dk/dv sum
   over up to 2048 G rows).  Yardsticks: SDPA forward for K1, SDPA's
   backward alone on a kept graph for K2 (forward + backward beside it);
   the bound at the 3xTF32 rate (f32) or the bf16 rate, with the f32
   CUDA-core bound of earlier versions beside it;
5. ring attention over 4 stacked ranks (B 1, 4096 tokens per rank, 16 q
   heads over 16 or 4 kv heads, causal, and a 2048-token window), forward
   and backward through the kernels against the same ring over the plain
   block functions (and the forward against the plain online-softmax
   ring), at the tolerances of phase 4; then the zigzag layout at the
   same shapes (no window): K1 and K2 launched exactly n + 1 times a call
   each, against the same ring over the plain block functions and the
   contiguous ring on the un-permuted sequence, forward and grads;
4b. K1/K2 at head_dim 8 (the wrappers zero-pad it to the built 64), 64,
   128 and 256 (the widest built instance) against their plain versions
   at phase 4's tolerances, timed side by side with their bounds at the
   trainer's shape (B 4, T 2048, 16 heads, causal, f32);
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
9-10 (run after phase 6). the composed trainer at full width at
   lm_bench's default carving dp 2 x pp 2 x tp 2 (layers 4, micro 8) and
   at dp 2 x tp 2 x sp 2 (Ulysses, layers 2, micro 4): vocab 32768,
   d_model 1024, 16 heads, seq 2048, batch 4, delayed AWC, Adam 5e-3,
   seed 0; 1 warm-up and 3 timed steps.  K1 and K2 must each launch dp x
   (micro + pp - 1) x layers / pp times a step (every live stage, tp and
   sp peer of a GPipe tick folded into one launch), the mean loss must
   fall, and step 1 replayed with attention through the plain versions
   must agree: losses rtol 1e-5, every peer's gradients atol 1e-4 x
   max|g|.  Peak device memory over the 4 steps (a copy of the initial
   params is kept on the card for the replay);
11 (run after phases 9-10). the long-context trainer at full width:
   ``RingTransformerLM`` at lm_bench's widths (vocab 32768, d_model 1024,
   16 heads, 2 layers, rope, f32; 92.3 M parameters) over 8 stacked
   sequence ranks, 16,384 tokens (2,048 a rank), batch 1, through
   ``tools/long_context.py``'s step on its copy task (lag 8), Adam 3e-3,
   seed 0, three ways: the contiguous ring, the zigzag ring and Ulysses;
   1 warm-up and 3 timed steps each.  K1 and K2 must each launch layers x
   n (n + 1) / 2 = 72, layers x (n + 1) = 18 and layers = 2 times a
   step, the loss must fall, the zigzag's step-1 loss must equal the
   contiguous one's (rtol 1e-5; same init, tokens permuted by
   ``zigzag_order``), both the loss the step returned (the mean of
   per-rank means) and the loss over every target token, and step 1
   replayed with attention through the
   plain versions (called one batch row at a time) must agree: loss rtol
   1e-5, every parameter's gradient atol 1e-4 x max|g|.  s/step,
   tokens/s, model FLOP/s and peak memory per layout; under
   ``--profile`` K1+K2's share of device time;
7. the grouped expert FFN K4 (``grouped_ffn``) against its plain version
   (gather + einsum) on inputs laid out by the dropless dispatch itself:
   D 1024, F 4096, 8 experts unless noted; the decode shapes (16 rows at
   tile 2: 12 tiles; 1 lane: 5 tiles), the prefill shape (1024 rows at
   tile 8: 135 tiles), tiles 1, 4 and 16, every row on one expert, bf16
   operands, and D 96 / F 200.  Tolerance: f32 max abs error 1e-4 x
   max|plain| (both accumulate in f32, only the order differs); bf16 one
   bf16 ulp of each output (rtol 8e-3) on top of that.  The library
   yardstick is cuBLAS: ``torch.bmm``, gelu, ``torch.bmm`` over weights
   gathered beforehand (the port never calls it).  Timed cold and warm as
   in phase 2; the f32 bound is at the 3xTF32 rate (the CUDA-core f32
   bound of earlier versions beside it as ``bound_ms_simt``);
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
   to it;
12a (run after phase 8). K4's backward (``backward_plan_cuda``, then
   ``grouped_ffn_dgrad_cuda`` + ``grouped_ffn_wgrad_cuda`` under
   ``GroupedFFN``, f32) against the per-expert plain version under
   autograd: the MoE trainer's steady tick (65,536 rows over 32 folded
   experts, D 1024, F 2048), the serving prefill shape (135 tiles of 8,
   8 experts, F 4096), hostile routing (every row on one expert but 3 on
   another, the rest empty) and Zipf-skewed routing at the steady tick's
   shape (seeded weights k^-1.2: a trained router is uneven).  dxt, dw1,
   dw2 within 1e-4 x max|plain| (f32-accurate 3xTF32 products summed in
   another order, the weight gradients over up to 65k rows of one
   expert); two runs bit identical; experts without rows exactly 0; the
   device plan equal to its plain version, list by list.  Timed cold and
   warm beside the bound (8 rows D F operations at the 3xTF32 rate), the
   plain version's backward and the per-expert cuBLAS yardstick
   (``torch.matmul`` over each expert's rows, bounds read beforehand),
   with the dgrad, the wgrad and the plan timed apart and the plan's item
   counts.  The build (phase 1) prints ptxas's registers and spills for
   the backward's kernels and fails on any spill in them;
12b. MoE training at full width: ``MoELMConfig(vocab=32768,
   d_model=1024, heads=16, layers=4, seq_len=2048, micro=4, batch=4,
   num_experts=8, top_k=2, dispatch="dropless", group_tile=8)`` at dp 2
   x pp 2 x tp 2, Exp2 gossip, delayed AWC, Adam 5e-3, seed 0 (micro 4,
   not lm_bench's 8, is the one cut); 1 warm-up and 3 timed steps.  K1,
   K2, K4's forward, dgrad and wgrad must each launch dp x (micro + pp -
   1) x layers / pp times a step (and the backward's plan once with
   each dgrad), the loss must fall, the probe must
   report dropped_fraction 0, usage summing to 1 and finite values.
   Step 1 replayed through the plain versions (plain K1/K2, the
   per-expert K4): the router calls' top-k may flip only at near ties
   (each replica's first flip at a k-th to (k+1)-th probability gap
   below 1e-5; later flips are counted), and on any flip the replay
   takes the kernel run's routing; loss rtol 1e-5; every gradient within
   the larger of 1e-4 x max|g| and twice its one-ulp floor (the kernel
   path's own step-1 gradient with the embedding table moved by one ulp,
   measured in the same run: at these widths f32 rounding alone moves
   the gradients by ~2e-4 x max|g|, see PERF.md).  s/step, tokens/s,
   model FLOP/s and peak memory; the K4 operand copies of step 1.

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
# f32-accurate products on the tensor cores: 3xTF32 (big/small split,
# three TF32 MMAs per product) at a third of the dense TF32 rate
TF32_FLOPS = 495e12           # H100 SXM dense TF32 tensor-core rate
TF32X3_FLOPS = TF32_FLOPS / 3

H, DH, L, BK = 16, 64, 1024, 128
DEV = "cuda"


def _cuda_ms(fn, iters=20, warmup=3):
    """Warm time of K1/K2: ``iters`` calls back to back between two events
    (their milliseconds hide the host's launches)."""
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


_FLUSH = {}
FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2
HOLD_CYCLES = 1 << 21         # ~1 ms of device spin while the host enqueues


def _device_ms(fn, cold, iters=20, warmup=3):
    """Device time of one call, mean over ``iters``: before each call,
    outside the timed interval, the device spins while the host enqueues
    the call, so the two events around it see no host time.  ``cold``
    also writes a 256 MB buffer first (L2 holds 50 MB), as each layer's
    call finds its pages and weights in the engine; warm calls find in L2
    what the previous call left there."""
    if cold and "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                    device=DEV)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            _FLUSH["buf"].fill_(1)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _pages(rng, rows, Hkv, store, kv, dh=DH):
    """One layer's pages on the card: raw f32/bf16 or quantized."""
    cl = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=(rows, Hkv, L, dh)).astype(
            np.float32)).to(DEV)
        if store == "f32":
            cl[name] = x
        elif store == "bf16":
            cl[name] = x.bfloat16()
        else:
            cl[name], sc = kv.quantize_rows(x, store)
            cl[name + "_scale"] = sc.contiguous()
    return cl


def _bound_ms(lens, T, Hkv, G, page_item, q_item, quantized, S, dh=DH):
    """Least time for the work: every needed K/V row read once (plus its
    scales), q read and the output written once, against the larger of
    the memory and the f32 arithmetic bound."""
    keys = sum(int(n) + T for n in lens)
    nbytes = keys * Hkv * dh * 2 * page_item
    if quantized:
        nbytes += keys * Hkv * 2 * 4
    nbytes += 2 * S * T * H * dh * q_item + 4 * S * 4
    scored = sum((int(n) + t + 1) for n in lens for t in range(T))
    flops = scored * H * dh * 4                       # q.k and p.v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def kernel_phase(fd, kv):
    """Phase 2: every case once; returns the rows of the main-path cases
    (8 lanes, 16 kv heads, f32 q; f32 and int8 pages)."""
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
    main = {}
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
        def lib_call():
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask)

        ms, warm_ms = _device_ms(kern, True), _device_ms(kern, False)
        plain_ms = _device_ms(plain, True)
        lib_ms = _device_ms(lib_call, True)
        lib_warm_ms = _device_ms(lib_call, False)
        bound, bound_by = _bound_ms(
            lens, T, Hkv, G, cl["k"].element_size(), q.element_size(),
            "k_scale" in cl, S)
        row = dict(S=S, Hkv=Hkv, T=T, store=store, q=str(qdt)[6:],
                   prefix=prefix, trash=trash,
                   splits=fd.split_plan(S, Hkv, L)[0], max_abs_err=err,
                   ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                   library_warm_ms=lib_warm_ms, library_err=lib_err)
        print("kernel_case " + json.dumps(row), flush=True)
        if (S, Hkv, T, qdt, prefix, trash) == \
                (8, 16, 1, torch.float32, False, False) \
                and store in ("f32", "int8"):
            main[store] = row
    return main["f32"], main["int8"]


def decode_head_dim_phase(fd, kv):
    """Phase 2 (head dims): K3 at head_dim 256 (its widest bucket) beside
    64 on the main-path shape (8 lanes, 16 kv heads, T 1, f32 q) with f32
    and int8 pages, against the plain version at phase 2's tolerance,
    timed cold with their bounds; returns the Dh-256 rows."""
    rng = np.random.default_rng(12)
    S, Hkv, T = 8, 16, 1
    lens = np.linspace(0, L - T, S).astype(np.int64)
    slots_t = torch.arange(S, dtype=torch.int32, device=DEV)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    rows, out = [], {}
    for store in ("f32", "int8"):
        for dh in (64, 256):
            cl = _pages(rng, S + 1, Hkv, store, kv, dh)
            q = torch.from_numpy(rng.normal(size=(S, T, H, dh)).astype(
                np.float32)).to(DEV)

            def kern():
                return fd.flash_attend_chunk(q, cl, slots_t, lens_t,
                                             block_k=BK)

            def plain():
                return kv.attend_chunk(q, cl, slots_t, lens_t)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"flash decode at head_dim {dh} "
                                     f"({store} pages) disagrees with its "
                                     f"plain version: {err} (atol 1e-4)")
            bound, bound_by = _bound_ms(lens, T, Hkv, H // Hkv,
                                        cl["k"].element_size(), 4,
                                        "k_scale" in cl, S, dh)
            row = dict(store=store, Dh=dh, max_abs_err=err,
                       ms=_device_ms(kern, True),
                       warm_ms=_device_ms(kern, False),
                       plain_ms=_device_ms(plain, True, iters=5, warmup=1),
                       bound_ms=bound, bound_by=bound_by)
            rows.append(row)
            if dh == 256:
                out[store] = row
    print("head_dim_case " + json.dumps({
        "kernel": "flash_decode", "S": S, "Hkv": Hkv, "H": H, "T": T,
        "L": L, "cases": rows, "device": torch.cuda.get_device_name(0)}),
        flush=True)
    return out


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
                       decode_steps_per_call=4, decode_kernel="pallas",
                       decode_block_k=BK, kv_dtype=kv_dtype)
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


def _attn_bound(B, Tq, Tk, H, Hkv, D, item, pairs, backward, rate=None):
    """Least time: inputs read once and outputs written once against the
    operations (2 FLOP per multiply-add; K1 has 2 products per visible
    pair, K2 5) at the rate of f32-accurate products on the tensor cores
    (3xTF32), or the bf16 tensor-core rate for bf16 inputs (the same exact
    products); ``rate`` overrides it."""
    q_b, kv_b, rows = B * Tq * H * D, B * Tk * Hkv * D, B * Tq * H
    if backward:       # q, k, v, do (f32), lse, delta -> dq, dk, dv (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4 \
            + (q_b + 2 * kv_b) * 4
        flops = 10.0 * B * H * pairs * D
    else:              # q, k, v -> o, l, m (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4
        flops = 4.0 * B * H * pairs * D
    rate = rate or (BF16_FLOPS if item == 2 else TF32X3_FLOPS)
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

        kept = F.scaled_dot_product_attention(qh, kh, vh, **sdpa)

        def lib_bwd():                     # the backward alone, graph kept
            torch.autograd.grad(kept, (qh, kh, vh), doh, retain_graph=True)

        lib_fwd_ms = _cuda_ms(lib_fwd, iters=5, warmup=1)
        lib_bwd_ms = _cuda_ms(lib_bwd, iters=5, warmup=1)
        lib_fwd_bwd_ms = _cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
        del qh, kh, vh, kept
        pairs = _visible_pairs(T, T, qoff, koff, causal, window)
        item = q.element_size()
        fb, fby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, False)
        bb, bby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, True)
        row = dict(B=B, T=T, Hkv=Hkv, D=D, causal=causal,
                   dtype=str(dt)[6:], q_offset=qoff, k_offset=koff,
                   window=window, fwd=dict(
                       max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
                       bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                       library="SDPA forward"),
                   bwd=dict(max_abs_err=bwd_err, ms=bwd_ms,
                            plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                            library_ms=lib_bwd_ms,
                            library="SDPA backward on a kept graph",
                            library_fwd_bwd_ms=lib_fwd_bwd_ms))
        if item == 4:       # the yardstick of PR 2-3: f32 on the CUDA cores
            row["fwd"]["bound_ms_simt"] = _attn_bound(
                B, T, T, H, Hkv, D, item, pairs, False, F32_FLOPS)[0]
            row["bwd"]["bound_ms_simt"] = _attn_bound(
                B, T, T, H, Hkv, D, item, pairs, True, F32_FLOPS)[0]
        print("kernel_case " + json.dumps(row), flush=True)
        if (B, Hkv, D, causal, dt, qoff, koff, window) == \
                (4, 16, 64, True, torch.float32, 0, 0, 0):
            main = row
    return main


def head_dim_phase(fa):
    """Phase 4b: K1/K2 at head_dim 8 (zero-padded to the built 64 by the
    wrappers), 64, 128 and 256 (the widest built instance: 32-row tiles,
    two column halves) on the trainer's shape (B 4, T 2048, 16 heads,
    causal, f32), checked against the plain versions at phase 4's
    tolerances and timed side by side with their bounds: the cost of the
    padding and of the D-256 shape.  Returns the D-256 row."""
    rng = np.random.default_rng(9)
    B, T = 4, 2048
    rows = {}
    for D in (8, 64, 128, 256):
        q, k, v, do = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(
            np.float32)).to(DEV) for _ in range(4))
        kw = dict(causal=True, scale=D ** -0.5)
        want = fa.attention_block_partial_plain(q, k, v, 0, 0, **kw)
        fwd_err = _check_partial(fa.attention_block_partial(q, k, v, 0, 0,
                                                            **kw), want)
        wo, wl, wm = want
        lse = wm + torch.log(wl)
        delta = (do * wo / wl[..., None]).sum(-1)
        del want, wo
        got = fa.attention_block_backward(q, k, v, do, lse, delta, 0, 0,
                                          **kw)
        wgrads = fa.attention_block_backward_plain(q, k, v, do, lse, delta,
                                                   0, 0, **kw)
        bwd_err = 0.0
        for a, b in zip(got, wgrads):
            err, ok = _grad_err(a, b)
            bwd_err = max(bwd_err, err)
            if not ok:
                raise AssertionError(f"flash_bwd at head_dim {D} disagrees "
                                     f"with its plain version: {err}")
        del got, wgrads
        torch.cuda.synchronize()
        pairs = _visible_pairs(T, T, 0, 0, True, 0)
        fb, fby = _attn_bound(B, T, T, H, H, D, 4, pairs, False)
        bb, bby = _attn_bound(B, T, T, H, H, D, 4, pairs, True)
        rows[D] = dict(
            D=D, fwd_err=fwd_err, bwd_err=bwd_err,
            fwd_ms=_cuda_ms(lambda: fa.attention_block_partial(
                q, k, v, 0, 0, **kw), iters=10, warmup=2),
            bwd_ms=_cuda_ms(lambda: fa.attention_block_backward(
                q, k, v, do, lse, delta, 0, 0, **kw), iters=5, warmup=1),
            fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
            bwd_bound_by=bby)
        if D == 256:
            rows[D]["fwd_plain_ms"] = _cuda_ms(
                lambda: fa.attention_block_partial_plain(q, k, v, 0, 0,
                                                         **kw),
                iters=2, warmup=1)
            rows[D]["bwd_plain_ms"] = _cuda_ms(
                lambda: fa.attention_block_backward_plain(
                    q, k, v, do, lse, delta, 0, 0, **kw), iters=2, warmup=1)
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    print("head_dim_case " + json.dumps({
        "kernel": "flash_fwd/flash_bwd", "B": B, "T": T, "H": H,
        "causal": True, "cases": list(rows.values()),
        "fwd_ratio_d8_over_d64": rows[8]["fwd_ms"] / rows[64]["fwd_ms"],
        "bwd_ratio_d8_over_d64": rows[8]["bwd_ms"] / rows[64]["bwd_ms"],
        "fwd_ratio_d256_over_d128": rows[256]["fwd_ms"]
        / rows[128]["fwd_ms"],
        "bwd_ratio_d256_over_d128": rows[256]["bwd_ms"]
        / rows[128]["bwd_ms"],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return rows[256]


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


def _plain_by_row(fn):
    """``fn`` (a K1/K2 plain version) called on one batch row at a time:
    the same function (rows are independent), with a fraction of the
    dense score tensors' memory."""
    def call(q, k, v, *rest, **kw):
        outs = [fn(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                   *(r[b:b + 1] if torch.is_tensor(r) else r for r in rest),
                   **kw) for b in range(q.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return call


def _plain_attention():
    """A context in which K1/K2 run their plain versions (row by row)."""
    from contextlib import ExitStack
    from bluefog_tpu_torch.ops import flash_attention as fa
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        fa, "attention_block_partial",
        _plain_by_row(fa.attention_block_partial_plain)))
    stack.enter_context(mock.patch.object(
        fa, "attention_block_backward",
        _plain_by_row(fa.attention_block_backward_plain)))
    return stack


def zigzag_phase(fa, ring):
    """Phase 5 (zigzag): the zigzag ring through the kernels at phase 5's
    shapes, K1 and K2 launched exactly n + 1 times a call each, against
    the same ring over the plain block functions and against the
    contiguous ring through the kernels on the un-permuted sequence
    (forward and q/k/v grads), at phase 4's tolerances; the contiguous
    ring's launches beside it."""
    rng = np.random.default_rng(4)
    n, B, Tl, D = 4, 1, 4096, 64
    T = n * Tl
    inv = ring.zigzag_inverse(n, T)
    for Hkv in (16, 4):
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
        g = t(n, B, Tl, H, D)

        def run(layout, *xs_g):
            xs = [x.clone().requires_grad_() for x in xs_g[:3]]
            out = ring.ring_attention(*xs, causal=True, layout=layout)
            return (out.detach(),) + torch.autograd.grad(out, xs, xs_g[3])

        def unzig(x):                      # zigzag stack -> contiguous stack
            flat = x.transpose(0, 1).reshape((B, T) + tuple(x.shape[3:]))
            return flat[:, torch.as_tensor(inv, device=DEV)].reshape(
                (B, n, Tl) + tuple(x.shape[3:])).transpose(0, 1).contiguous()

        before = (fa.fwd_launches, fa.bwd_launches)
        t0 = time.monotonic()
        got = run("zigzag", q, k, v, g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        launches = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        if launches != (n + 1, n + 1):
            raise AssertionError(f"zigzag ring launched K1/K2 {launches} "
                                 f"times, want n + 1 = {n + 1} each")
        mid = (fa.fwd_launches, fa.bwd_launches)
        with _plain_attention():
            want = run("zigzag", q, k, v, g)
        if (fa.fwd_launches, fa.bwd_launches) != mid:
            raise AssertionError("the plain zigzag ring launched a kernel")
        contig = run("contiguous", *(unzig(x) for x in (q, k, v, g)))
        c_launches = (fa.fwd_launches - mid[0], fa.bwd_launches - mid[1])
        out_err = float((got[0] - want[0]).abs().max())
        contig_err = float((unzig(got[0]) - contig[0]).abs().max())
        errs = [_grad_err(a, b) for a, b in zip(got[1:], want[1:])]
        c_errs = [_grad_err(unzig(a), b) for a, b in zip(got[1:], contig[1:])]
        if out_err > 1e-4 or contig_err > 1e-4 or not all(
                ok for _, ok in errs + c_errs):
            raise AssertionError(
                f"zigzag ring (Hkv={Hkv}) disagrees: out err {out_err} / "
                f"{contig_err} (plain ring / contiguous ring), grad errs "
                f"{errs} / {c_errs}")
        print("ring_case " + json.dumps({
            "layout": "zigzag", "n": n, "B": B, "block_len": Tl, "Hkv": Hkv,
            "out_err": out_err, "out_err_vs_contiguous": contig_err,
            "grad_errs": [e for e, _ in errs],
            "grad_errs_vs_contiguous": [e for e, _ in c_errs],
            "fwd_launches": launches[0], "bwd_launches": launches[1],
            "contiguous_launches": list(c_launches),
            "fwd_bwd_wall_ms": ms}), flush=True)
        del q, k, v, g, got, want, contig
        torch.cuda.empty_cache()


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


def compose_phase(fa, smi, dp, pp, tp, sp, tag):
    """Phases 9-10: the composed trainer at full width (tools/lm_bench.py's
    non-smoke shape at this carving: layers 2 x pp, micro 4 x pp), its
    launch counts, falling loss, peak memory, and step 1 replayed with
    attention through the K1/K2 plain versions."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16,
                           layers=2 * pp, seq_len=2048, micro=4 * pp,
                           batch=4)
    m = compose.compose_parallelism(dp, pp, tp, sp, device=DEV)
    grad_fn = compose.make_lm_grad_fn(cfg, m, use_pallas=True)
    recorded, record = [], [True]

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:                 # kept on the host: the peak stays
            recorded.append((loss, [g.cpu() for g in   # the path's own
                                    tree_flatten(grads)[0]]))
        return loss, grads

    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    init = compose.init_lm_train_params(cfg, m, seed=0)
    toks = compose.make_lm_batch(cfg, m, seed=0)
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    fa.fwd_launches = fa.bwd_launches = 0
    losses = []
    params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # per replica, one launch per GPipe tick and layer of a stage: every
    # live stage, tp and sp peer of the tick is folded into it
    want = m.dp * (cfg.micro + m.pp - 1) * (cfg.layers // m.pp) * steps
    if launches != (want, want):
        raise AssertionError(
            f"{tag}: flash_fwd/flash_bwd launched {launches} times, want "
            f"dp x (micro + pp - 1) x layers / pp x steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"{tag}: loss did not fall: {mean}")
    del params, state

    # -- replay step 1 from the same init with the plain attention
    kernel_rec = recorded[:]
    recorded.clear()
    record[0] = True
    state = bfopt.init_distributed(strategy, init)
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        _, state, replay = step(init, state, toks)
    record[0] = False
    if (fa.fwd_launches, fa.bwd_launches) != launches:
        raise AssertionError(f"{tag}: the plain replay launched a kernel")
    if not np.allclose(replay.tolist(), losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: plain replay loss {replay.tolist()} "
                             f"!= kernel loss {losses[0]}")
    grad_err = 0.0
    for (_, gk), (_, gp) in zip(kernel_rec, recorded):
        for a, b in zip(gk, gp):
            err, ok = _grad_err(a.to(DEV), b.to(DEV))
            grad_err = max(grad_err, err / max(float(b.abs().max()), 1e-30))
            if not ok:
                raise AssertionError(f"{tag}: step-1 gradient of the plain "
                                     f"replay differs: {err} > 1e-4 max|g|")
    del state, kernel_rec, recorded[:]
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "mesh": m.describe(), "n_params": cfg.n_params,
        "config": {"layers": cfg.layers, "micro": cfg.micro,
                   "batch": cfg.batch, "seq": cfg.seq_len},
        "timed_steps": steps - 1, "per_step_s": per_step,
        "tokens_per_step": tokens, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "losses_mean": mean, "replay_loss": replay.tolist(),
        "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "launch_formula": "dp x (micro + pp - 1) x layers / pp x steps",
        "peak_mem_gb": peak,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(f"{tag} " + json.dumps(summary), flush=True)
    return launches, step, strategy, init, toks


def profile_train(step, strategy, init, toks, tag="profile_train"):
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
        print(f"{tag} " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    names = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")
    print(f"{tag} " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "kernel_device_ms": {n: sum(r[0] for r in rows if n in r[1]) / 1e3
                             for n in names},
        "kernel_shares": {n: sum(r[0] for r in rows if n in r[1]) / total_us
                          for n in names},
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phase 11: the long-context trainer ---------------------------------

LC_RANKS, LC_SEQ, LC_LAYERS = 8, 16384, 2


def long_context_phase(fa, smi, sp_mode, layout, profile=False):
    """Phase 11: ``RingTransformerLM`` at lm_bench's widths (vocab 32768,
    d_model 1024, 16 heads, 2 layers, rope, f32) over 8 stacked sequence
    ranks, 16,384 tokens (2,048 a rank), batch 1, through
    ``tools/long_context.py``'s step on its copy task (lag 8), Adam 3e-3,
    seed 0: 1 warm-up and 3 timed steps.  K1 and K2 must each launch
    layers x (n (n + 1) / 2 | n + 1 | 1) times a step (contiguous ring,
    zigzag ring, Ulysses), the loss must fall, and step 1 replayed with
    attention through the plain versions (row by row) must agree: loss
    rtol 1e-5, every parameter's gradient atol 1e-4 x max|g|.  Returns
    the launches, the init's loss over every target token (through the
    kernels) and the summary."""
    from bluefog_tpu_torch.models.transformer import (RingTransformerLM,
                                                      lm_loss)
    from bluefog_tpu_torch.ops.ring import zigzag_order
    from bluefog_tpu_torch.tools import long_context as lc
    n, T, Tl = LC_RANKS, LC_SEQ, LC_SEQ // LC_RANKS
    zig = layout == "zigzag"
    model = RingTransformerLM(
        vocab_size=32768, num_layers=LC_LAYERS, num_heads=16, d_model=1024,
        max_seq_len=T, axis="rank", dtype=torch.float32, sp_mode=sp_mode,
        sp_layout=layout, rope=True,
        use_pallas=True).reset_parameters(0).to(DEV)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    pos = lc.rank_positions(n, Tl, zig, DEV)
    step = lc.make_step(model, opt, pos)
    order = zigzag_order(n, T) if zig else np.arange(T)
    seq, tgts = lc.copy_batch(np.random.default_rng(0), T, 8, 32768, order)
    toks, tgts = lc.stack_ranks(seq, n, DEV), lc.stack_ranks(tgts, n, DEV)
    # the loss over every target token at the init, through the kernels:
    # unlike the mean over ranks of the per-rank means, it does not depend
    # on which rank holds the masked first targets
    counts = (tgts >= 0).reshape(n, -1).sum(1).double()
    with torch.no_grad():
        per_rank0 = lm_loss(model(toks, positions=pos), tgts).double()
    token_loss = float((per_rank0 * counts).sum() / counts.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    fa.fwd_launches = fa.bwd_launches = 0
    losses = [float(step(toks, tgts))]
    grads1 = {k: p.grad.detach().clone()
              for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        losses.append(float(step(toks, tgts)))
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = {"contiguous": n * (n + 1) // 2, "zigzag": n + 1}
    want = LC_LAYERS * (per_call[layout] if sp_mode == "ring" else 1)
    tag = f"long_context_{layout if sp_mode == 'ring' else sp_mode}"
    if launches != (want * steps, want * steps):
        raise AssertionError(f"{tag}: K1/K2 launched {launches} times in "
                             f"{steps} steps, want {want} each a step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    if profile:
        profile_long_context(step, toks, tgts, "profile_" + tag)

    # -- replay step 1 from the same init with the plain attention
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    del init, opt
    model.zero_grad(set_to_none=True)
    before = (fa.fwd_launches, fa.bwd_launches)
    with _plain_attention():
        per_rank = lm_loss(model(toks, positions=pos), tgts)
        per_rank.sum().backward()
    replay = float(per_rank.detach().mean())
    if (fa.fwd_launches, fa.bwd_launches) != before:
        raise AssertionError(f"{tag}: the plain replay launched a kernel")
    if not np.isclose(replay, losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: plain replay loss {replay} != kernel "
                             f"loss {losses[0]}")
    grad_err = 0.0
    for k, p in model.named_parameters():
        err, ok = _grad_err(grads1[k], p.grad)
        grad_err = max(grad_err, err / max(float(p.grad.abs().max()),
                                           1e-30))
        if not ok:
            raise AssertionError(f"{tag}: step-1 gradient of {k} in the "
                                 f"plain replay differs: {err} > 1e-4 "
                                 "max|g|")
    summary = {
        "sp_mode": sp_mode, "layout": layout, "ranks": n, "seq": T,
        "tokens_per_rank": Tl, "batch": 1, "layers": LC_LAYERS,
        "n_params": model.n_params, "timed_steps": steps - 1,
        "per_step_s": per_step, "tokens_per_s": T / per_step,
        "model_flops_per_s": T / per_step * model.flops_per_token(T),
        "losses": losses, "step1_token_mean_loss": token_loss,
        "replay_loss": replay,
        "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "launches_per_step": want, "peak_mem_gb": peak,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(f"{tag} " + json.dumps(summary), flush=True)
    del model, grads1
    torch.cuda.empty_cache()
    return launches, token_loss, summary


def profile_long_context(step, toks, tgts, tag):
    """One long-context step under torch.profiler: the device's busy
    share of it and K1+K2's share of device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(toks, tgts)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:10]:
        print(f"{tag} " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    names = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")
    k12 = sum(r[0] for r in rows if any(nm in r[1] for nm in names))
    print(f"{tag} " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "k1_k2_device_ms": k12 / 1e3, "k1_k2_share": k12 / total_us,
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phases 7-8: the grouped expert FFN and MoE serving -------------------

def _k4_inputs(rng, rows, E, D, F, tile, dtype, hostile, ids=None):
    """K4's operands as the dropless dispatch lays them out: ``rows``
    random rows routed at random (or all to the last expert, or by
    ``ids``), sorted and padded into tiles, plus expert weights at the
    model's init scale."""
    from bluefog_tpu_torch.parallel.expert import dropless_dispatch
    x = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
    if ids is None:
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


def _k4_bound(xt, eid, w1, rate=None):
    """Least time: the weights of every distinct expert the tiles name
    read once, xt read and the output written once, against 4 G tile D F
    operations at the rate of f32-accurate products on the tensor cores
    (3xTF32), or the bf16 tensor-core rate for bf16; ``rate`` overrides
    it (the CUDA-core f32 bound of earlier versions)."""
    G, tile, D = xt.shape
    Fd, item = w1.shape[2], xt.element_size()
    experts = int(torch.unique(eid).numel())
    nbytes = experts * 2 * D * Fd * item + 2 * G * tile * D * item + 4 * G
    flops = 4.0 * G * tile * D * Fd
    rate = rate or (BF16_FLOPS if item == 2 else TF32X3_FLOPS)
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

        def kern():
            return gf.grouped_ffn(xt, eid, w1, w2)

        ms, warm_ms = _device_ms(kern, True), _device_ms(kern, False)
        plain_ms = _device_ms(lambda: gf.grouped_ffn_plain(xt, eid, w1, w2),
                              True, iters=5, warmup=1)
        lib_ms, lib_warm_ms = _device_ms(lib, True), _device_ms(lib, False)
        del w1g, w2g
        bound, bound_by = _k4_bound(xt, eid, w1)
        simt = _k4_bound(xt, eid, w1, rate=F32_FLOPS)[0] \
            if dt == f32 else None
        row = dict(case=name, G=G, tile=tile, D=D, F=Fd, dtype=str(dt)[6:],
                   plan=list(gf.ffn_plan(G, tile, 8, D, Fd)),
                   experts_named=int(torch.unique(eid).numel()),
                   max_abs_err=err, max_abs_plain=top, ms=ms,
                   warm_ms=warm_ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, bound_ms_simt=simt, library_ms=lib_ms,
                   library_warm_ms=lib_warm_ms,
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
                       decode_steps_per_call=4, decode_kernel="pallas",
                       decode_block_k=BK, moe_experts=8, moe_top_k=2)
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


# -- phase 12: K4's backward and MoE training ----------------------------

def _k4_bwd_bound(rows, E, D, F):
    """Least time of K4's backward on ``rows`` routed rows: 8 rows D F
    operations (dgrad's two products, wgrad's two) at the 3xTF32 rate,
    or the bytes (xt, g, s and the weights read once; dxt and the weight
    gradients written once)."""
    flops = 8.0 * rows * D * F
    nbytes = 4 * (3 * rows * D + rows * F + 4 * E * D * F)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32X3_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _by_expert_yardstick(xt, eid, w1, w2, s, g):
    """The per-expert cuBLAS yardstick of K4's backward: ``torch.matmul``
    over each expert's contiguous rows (the run bounds read on the host
    beforehand, as a per-expert loop must), gelu' and gelu between."""
    import torch.nn.functional as F
    ids = eid.tolist()
    tile, D = xt.shape[1], xt.shape[2]
    x2, g2, s2 = (t.reshape(-1, t.shape[-1]) for t in (xt, g, s))
    runs, g0 = [], 0
    while g0 < len(ids):
        g1 = g0
        while g1 < len(ids) and ids[g1] == ids[g0]:
            g1 += 1
        runs.append((ids[g0], g0 * tile, g1 * tile))
        g0 = g1

    def run():
        dxt = torch.empty_like(x2)
        dw1, dw2 = torch.zeros_like(w1), torch.zeros_like(w2)
        for e, r0, r1 in runs:
            gs, ss, xs = g2[r0:r1], s2[r0:r1], x2[r0:r1]
            ds = torch.ops.aten.gelu_backward(
                torch.matmul(gs, w2[e].t()), ss, approximate="tanh")
            dxt[r0:r1] = torch.matmul(ds, w1[e].t())
            dw1[e] += torch.matmul(xs.t(), ds)
            dw2[e] += torch.matmul(F.gelu(ss, approximate="tanh").t(), gs)
        return dxt, dw1, dw2

    return run


def _zipf_ids(rng, rows, E, exponent=1.2):
    """Expert ids of ``rows`` rows drawn with Zipf-like weights k^-exponent
    over a random order of the ``E`` experts (a trained router is
    uneven)."""
    w = 1.0 / np.arange(1, E + 1) ** exponent
    return rng.permutation(E)[rng.choice(E, rows, p=w / w.sum())]


def _plan_row(lists, plan, D, Fd):
    """The device plan's item counts (``lists`` read back by
    ``unpack_plan``: for the report only)."""
    tiles = -(-D // 128) * -(-Fd // 128)
    blocks, parts = len(lists["row_blocks"]), len(lists["parts"])
    return {"runs": len(lists["runs"]), "row_blocks": blocks,
            "dgrad_items": [blocks * -(-Fd // 128), blocks * -(-D // 128)],
            "wgrad_parts": parts, "wgrad_items": parts * tiles,
            "part_sums": len(lists["part_sums"]),
            "scratch_slots": int(lists["slots"]),
            "scratch_slots_sized": plan.slots}


def grouped_ffn_backward_phase(gf):
    """Phase 12a: K4's backward (the plan, dgrad and wgrad kernels, f32)
    against the per-expert plain version under autograd at the MoE
    trainer's steady tick, the serving prefill shape, hostile routing and
    Zipf-skewed routing at the steady tick's shape: dxt, dw1, dw2 within
    1e-4 x max|plain| (f32-accurate 3xTF32 products summed in another
    order, the weight gradients over up to 65k rows of one expert), two
    runs bit-identical, experts without rows exactly 0, the device plan
    equal to its plain version.  Times cold and warm beside the bound, the
    plain version's backward and the per-expert cuBLAS yardstick, the
    dgrad, wgrad and plan apart.  Returns the rows by case."""
    rng = np.random.default_rng(12)
    hostile = np.full(4096, 5)
    hostile[:3] = 2                  # one expert with fewer rows than a tile
    cases = [("steady_tick", 65536, 32, 1024, 2048, None),
             ("prefill_512", 1024, 8, 1024, 4096, None),
             ("hostile", 4096, 8, 1024, 4096, hostile),
             ("skewed", 65536, 32, 1024, 2048,
              _zipf_ids(np.random.default_rng(1212), 65536, 32))]
    rows_out = {}
    for name, rows, E, D, Fd, ids in cases:
        xt, eid, w1, w2 = _k4_inputs(rng, rows, E, D, Fd, 8, torch.float32,
                                     False, ids)
        g = torch.from_numpy(rng.normal(size=tuple(xt.shape)).astype(
            np.float32)).to(DEV)

        def grads(fn):
            x, a, b = (t.detach().requires_grad_() for t in (xt, w1, w2))
            out = fn(x, eid, a, b)
            return torch.autograd.grad(out, (x, a, b), g)

        before = (gf.grouped_ffn_dgrad_cuda.launches,
                  gf.grouped_ffn_wgrad_cuda.launches,
                  gf.backward_plan_cuda.launches)
        got = grads(gf.grouped_ffn)
        again = grads(gf.grouped_ffn)
        torch.cuda.synchronize()
        if (gf.grouped_ffn_dgrad_cuda.launches - before[0],
                gf.grouped_ffn_wgrad_cuda.launches - before[1],
                gf.backward_plan_cuda.launches - before[2]) != (2, 2, 2):
            raise AssertionError(f"grouped_ffn backward {name}: the plan/"
                                 "dgrad/wgrad kernels did not launch once "
                                 "a backward")
        identical = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        want = grads(gf.grouped_ffn_plain_by_expert)
        errs = {}
        for key, a, b in zip(("dxt", "dw1", "dw2"), got, want):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            errs[key] = err / top
            if not (err <= 1e-4 * top and bool(torch.isfinite(a).all())):
                raise AssertionError(
                    f"grouped_ffn backward disagrees with the per-expert "
                    f"plain version: {name} {key}: max abs err {err} > "
                    f"1e-4 x max|plain| = {1e-4 * top}")
        if not identical:
            raise AssertionError(f"grouped_ffn backward {name}: two runs "
                                 "differ")
        named = set(eid.tolist())
        empty = [e for e in range(E) if e not in named]
        if empty and (bool(got[1][empty].any())
                      or bool(got[2][empty].any())):
            raise AssertionError(f"grouped_ffn backward {name}: an expert "
                                 "without rows got a nonzero gradient")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del got, want
        _, s = gf._forward_cuda(xt, eid, w1, w2, keep_s=True)
        plan = gf.backward_plan_cuda(eid, 8, E, D, Fd)
        plain_plan = gf.backward_plan_plain(eid, 8, E, D, Fd)
        lists = gf.unpack_plan(plan)
        if any(lists[k].shape != v.shape for k, v in plain_plan.items()):
            raise AssertionError(f"grouped_ffn backward {name}: the device "
                                 "plan's lists differ in length from its "
                                 "plain version's")
        plan_err = max(float((lists[k] - v.cpu()).abs().max())
                       if v.numel() else 0.0 for k, v in plain_plan.items())
        if plan_err != 0:
            raise AssertionError(f"grouped_ffn backward {name}: the device "
                                 f"plan differs from its plain version by "
                                 f"up to {plan_err}")
        dxt, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan)

        def kern():
            pl = gf.backward_plan_cuda(eid, 8, E, D, Fd)
            dx, d_s, uu = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, pl)
            return dx, gf.grouped_ffn_wgrad_cuda(xt, d_s, uu, g, eid, E,
                                                 plan=pl)

        x, a, b = (t.detach().requires_grad_() for t in (xt, w1, w2))
        ref_out = gf.grouped_ffn_plain_by_expert(x, eid, a, b)

        def plain():
            return torch.autograd.grad(ref_out, (x, a, b), g,
                                       retain_graph=True)

        ms, warm_ms = _device_ms(kern, True, iters=5, warmup=1), \
            _device_ms(kern, False, iters=5, warmup=1)
        dgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan), True,
            iters=5, warmup=1)
        wgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid, E,
                                              plan=plan), True, iters=5,
            warmup=1)
        plan_ms = _device_ms(lambda: gf.backward_plan_cuda(eid, 8, E, D, Fd),
                             True, iters=5, warmup=1)
        plan_plain_ms = _device_ms(
            lambda: gf.backward_plan_plain(eid, 8, E, D, Fd), True, iters=3,
            warmup=1)
        plain_ms = _device_ms(plain, True, iters=3, warmup=1)
        lib = _by_expert_yardstick(xt, eid, w1, w2, s, g)
        lib_ms, lib_warm_ms = _device_ms(lib, True, iters=5, warmup=1), \
            _device_ms(lib, False, iters=5, warmup=1)
        bound, bound_by = _k4_bwd_bound(rows, E, D, Fd)
        G = xt.shape[0]
        # the plan's least time: tile_eid read once, and written once what
        # this routing's plan holds: the header's 7 counts and flags, each
        # expert's rows, run pointers (E + 1) and cursor, the runs by tile
        # and by expert, the row blocks, the parts and the part sums
        plan_words = (7 + 3 * E + 1 + 4 * len(lists["runs"])
                      + 3 * len(lists["row_blocks"]) + 4 * len(lists["parts"])
                      + 3 * len(lists["part_sums"]))
        plan_bytes = 4 * (G + plan_words)
        row = dict(case=name, rows=rows, G=G, tile=8, E=E, D=D, F=Fd,
                   experts_named=len(named),
                   largest_expert_rows=int(lists["expert_rows"].max()),
                   plan=_plan_row(lists, plan, D, Fd),
                   plan_max_abs_err=plan_err,
                   max_abs_err=err, rel_err=errs, ms=ms, warm_ms=warm_ms,
                   dgrad_ms=dgrad_ms, wgrad_ms=wgrad_ms, plan_ms=plan_ms,
                   plan_plain_ms=plan_plain_ms,
                   plan_bound_ms=1e3 * plan_bytes / HBM_BYTES_PER_S,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   library_ms=lib_ms, library_warm_ms=lib_warm_ms,
                   library="cuBLAS torch.matmul per expert over its "
                           "contiguous rows (bounds read beforehand), "
                           "gelu' and gelu between",
                   plain="autograd backward of grouped_ffn_plain_by_expert "
                         "on a kept graph")
        print("kernel_case " + json.dumps(row), flush=True)
        rows_out[name] = row
        del xt, w1, w2, g, s, ref_out, x, a, b, dxt, ds, u, plan
        torch.cuda.empty_cache()
    return rows_out


class _Routing:
    """Records every ``router_topk`` call's top-k ids and its k-th to
    (k+1)-th probability gap (on the host), or forces the ids of a
    recorded run onto a replay (gates taken from the replay's own
    probabilities at those ids)."""

    def __init__(self, layers_mod):
        self.mod, self.orig = layers_mod, layers_mod.router_topk
        self.calls, self.force, self.i = [], None, 0

    def __call__(self, x, wr, *, top_k):
        logits, probs, idx, gate = self.orig(x, wr, top_k=top_k)
        if self.force is not None:
            idx = self.force[self.i].to(idx.device)
            gate = probs.gather(-1, idx)
            if top_k > 1:
                gate = gate / gate.sum(-1, keepdim=True)
            self.i += 1
            return logits, probs, idx, gate
        srt = torch.sort(probs, dim=-1, descending=True).values
        self.calls.append((idx.cpu(), (srt[..., top_k - 1]
                                       - srt[..., top_k]).detach().cpu()))
        return logits, probs, idx, gate


def moe_train_phase(fa, gf, layers_mod, smi, profile=False):
    """Phase 12b: MoE training at full width (lm_bench's widths, 8 experts
    top-2, dropless, group tile 8) at dp 2 x pp 2 x tp 2: launch counts,
    falling loss, the probe, peak memory, and step 1 replayed through the
    plain versions (plain K1/K2, the per-expert K4)."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    cfg = moe_model.MoELMConfig(vocab=32768, d_model=1024, heads=16,
                                layers=4, seq_len=2048, micro=4, batch=4,
                                num_experts=8, top_k=2, dispatch="dropless",
                                group_tile=8)
    m = compose.compose_parallelism(2, 2, 2, 1, device=DEV,
                                    num_experts=cfg.num_experts,
                                    capacity_factor=cfg.capacity_factor)
    grad_fn = moe_model.make_moe_grad_fn(cfg, m)
    recorded, record = [], [True]

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:                 # kept on the host: the peak stays
            recorded.append([g.cpu() for g in       # the path's own
                             tree_flatten(grads)[0]])
        return loss, grads

    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    t0 = time.monotonic()
    init = moe_model.init_moe_train_params(cfg, m, seed=0)
    toks = moe_model.make_moe_batch(cfg, m, seed=0)
    init_s = time.monotonic() - t0
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routing = _Routing(layers_mod)

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    fa.fwd_launches = fa.bwd_launches = 0
    gf.grouped_ffn_cuda.launches = gf.grouped_ffn_dgrad_cuda.launches = \
        gf.grouped_ffn_wgrad_cuda.launches = \
        gf.backward_plan_cuda.launches = 0
    losses = []
    # step 1 also counts the K4 operands that _aligned / _pad_widths copy
    # (none at these shapes: D 1024 and F / tp 2048 are multiples of 8, and
    # every peer's weight block starts on a 16-byte boundary)
    copies = {"aligned": 0, "padded": 0}
    aligned, pad = gf._aligned, gf._pad_widths

    def counted_aligned(t):
        copies["aligned"] += t.data_ptr() % 16 != 0
        return aligned(t)

    def counted_pad(xt, w1, w2):
        out = pad(xt, w1, w2)
        copies["padded"] += out[0] is not xt
        return out

    with mock.patch.object(layers_mod, "router_topk", routing), \
            mock.patch.object(gf, "_aligned", counted_aligned), \
            mock.patch.object(gf, "_pad_widths", counted_pad):
        params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = {"flash_fwd": fa.fwd_launches, "flash_bwd": fa.bwd_launches,
                "grouped_ffn": gf.grouped_ffn_cuda.launches,
                "grouped_ffn_dgrad": gf.grouped_ffn_dgrad_cuda.launches,
                "grouped_ffn_wgrad": gf.grouped_ffn_wgrad_cuda.launches,
                "grouped_ffn_backward_plan": gf.backward_plan_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # per replica, one launch of each per GPipe tick and layer of a stage:
    # every live stage, tp and sp peer of the tick is folded into it
    want = m.dp * (cfg.micro + m.pp - 1) * (cfg.layers // m.pp) * steps
    if set(launches.values()) != {want}:
        raise AssertionError(
            f"moe_train: launches {launches}, want dp x (micro + pp - 1) x "
            f"layers / pp x steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"moe_train: loss did not fall: {mean}")
    health = moe_model.make_moe_probe(cfg, m)(params, toks)
    if not (health["dropped_fraction"] == 0.0
            and abs(sum(health["usage"]) - 1.0) < 1e-5
            and all(np.isfinite(v).all() for v in health.values())):
        raise AssertionError(f"moe_train: probe {health}")
    del params, state
    torch.cuda.empty_cache()
    kernel_rec = recorded[:]
    kernel_calls = routing.calls

    # -- the f32 noise floor of step 1's gradients: the kernel path on
    #    the kernel run's routing with the embedding table moved by one
    #    ulp; summed over ~32k tokens a replica, rounding-sized changes of
    #    each token's cotangent move these gradients by ~1e-4 of their
    #    largest entry, so the replay below is held to the larger of
    #    1e-4 x max|g| and twice this floor, leaf by leaf
    p1 = {g: {k: v.clone() for k, v in d.items()} for g, d in init.items()}
    p1["shared"]["embed"].mul_(1 + 2 ** -23)
    noise_router = _Routing(layers_mod)
    noise_router.force = [i for i, _ in kernel_calls]
    with mock.patch.object(layers_mod, "router_topk", noise_router):
        _, noise = bfopt.stacked_grads(grad_fn, p1, toks, m.slice_size)
    noise = [x.cpu() for x in tree_flatten(noise)[0]]
    del p1
    torch.cuda.empty_cache()

    # -- replay step 1 from the same init through the plain versions
    plain = (mock.patch.object(fa, "attention_block_partial",
                               fa.attention_block_partial_plain),
             mock.patch.object(fa, "attention_block_backward",
                               fa.attention_block_backward_plain),
             mock.patch.object(gf, "grouped_ffn",
                               gf.grouped_ffn_plain_by_expert))

    def replay(router):
        recorded.clear()
        record[0] = True
        p0 = {g: {k: v.clone() for k, v in d.items()}    # the step updates
              for g, d in init.items()}                  # params in place
        state = bfopt.init_distributed(strategy, p0)
        with plain[0], plain[1], plain[2], \
                mock.patch.object(layers_mod, "router_topk", router):
            _, _, loss = step(p0, state, toks)
        record[0] = False
        del p0, state
        return loss.tolist()

    def counts():
        return (fa.fwd_launches, fa.bwd_launches,
                gf.grouped_ffn_cuda.launches,
                gf.grouped_ffn_dgrad_cuda.launches,
                gf.grouped_ffn_wgrad_cuda.launches,
                gf.backward_plan_cuda.launches)

    before = counts()                # the probe's forward launched too
    replay_routing = _Routing(layers_mod)
    replay_loss = replay(replay_routing)
    if len(kernel_calls) != len(replay_routing.calls):
        raise AssertionError("moe_train: the replay routed another number "
                             "of times")
    # each replica's first router call with a flip must flip only at near
    # ties (rounding moves a probability by ~1e-7); later flips may follow
    # from that one through the layers and the attention, and are counted
    flips, first_gaps = 0, []
    per_replica = len(kernel_calls) // m.dp
    for r in range(m.dp):
        first = True
        for (ki, kg), (pi, _) in zip(
                kernel_calls[r * per_replica:(r + 1) * per_replica],
                replay_routing.calls[r * per_replica:(r + 1) * per_replica]):
            diff = (ki != pi).any(-1)
            flips += int(diff.sum())
            if first and bool(diff.any()):
                first_gaps.append(float(kg[diff].max()))
                first = False
    if first_gaps and max(first_gaps) >= 1e-5:
        raise AssertionError(f"moe_train: routing flips away from a near "
                             f"tie (k-th to (k+1)-th gap {max(first_gaps)})")
    forced = flips > 0
    if forced:                       # replay again on the kernel's routing
        replay_routing.force = [i for i, _ in kernel_calls]
        replay_loss = replay(replay_routing)
    if counts() != before:
        raise AssertionError("moe_train: the plain replay launched a kernel")
    if not np.allclose(replay_loss, losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"moe_train: plain replay loss {replay_loss} "
                             f"!= kernel loss {losses[0]}")
    names = [f"{g}/{k}" for g in sorted(init) for k in sorted(init[g])]
    grad_err, leaf_err, leaf_floor, bad = 0.0, {}, {}, []
    n = m.slice_size
    for r, (gk, gp) in enumerate(zip(kernel_rec, recorded)):
        for name, a, b, z in zip(names, gk, gp, noise):
            err, ok = _grad_err(a.to(DEV), b.to(DEV))
            floor = float((a - z[r * n:(r + 1) * n]).abs().max())
            top = max(float(b.abs().max()), 1e-30)
            grad_err = max(grad_err, err / top)
            leaf_err[name] = max(leaf_err.get(name, 0.0), err / top)
            leaf_floor[name] = max(leaf_floor.get(name, 0.0), floor / top)
            if not (ok or err <= 2 * floor):
                bad.append((r, name, err, floor, top))
    if bad:
        raise AssertionError(f"moe_train: step-1 gradients of the plain "
                             f"replay differ (replica, leaf, err, one-ulp "
                             f"floor, max|g|): {bad}; relative errors "
                             f"{leaf_err}, floors {leaf_floor}; routing "
                             f"flips {flips} (first gaps {first_gaps}, "
                             f"forced {forced})")
    del kernel_rec, recorded[:], noise
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "mesh": m.describe(), "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
        "config": {"layers": cfg.layers, "micro": cfg.micro,
                   "batch": cfg.batch, "seq": cfg.seq_len,
                   "num_experts": cfg.num_experts, "top_k": cfg.top_k,
                   "group_tile": cfg.group_tile, "remat": False},
        "timed_steps": steps - 1, "per_step_s": per_step,
        "tokens_per_step": tokens, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "mfu_f32": tokens / per_step * cfg.flops_per_token() / F32_FLOPS,
        "losses_mean": mean, "replay_loss": replay_loss,
        "step1_grad_rel_err": grad_err, "step1_grad_rel_err_by_leaf": leaf_err,
        "step1_grad_one_ulp_floor_by_leaf": leaf_floor,
        "routing_flips": flips,
        "first_flip_tie_gaps": first_gaps, "replay_forced_routing": forced,
        "probe": health, "launches": launches,
        "k4_operand_copies_step1": copies,
        "launch_formula": "dp x (micro + pp - 1) x layers / pp x steps",
        "peak_mem_gb": peak, "init_s": init_s,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("moe_train " + json.dumps(summary), flush=True)
    if profile:
        profile_moe_train(step, strategy, init, toks)
    del step, strategy, init, toks
    torch.cuda.empty_cache()
    return launches, summary


def profile_moe_train(step, strategy, init, toks):
    """One MoE train step under torch.profiler: device busy over wall, and
    the device ms and share of K1, K2, K4's forward and its backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bluefog_tpu_torch import optimizers as bfopt
    state = bfopt.init_distributed(strategy, init)
    params, state, _ = step(init, state, toks)
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
        print("profile_moe_train " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))

    def kind(key):
        if "flash_fwd" in key:
            return "K1"
        if "flash_bwd" in key:
            return "K2"
        if any(k in key for k in ("backward_gemm", "backward_plan",
                                  "wgrad_parts_sum")):
            return "K4_backward"
        if "expert_rows" in key:
            return "K4_forward"
        return None

    ms = {k: 0.0 for k in ("K1", "K2", "K4_forward", "K4_backward")}
    for dt, key, _ in rows:
        if kind(key):
            ms[kind(key)] += dt / 1e3
    print("profile_moe_train " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms, "kernel_device_ms": ms,
        "kernel_shares": {k: v * 1e3 / total_us for k, v in ms.items()},
        "device": torch.cuda.get_device_name(0)}), flush=True)
    del params, state


def _ptxas_functions(log, names):
    """ptxas's report (-Xptxas -v) for each entry function whose mangled
    name holds one of ``names``: registers, spill stores + loads, and any
    wgmma serialization warning."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                out[cur] = {"spill_bytes": 0, "registers": None,
                            "warnings": []}
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                out.setdefault(cur, {"spill_bytes": 0, "registers": None,
                                     "warnings": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
        if "wgmma" in line:
            out[cur]["warnings"].append(line.strip()[:200])
    return out


def _build_all(builders):
    """Build every kernel library at once: one nvcc process each, all
    started together; returns the wall seconds and each library's."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.monotonic()
        build()
        return time.monotonic() - t0

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        each = [f.result() for f in [pool.submit(timed, b)
                                     for b in builders.values()]]
    return time.monotonic() - t0, dict(zip(builders, each))


_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def _kernel_row(name, source, replaces, launches, case):
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches}
    row.update({key: case[key] for key in _ROW_KEYS})
    if "warm_ms" in case:                  # K3/K4: ms is timed cold
        row["warm_ms"] = case["warm_ms"]
    return row


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
    build_s, lib_s = _build_all({"flash_decode": fd.build,
                                 "flash_attention": fa.build,
                                 "grouped_ffn": gf.build})
    for lib in ("flash_decode", "flash_attention", "grouped_ffn"):
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {lib} " + line.strip())
    bwd = _ptxas_functions(_build.build_log("grouped_ffn"),
                           ("backward_gemm", "backward_plan",
                            "wgrad_parts_sum"))
    print("ptxas_k4_backward " + json.dumps(bwd), flush=True)
    if len(bwd) != 5 or any(f["spill_bytes"] for f in bwd.values()):
        raise AssertionError(f"K4's backward kernels: want 5 built without "
                             f"spills, got {bwd}")
    print("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "kernel_build_s": build_s,
        "library_build_s": lib_s}),
        flush=True)
    phase_s = {"build": build_s}

    # -- phase 2: flash decode against its plain version ----------------
    t0 = time.monotonic()
    main_case, int8_case = kernel_phase(fd, kv)
    k3_256 = decode_head_dim_phase(fd, kv)
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
        profile_phase(engine, shares=("flash_decode",))
    del engine, model
    torch.cuda.empty_cache()
    phase_s["serve"] = time.monotonic() - t0

    # -- phase 4: flash attention K1/K2 against their plain versions ----
    t0 = time.monotonic()
    attn = attention_phase(fa)
    attn256 = head_dim_phase(fa)
    phase_s["flash_attention_cases"] = time.monotonic() - t0

    # -- phase 5: ring attention over stacked ranks ---------------------
    t0 = time.monotonic()
    ring_phase(fa, ring)
    zigzag_phase(fa, ring)
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

    # -- phases 9-10: the composed trainer (pp x tp; tp x Ulysses sp) ----
    compose_launches = {}
    for tag, carving in (("compose_pp2_tp2", (2, 2, 2, 1)),
                         ("compose_tp2_sp2", (2, 1, 2, 2))):
        t0 = time.monotonic()
        launches_c, step, strategy, init, toks = compose_phase(
            fa, smi, *carving, tag)
        compose_launches[tag] = launches_c
        if args.profile:
            profile_train(step, strategy, init, toks, "profile_" + tag)
        del step, strategy, init, toks
        torch.cuda.empty_cache()
        phase_s[tag] = time.monotonic() - t0

    # -- phase 11: the long-context trainer (ring contiguous / zigzag,
    #    Ulysses) over 8 stacked sequence ranks --------------------------
    lc_launches, lc_loss1, lc_rank_loss1 = {}, {}, {}
    for sp_mode, layout in (("ring", "contiguous"), ("ring", "zigzag"),
                            ("ulysses", "contiguous")):
        t0 = time.monotonic()
        launches_l, loss1, summ = long_context_phase(fa, smi, sp_mode,
                                                     layout, args.profile)
        tag = f"long_context_{layout if sp_mode == 'ring' else sp_mode}"
        lc_launches[tag], lc_loss1[tag] = launches_l, loss1
        lc_rank_loss1[tag] = summ["losses"][0]
        phase_s[tag] = time.monotonic() - t0
    # the same init, the permuted tokens: the step-1 loss must agree, both
    # the loss the timed step returned (the mean of per-rank means, which
    # weighs the rank holding the lag's masked targets apart) and the
    # loss over every target token (which does not depend on the layout)
    z, c = lc_loss1["long_context_zigzag"], lc_loss1["long_context_contiguous"]
    zr = lc_rank_loss1["long_context_zigzag"]
    cr = lc_rank_loss1["long_context_contiguous"]
    print("long_context_layouts " + json.dumps({
        "step1_token_mean_loss": lc_loss1,
        "step1_rank_mean_loss": lc_rank_loss1,
        "zigzag_vs_contiguous_rel": abs(z - c) / abs(c),
        "zigzag_vs_contiguous_step_rel": abs(zr - cr) / abs(cr)}),
        flush=True)
    for what, a, b in (("token-mean", z, c), ("step's own", zr, cr)):
        if not np.isclose(a, b, rtol=1e-5, atol=0):
            raise AssertionError(f"long context: the zigzag step-1 {what} "
                                 f"loss {a} != the contiguous one {b}")

    # -- phase 7: the grouped expert FFN K4 against its plain version ---
    t0 = time.monotonic()
    k4_decode, k4_prefill = grouped_ffn_phase(gf)
    phase_s["grouped_ffn_cases"] = time.monotonic() - t0

    # -- phase 8: MoE serving at full width -----------------------------
    t0 = time.monotonic()
    engine, k4_launches = moe_serve_phase(fd, gf, moe_layers, smi)
    if args.profile:
        profile_phase(engine, "profile_moe",
                      shares=("expert_rows", "flash_decode"))
    del engine
    torch.cuda.empty_cache()
    phase_s["moe_serve"] = time.monotonic() - t0

    # -- phase 12a: K4's backward against the per-expert plain version ---
    t0 = time.monotonic()
    k4_bwd = grouped_ffn_backward_phase(gf)
    phase_s["grouped_ffn_backward_cases"] = time.monotonic() - t0

    # -- phase 12b: MoE training at full width (dp 2 x pp 2 x tp 2) -----
    t0 = time.monotonic()
    moe_launches, _ = moe_train_phase(fa, gf, moe_layers, smi, args.profile)
    phase_s["moe_train"] = time.monotonic() - t0
    phase_s["total"] = time.monotonic() - t_start
    print("phases " + json.dumps(phase_s), flush=True)

    print(smi)
    decode = _kernel_row("flash_decode",
                         "bluefog_tpu_torch/csrc/flash_decode.cu",
                         "bluefog_tpu/ops/pallas_decode.py:136", launches,
                         main_case)
    decode["launches_int8_run"] = launches_int8
    decode["int8"] = {key: int8_case[key]
                      for key in _ROW_KEYS + ("warm_ms",)}
    decode["head_dim_256"] = {store: {key: row[key] for key in (
        "max_abs_err", "ms", "warm_ms", "plain_ms", "bound_ms", "bound_by")}
        for store, row in k3_256.items()}
    src = "bluefog_tpu_torch/csrc/flash_attention.cu"
    main_c = compose_launches["compose_pp2_tp2"]
    paths = {"train_dp4": (fwd_n, bwd_n), **compose_launches,
             **lc_launches, "moe_train": (moe_launches["flash_fwd"],
                                          moe_launches["flash_bwd"])}
    print(json.dumps({"kernels": [
        decode,
        dict(_kernel_row("flash_fwd", src,
                         "bluefog_tpu/ops/pallas_attention.py:134",
                         main_c[0], attn["fwd"]),
             launches_by_path={k: v[0] for k, v in paths.items()},
             head_dim_256={"ms": attn256["fwd_ms"],
                           "max_abs_err": attn256["fwd_err"],
                           "plain_ms": attn256["fwd_plain_ms"],
                           "bound_ms": attn256["fwd_bound_ms"],
                           "bound_by": attn256["fwd_bound_by"]}),
        dict(_kernel_row("flash_bwd", src,
                         "bluefog_tpu/ops/pallas_attention.py:275",
                         main_c[1], attn["bwd"]),
             launches_by_path={k: v[1] for k, v in paths.items()},
             library_fwd_bwd_ms=attn["bwd"]["library_fwd_bwd_ms"],
             head_dim_256={"ms": attn256["bwd_ms"],
                           "max_abs_err": attn256["bwd_err"],
                           "plain_ms": attn256["bwd_plain_ms"],
                           "bound_ms": attn256["bwd_bound_ms"],
                           "bound_by": attn256["bwd_bound_by"]}),
        dict(_kernel_row("grouped_ffn",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:61", k4_launches,
                         k4_decode),
             bound_ms_simt=k4_decode["bound_ms_simt"],
             launches_moe_train=moe_launches["grouped_ffn"],
             prefill={key: k4_prefill[key] for key in _ROW_KEYS + (
                 "warm_ms", "bound_ms_simt")}),
        dict(_kernel_row("grouped_ffn_backward",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:99",
                         moe_launches["grouped_ffn_dgrad"],
                         k4_bwd["steady_tick"]),
             kernels="backward_plan, then backward_gemm (wgmma: dgrad x 2, "
                     "wgrad x 2) + wgrad_parts_sum",
             wgrad_launches=moe_launches["grouped_ffn_wgrad"],
             dgrad_ms=k4_bwd["steady_tick"]["dgrad_ms"],
             wgrad_ms=k4_bwd["steady_tick"]["wgrad_ms"],
             **{case: {key: k4_bwd[case][key] for key in _ROW_KEYS + (
                 "warm_ms", "dgrad_ms", "wgrad_ms")}
                for case in ("prefill_512", "hostile", "skewed")}),
        {"name": "grouped_ffn_backward_plan", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/grouped_ffn.cu",
         "replaces": "bluefog_tpu/ops/pallas_moe.py:99",
         "launches": moe_launches["grouped_ffn_backward_plan"],
         "max_abs_err": max(row["plan_max_abs_err"]
                            for row in k4_bwd.values()),
         "ms": k4_bwd["steady_tick"]["plan_ms"],
         "plain_ms": k4_bwd["steady_tick"]["plan_plain_ms"],
         "bound_ms": k4_bwd["steady_tick"]["plan_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "note": "integer lists, equal to the plain version's in every "
                 "phase 12a case"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
