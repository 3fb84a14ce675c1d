#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (add
``--profile`` for a ``torch.profiler`` breakdown of one decode call).

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: the card's name and power limit, torch and CUDA
   versions, and the flash-decode kernel's build from ``csrc/`` by nvcc;
2. the kernel against its plain PyTorch version on the card at
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
   reference logits, top-2 gap < 1e-3).

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


def profile_phase(engine):
    """One fused decode call at the full batch bucket: its wall time
    unprofiled (mean of 3), then its device time by kernel under
    torch.profiler (kernel events only: the CPU ops that launch them carry
    the same device time), and the device's busy share of the call."""
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
        print("profile " + json.dumps({"kernel": key[:90], "calls": count,
                                       "device_us": dt,
                                       "share": dt / total_us}))
    print("profile " + json.dumps({
        "steps": engine.scfg.decode_steps_per_call, "lanes": S,
        "decode_call_wall_ms": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "device": torch.cuda.get_device_name(0)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-batch decode call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from bluefog_tpu_torch.ops import _build
        from bluefog_tpu_torch.ops import flash_decode as fd
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
    t0 = time.monotonic()
    fd.build()
    build_s = time.monotonic() - t0
    for line in _build.build_log("flash_decode").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("ptxas " + line.strip())
    print("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "kernel_build_s": build_s}),
        flush=True)

    # -- phase 2: the kernel against its plain version ------------------
    main_case = kernel_phase(fd, kv)

    # -- phase 3: the serving path at full width ------------------------
    cfg = LMConfig(vocab=32768, d_model=1024, heads=16, layers=8,
                   ffn_mult=4)
    model = init_lm_params(cfg, seed=0, device=DEV)
    engine, launches = serve_phase(fd, kv, "raw", model, cfg, "raw", 16, 64)
    _, launches_int8 = serve_phase(fd, kv, "int8", model, cfg, "int8", 8,
                                   32)
    if args.profile:
        profile_phase(engine)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/flash_decode.cu",
        "replaces": "bluefog_tpu/ops/pallas_decode.py:136",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "launches_int8_run": launches_int8}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
