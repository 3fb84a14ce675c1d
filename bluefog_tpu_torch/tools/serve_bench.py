"""End-to-end grader of the train->serve estate on one device
(counterpart of the JAX package's ``tools/serve_bench.py``).

Brings up the JAX tool's estate with every rank stacked on one device: a
gossip-DP training fleet (``compose.make_train_step`` over ``--train-dp``
replicas of ``--pp`` x ``--tp`` (x ep) peers, Adam at 5e-3) and, beside
it, a carved :class:`~bluefog_tpu_torch.serve.ServeEngine` of
``--serve-dp`` replicas with a :class:`~bluefog_tpu_torch.serve.
Scheduler`, while a :class:`~bluefog_tpu_torch.serve.WeightRefresher`
pulls fresh weights mid-traffic.  On the card the trainer's attention
runs through the flash kernels K1/K2, every decode step through the
flash-decode kernel K3, and with ``--serve-moe`` the trainer's and the
engine's expert FFNs through the grouped kernel K4 (and K4's hand-written
backward in the trainer).  It grades what the JAX tool grades:

* **tokens/s** of the continuous-batching drain while training advances
  on the same device;
* **p50 / p99 per-token latency**: the 50th and 99th percentiles of the
  ``bluefog_serve_token_latency_seconds`` observations made during the
  timed drain (read from the metric's time-series ring over the drain's
  window; the JAX tool reads the process's histogram, probes included,
  and passes 0.5 / 0.99 to a percentile that takes percent), and TTFT
  p50 / p99 from the completed requests;
* **decode MFU**: JAX's forward decode FLOPs a token (2N weight term,
  active parameters for MoE, plus the exact attention context) over the
  card's 67 TFLOP/s f32 rate outside the tensor cores (the engine serves
  in f32), the card named beside it; null on the CPU;
* **refresh staleness** (max and final of
  ``bluefog_serve_staleness_steps``) and the pull count;
* **invariants**: the KV cache's storage is the same tensor memory after
  the drain (pages are written in place: the port's form of JAX's
  donation check).

With ``--spec-decode`` / ``--prefix-pages`` / ``--kv-dtype`` the fast-path
rows of the JAX tool; with ``--decode-kernel pallas[@block_k]`` a
``decode`` section whose bit-identity probe replays the prompts with K3
forced to its plain version, and whose rows time K3 against that plain
version at context x lanes x KV-dtype points; with ``--serve-moe
E[xK][@EP][:TILE]`` the MoE estate and its ``moe`` section (spec-vs-greedy
identity, tokens/s against the dense twin at equal active parameters,
the router entropy and hot-expert histogram); with ``--traffic-trace
diurnal|flash-crowd`` the bursty phase: the highest serve replica starts
parked and an :class:`~bluefog_tpu_torch.serve.AutoScaler` must grow it
back into the spike, write the scale file in ranks, recover within
``2 x steps`` and fail no request.

Fields with no meaning here are null beside a note: ``retraces`` (the
engine compiles no programs per shape) and the TPU peak.  The MoE
``wire`` proof is the wire-byte ledger over one fused decode call
(:func:`decode_wire_stats`), beside a note on how its counts differ from
the JAX tool's StableHLO counts.  ``kernels`` counts each kernel's
launches over the timed drain and the traffic phase (zero on the CPU,
where every kernel runs its plain version), beside the events the launch
formulas need.

Run:    python -m bluefog_tpu_torch.tools.serve_bench --train-dp 2 \
            --serve-dp 2 --pp 2 [--serve-moe 8x2@2] [--traffic-trace \
            flash-crowd] [--refresh-every 2] [--out f.json]
Smoke:  python -m bluefog_tpu_torch.tools.serve_bench --device cpu --smoke
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from unittest import mock

SCHEMA = "bluefog-torch-serve-bench-1"
LAT = "bluefog_serve_token_latency_seconds"
# H100 SXM, f32 outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_NAME = "H100 SXM f32 (no tensor cores)"
PEAK_FLOPS = 67e12


def _trace_arrivals(shape, steps, slots, rng):
    """Per-step request arrival counts for a synthetic traffic shape.

    ``diurnal``: one full day cycle, midnight troughs and a midday peak
    sized to breach the queue-depth watermark.  ``flash-crowd``: a low
    base rate with a sudden spike of ``3*slots`` requests one third in.
    """
    if shape == "diurnal":
        # peak sized to oversubscribe one replica (forcing the grow) while
        # staying drainable by two before the recovery bound
        hi = max(4, (3 * slots) // 4)
        return [int(round(hi * 0.5 * (1.0 - math.cos(2.0 * math.pi
                                                     * t / steps))))
                for t in range(steps)]
    if shape == "flash-crowd":
        arrivals = [1] * steps
        arrivals[steps // 3] += 3 * slots
        return arrivals
    raise ValueError(f"unknown traffic shape {shape!r}")


def _run_traffic_trace(engine, shape, *, steps, vocab, max_new, rng,
                       slo_p99_ms=None):
    """The bursty phase: a parked reserve replica, arrival-trace traffic,
    and an AutoScaler that must grow into the spike.  Returns the
    artifact's ``trace`` row and the phase's scheduler."""
    from ..diagnostics import SLOEngine
    from ..run.launcher import _read_scale
    from ..serve import AutoScaler, Scheduler
    from ..utils import timeseries as _ts

    sched = Scheduler(engine)
    parked = [sched.replicas - 1] if sched.replicas >= 2 else []
    for r in parked:
        # no traffic yet: a clean park (eligible for re-admission)
        sched.fail_replica(r, reason="parked", park=True)
    scale_file = os.path.join(tempfile.mkdtemp(prefix="bfscale_"),
                              "bluefog_scale")
    # the scaler arms the latency ring: a fresh one, so its trailing p99
    # reads this phase's latencies alone; dropped after unless the caller
    # had armed it (whose earlier history restarts here)
    was_armed = _ts.armed(LAT)
    _ts.disarm(LAT)
    scaler = AutoScaler(
        sched,
        slo_p99_s=(slo_p99_ms / 1000.0) if slo_p99_ms else None,
        queue_high=engine.scfg.slots,       # breach when one replica's
        cooldown_steps=3,                   # worth of slots is waiting
        scale_file=scale_file, min_replicas=1)
    # the SLO engine scores the same phase: burn-rate gauges every step,
    # the fast-burn tripwire when the spike spends the error budget
    slo = SLOEngine(p99_ms=scaler.slo_p99_s * 1000.0)
    sched.attach_slo(slo)
    burn_peak = None
    arrivals = _trace_arrivals(shape, steps, engine.scfg.slots, rng)
    submitted = 0
    grow_step = None
    recovered_step = None
    t = 0

    def _tick():
        nonlocal grow_step, recovered_step, burn_peak
        sched.step()
        rate = slo.last_burn.get(("5m", "p99"))
        if rate is not None and (burn_peak is None or rate > burn_peak):
            burn_peak = rate
        ev = scaler.observe()
        if ev and ev["action"] == "grow" and grow_step is None:
            grow_step = t
        if (grow_step is not None and recovered_step is None
                and sched.pending == 0):
            recovered_step = t

    for t in range(steps):
        for _ in range(arrivals[t]):
            n = int(rng.integers(2, engine.scfg.prefill_buckets[-1] + 1))
            sched.submit(rng.integers(0, vocab, n).tolist(),
                         max_new_tokens=max_new)
            submitted += 1
        _tick()
    while not sched.done:
        t += 1
        if t > steps + 100_000:
            raise RuntimeError("traffic trace failed to drain")
        _tick()

    bound = 2 * steps
    recovery = (recovered_step - grow_step
                if grow_step is not None and recovered_step is not None
                else None)
    # the scale file speaks ranks: live replicas x slice size
    scale_target = _read_scale(scale_file)
    expected_world = len(sched.live_replicas()) * engine.m.slice_size
    row = {
        "shape": shape,
        "steps": steps,
        "parked_replicas": parked,
        "submitted": submitted,
        "completed": len(sched.completed),
        "failed": len(sched.failed),
        "requeued": sched.requeued_total,
        "grow_step": grow_step,
        "recovery_steps": recovery,
        "recovery_bound_steps": bound,
        "slo_p99_s": scaler.slo_p99_s,
        "ewma_p99_s": scaler.ewma_p99,
        "slo": {
            "burn_peak_5m_p99": (round(burn_peak, 3)
                                 if burn_peak is not None else None),
            "burn_final": {f"{w}/{s}": (round(v, 3) if v is not None
                                        else None)
                           for (w, s), v in sorted(slo.last_burn.items())},
            "tripwires": sorted({f["kind"] for f in slo.fired}),
        },
        "scale_events": scaler.events,
        "scale_file_target": scale_target,
        "ranks_per_replica": engine.m.slice_size,
        "expected_world": expected_world,
        "ok": bool(submitted == len(sched.completed)
                   and not sched.failed
                   and grow_step is not None
                   and recovery is not None and recovery <= bound
                   and scale_target == expected_world
                   and (not scaler.events
                        or scale_target ==
                        scaler.events[-1]["target_world"])),
    }
    sched.close()
    if not was_armed:
        _ts.disarm(LAT)
    return row, sched


@contextlib.contextmanager
def plain_decode_attention():
    """K3's two entry points forced to their plain versions (the
    gather-then-attend functions of :mod:`..serve.kv_cache`), so an
    engine call launches no flash-decode kernel."""
    from ..ops import flash_decode as fd
    from ..serve import kv_cache as kv

    def rows(q, kl, vl, slots, lengths, scale=None, *, k_scale=None,
             v_scale=None, prefix_slots=None, prefix_lens=None, block_k=128):
        return kv.attend_rows(q, kl, vl, slots, lengths, scale,
                              k_scale=k_scale, v_scale=v_scale,
                              prefix_slots=prefix_slots,
                              prefix_lens=prefix_lens)

    def chunk(q, cl, slots, lengths, scale=None, *, prefix_slots=None,
              prefix_lens=None, block_k=128):
        return kv.attend_chunk(q, cl, slots, lengths, scale,
                               prefix_slots=prefix_slots,
                               prefix_lens=prefix_lens)
    with mock.patch.object(fd, "flash_attend_rows", rows), \
            mock.patch.object(fd, "flash_attend_chunk", chunk):
        yield


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _decode_attend_bench(scfg, heads, head_dim, *, dev, block_k, iters):
    """Decode-MFU-at-context rows: one new token per lane over a
    slot-paged cache at context x lanes x KV-dtype points, K3 against its
    plain version on the same pages (host wall time with a device sync;
    MFU null off the card)."""
    import numpy as np
    import torch
    from ..ops import flash_decode as fd
    from ..serve import kv_cache as kv

    L, n_rows = scfg.max_len, scfg.slots + 1
    rng = np.random.default_rng(0)
    contexts = sorted({max(1, L // 4), max(1, L // 2), L})
    lanes = sorted({1, max(1, scfg.slots // 2), scfg.slots})
    dtypes = ["raw"] + ([scfg.kv_dtype] if scfg.kv_dtype != "raw" else [])

    def _time(fn, args, kw):
        fn(*args, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kw)
        _sync(dev)
        return (time.perf_counter() - t0) / iters

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    on_card = dev.type == "cuda"
    rows = []
    for store in dtypes:
        kraw = t(rng.normal(size=(n_rows, heads, L, head_dim)))
        vraw = t(rng.normal(size=(n_rows, heads, L, head_dim)))
        if store == "raw":
            kl, vl, ksc, vsc = kraw, vraw, None, None
        else:
            kl, ksc = kv.quantize_rows(kraw, store)
            vl, vsc = kv.quantize_rows(vraw, store)
        for ctx in contexts:
            for S in lanes:
                q = t(rng.normal(size=(S, heads, head_dim)))
                slots = torch.arange(S, dtype=torch.int32, device=dev)
                lens = torch.full((S,), ctx - 1, dtype=torch.int32,
                                  device=dev)
                args = (q, kl, vl, slots, lens)
                kw = dict(k_scale=ksc, v_scale=vsc)
                wall = _time(fd.flash_attend_rows, args,
                             dict(kw, block_k=block_k))
                plain = _time(kv.attend_rows, args, kw)
                flops = 4.0 * S * heads * head_dim * ctx
                rows.append({
                    "kv_dtype": store,
                    "context": int(ctx),
                    "lanes": int(S),
                    "wall_us": round(wall * 1e6, 2),
                    "plain_wall_us": round(plain * 1e6, 2),
                    "attn_flops": flops,
                    "flops_per_sec": round(flops / wall, 1) if wall else None,
                    "mfu": (flops / wall / PEAK_FLOPS
                            if on_card and wall else None),
                })
    return rows


def _launch_counts():
    """Every kernel wrapper's launch count (each adds one where it
    launches its kernel; the plain versions count nothing)."""
    from ..ops import flash_attention as fa
    from ..ops import flash_decode as fd
    from ..ops import grouped_ffn as gf
    return {"flash_fwd": fa.fwd_launches, "flash_bwd": fa.bwd_launches,
            "flash_decode": fd.flash_decode_cuda.launches,
            "grouped_ffn": gf.grouped_ffn_cuda.launches,
            "grouped_ffn_backward_plan": gf.backward_plan_cuda.launches,
            "grouped_ffn_dgrad": gf.grouped_ffn_dgrad_cuda.launches,
            "grouped_ffn_wgrad": gf.grouped_ffn_wgrad_cuda.launches}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (implied on the CPU)")
    ap.add_argument("--train-dp", type=int, default=2,
                    help="training gossip-DP replicas")
    ap.add_argument("--serve-dp", type=int, default=2,
                    help="serving replicas (engine gossip-DP axis)")
    ap.add_argument("--pp", type=int, default=1, help="pipeline stages")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None,
                    help="concurrent requests to drain (default 16)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens generated per request (default 8)")
    ap.add_argument("--buckets", default=None,
                    help="'<batch,..>@<prompt_len,..>' serve shape buckets "
                         "(default from BLUEFOG_SERVE_BUCKETS or 1,2,4@8,16)")
    ap.add_argument("--slots", type=int, default=None,
                    help="KV slots per replica (default 8)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV rows per slot (default 64)")
    ap.add_argument("--decode-steps-per-call", type=int, default=None,
                    help="fused decode steps per engine call (default 2)")
    ap.add_argument("--spec-decode", default=None,
                    help="self-speculative decoding: '<k>' or '<k>@<stages>'"
                         " draft depth / draft pipeline stages (default off)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("raw", "int8", "fp8"),
                    help="KV page storage (default raw)")
    ap.add_argument("--prefix-pages", default=None,
                    help="shared prefix pages: '<pages>' or "
                         "'<pages>x<page_tokens>' (default off)")
    ap.add_argument("--decode-kernel", default=None,
                    help="'xla' or 'pallas' or 'pallas@<block_k>': the "
                         "JAX config's token; 'pallas' adds the decode "
                         "section (default xla)")
    ap.add_argument("--serve-moe", default=None,
                    help="MoE estate: '<experts>[x<top_k>][@<ep>][:<tile>]'"
                         " e.g. '4x2@2:4' (default BLUEFOG_SERVE_MOE or "
                         "dense)")
    ap.add_argument("--traffic-trace", default=None,
                    choices=("diurnal", "flash-crowd"),
                    help="bursty traffic phase with a parked reserve "
                         "replica + SLO-driven autoscaling")
    ap.add_argument("--trace-steps", type=int, default=None,
                    help="scheduler steps in the traffic trace (default 24)")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="autoscaler p99 SLO (default BLUEFOG_SLO_P99_MS "
                         "or 250)")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="train steps interleaved with serving (default 6)")
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="pull fresh weights every N train steps "
                         "(default from BLUEFOG_REFRESH_EVERY or 2)")
    ap.add_argument("--out", default=None, help="json artifact path")
    return ap.parse_args(argv)


def decode_wire_stats(engine) -> dict:
    """The wire-byte ledger's ICI-vs-DCN split of one fused decode call
    at the engine's largest batch bucket, every lane idle (the trash
    slot), as the JAX tool classifies ``decode_lowered_text()``."""
    import numpy as np

    from ..utils import wire_bytes as _wb
    S = engine.scfg.batch_buckets[-1]
    tok, slot, ln = engine.idle_lane()

    def full(v):
        return np.full((engine.replicas, S), v, np.int32)
    with _wb.ledger(engine.m.slice_size) as led:
        engine.decode(full(tok), full(slot), full(ln))
    stats = led.stablehlo_wire_stats()
    stats["slice_size"] = engine.m.slice_size
    return stats


def run(argv=None):
    """Run the estate; returns ``(doc, state)``, ``state`` holding the
    engine, the drain's scheduler and requests, the refresher, the
    carvings and the trained params for callers that check further.
    The tracer, armed for the run, is left as the caller had it."""
    from ..utils import tracing as _tracing
    prev = _tracing._dir if _tracing.enabled() else None
    try:
        return _run(argv)
    finally:
        _tracing.configure(prev)


def _run(argv):
    args = _parse(argv)
    if args.serve_moe is None:
        args.serve_moe = os.environ.get("BLUEFOG_SERVE_MOE") or None

    import numpy as np
    import torch

    from .. import optimizers as bfopt
    from ..device import resolve_device
    from ..moe import model as moe_model
    from ..parallel import compose
    from ..serve import ServeConfig, ServeEngine, Scheduler, WeightRefresher
    from ..serve.engine import _parse_buckets, _parse_serve_moe
    from ..utils import metrics as bfm
    from ..utils import timeseries as _ts
    from ..utils import tracing as _tracing
    from . import trace_report

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    smoke = args.smoke or not on_card
    layers = args.layers or (args.pp * 2)
    d_model = args.d_model or (32 if smoke else 1024)
    heads = args.heads or (4 if smoke else 16)
    vocab = args.vocab or (64 if smoke else 32768)
    n_requests = args.requests or 16
    max_new = args.max_new or 8
    slots = args.slots or 8
    max_len = args.max_len or 64
    steps_per_call = args.decode_steps_per_call or 2
    train_steps = args.train_steps if args.train_steps is not None else 6
    refresh_every = args.refresh_every
    if refresh_every is None and smoke and "BLUEFOG_REFRESH_EVERY" not in \
            os.environ:
        refresh_every = 2

    # arm request tracing before any scheduler exists so every request
    # gets a span tree (BLUEFOG_TRACE wins if the operator set it)
    trace_dir = os.environ.get(_tracing.ENV_TRACE) or tempfile.mkdtemp(
        prefix="bftrace_")
    _tracing.configure(trace_dir)

    lm_kw = dict(vocab=vocab, d_model=d_model, heads=heads, layers=layers,
                 seq_len=32 if smoke else 128, micro=max(2 * args.pp, 2))
    moe_ep = 1
    if args.serve_moe:
        moe_E, moe_k, moe_ep, moe_tile = _parse_serve_moe(args.serve_moe)
        cfg = moe_model.MoELMConfig(batch=2 * moe_ep, num_experts=moe_E,
                                    top_k=moe_k, dispatch="dropless",
                                    **lm_kw)
        carve = dict(num_experts=moe_E)
    else:
        cfg = compose.LMConfig(batch=2, **lm_kw)
        carve = {}
    train_m = compose.compose_parallelism(args.train_dp, args.pp, args.tp, 1,
                                          moe_ep, device=dev, **carve)
    serve_m = compose.compose_parallelism(args.serve_dp, args.pp, args.tp, 1,
                                          moe_ep, device=dev, **carve)
    cfg.validate(train_m)
    slice_sz = train_m.slice_size

    sc_kw = dict(slots=slots, max_len=max_len,
                 decode_steps_per_call=steps_per_call)
    if args.spec_decode:
        k_s, _, st_s = args.spec_decode.partition("@")
        sc_kw["spec_decode"] = int(k_s)
        if st_s:
            sc_kw["spec_stages"] = int(st_s)
    if args.kv_dtype:
        sc_kw["kv_dtype"] = args.kv_dtype
    if args.decode_kernel:
        kern, _, bk_s = args.decode_kernel.partition("@")
        sc_kw["decode_kernel"] = kern       # ServeConfig validates the token
        if bk_s:
            sc_kw["decode_block_k"] = int(bk_s)
    if args.prefix_pages:
        pg_s, _, pt_s = args.prefix_pages.partition("x")
        sc_kw["prefix_pages"] = int(pg_s)
        if pt_s:
            sc_kw["prefix_page_tokens"] = int(pt_s)
    if args.serve_moe:
        sc_kw.update(moe_experts=moe_E, moe_top_k=moe_k, moe_ep=moe_ep,
                     moe_tile=moe_tile)
    if args.buckets:
        bb, pb = _parse_buckets(args.buckets)
        scfg = ServeConfig(batch_buckets=bb, prefill_buckets=pb, **sc_kw)
    else:
        scfg = ServeConfig.from_env(**sc_kw)

    # -- training fleet ------------------------------------------------
    if args.serve_moe:
        grad_fn = moe_model.make_moe_grad_fn(cfg, train_m)
        train_params = moe_model.init_moe_train_params(cfg, train_m, seed=1)
        toks = moe_model.make_moe_batch(cfg, train_m)
        load = moe_model.moe_params_from_jax
        init_tree = moe_model.init_moe_train_params
    else:
        grad_fn = compose.make_lm_grad_fn(cfg, train_m)
        train_params = compose.init_lm_train_params(cfg, train_m, seed=1)
        toks = compose.make_lm_batch(cfg, train_m)
        load = compose.params_from_jax
        init_tree = compose.init_lm_train_params
    step, strategy = compose.make_train_step(train_m, grad_fn,
                                             bfopt.adam(5e-3))
    state = bfopt.init_distributed(strategy, train_params)

    # -- serving fleet -------------------------------------------------
    serve_params = load(init_tree(cfg, serve_m, seed=0), cfg, m=serve_m)
    engine = ServeEngine(cfg, serve_params, scfg, device=dev)
    engine.warmup()

    rng = np.random.default_rng(0)

    def _drain_tokens(eng, prompts):
        """Drain ``prompts`` through a throwaway scheduler; the requests
        (a probe harness, closed before the timed drain)."""
        s = Scheduler(eng)
        reqs = [s.submit(p, max_new_tokens=max_new) for p in prompts]
        s.drain()
        s.close()
        return reqs

    def _prompts(n):
        return [rng.integers(0, vocab, int(rng.integers(
            2, scfg.prefill_buckets[-1] + 1))).tolist() for _ in range(n)]

    # probe (a): speculative identity against a plain-greedy engine
    spec_probe = None
    if scfg.spec_decode:
        probe_prompts = _prompts(3)
        ref_eng = ServeEngine(cfg, serve_params,
                              dataclasses.replace(scfg, spec_decode=0),
                              device=dev)
        ref_eng.warmup()
        ref = [r.generated for r in _drain_tokens(ref_eng, probe_prompts)]
        got = [r.generated for r in _drain_tokens(engine, probe_prompts)]
        spec_probe = {"prompts": len(probe_prompts),
                      "bit_identical": bool(ref == got)}
        del ref_eng

    # probe (b): prefix-hit TTFT, an identical prompt submitted twice
    prefix_probe = None
    shared = None
    if scfg.prefix_pages:
        ptoks = scfg.prefix_page_tokens
        shared = rng.integers(0, vocab, ptoks).tolist()
        probe_prompt = shared + rng.integers(
            0, vocab, max(1, min(4, scfg.prefill_buckets[-1] - ptoks))
        ).tolist()
        cold = _drain_tokens(engine, [probe_prompt])[0]
        hit = _drain_tokens(engine, [probe_prompt])[0]
        prefix_probe = {
            "ttft_cold_s": round(cold.ttft, 6),
            "ttft_hit_s": round(hit.ttft, 6),
            "hit_prefix_len": hit.prefix_len,
            "hit_faster": bool(hit.ttft < cold.ttft),
            "tokens_identical": bool(cold.generated == hit.generated)}

    # probe (c): K3 against its plain version, same prompts and weights
    flash_probe = None
    if scfg.decode_kernel == "pallas":
        probe_prompts = _prompts(3)
        with plain_decode_attention():
            ref = [r.generated for r in _drain_tokens(engine, probe_prompts)]
        got = [r.generated for r in _drain_tokens(engine, probe_prompts)]
        flash_probe = {"prompts": len(probe_prompts),
                       "reference": "K3's plain version",
                       "bit_identical": bool(ref == got)}

    # probe (d): MoE serving, spec identity and the dense twin
    moe_probe = None
    if args.serve_moe:
        def _timed_tps(eng, prompts):
            before = bfm.counter("bluefog_tokens_generated_total").total()
            w0 = time.perf_counter()
            _drain_tokens(eng, prompts)
            _sync(dev)
            wall = time.perf_counter() - w0
            made = bfm.counter(
                "bluefog_tokens_generated_total").total() - before
            return (made / wall) if wall > 0 else None

        moe_prompts = _prompts(8)
        if spec_probe is not None:
            bit = dict(spec_probe)          # spec-MoE vs plain-greedy MoE
        else:
            spec_eng = ServeEngine(
                cfg, serve_params,
                dataclasses.replace(scfg, spec_decode=2, spec_stages=1),
                device=dev)
            spec_eng.warmup()
            got = [r.generated
                   for r in _drain_tokens(spec_eng, moe_prompts[:3])]
            ref = [r.generated
                   for r in _drain_tokens(engine, moe_prompts[:3])]
            bit = {"prompts": 3, "bit_identical": bool(ref == got)}
            del spec_eng
        # the fair baseline: same skeleton, ffn_mult scaled by top_k
        dense_cfg = cfg.dense_twin()
        dense_m = compose.compose_parallelism(args.serve_dp, args.pp,
                                              args.tp, device=dev)
        dense_eng = ServeEngine(
            dense_cfg, compose.params_from_jax(
                compose.init_lm_train_params(dense_cfg, dense_m, seed=0),
                dense_cfg, m=dense_m),
            dataclasses.replace(scfg, moe_experts=0, moe_top_k=1,
                                moe_ep=1, moe_tile=0), device=dev)
        dense_eng.warmup()
        moe_tps = _timed_tps(engine, moe_prompts)
        dense_tps = _timed_tps(dense_eng, moe_prompts)
        del dense_eng
        moe_probe = {"bit": bit, "tps_moe": moe_tps, "tps_dense": dense_tps,
                     "dense_n_params": dense_cfg.n_params,
                     "wire": decode_wire_stats(engine)}

    refresher = WeightRefresher(engine, train_m, every=refresh_every)
    sched = Scheduler(engine)
    cache_ptrs = {k: v.data_ptr() for k, v in engine.cache.items()}

    spec0 = {n: bfm.counter(n).total() for n in
             ("bluefog_serve_spec_drafted_total",
              "bluefog_serve_spec_accepted_total")}
    hitmiss0 = {n: bfm.counter(n).total() for n in
                ("bluefog_serve_prefix_hits_total",
                 "bluefog_serve_prefix_misses_total")}
    tokens0 = bfm.counter("bluefog_tokens_generated_total").total()

    prompt_lens = []
    requests = []
    for i in range(n_requests):
        if shared is not None and i % 2 == 0:
            # half the traffic reuses one system prompt: its page seals
            # once per replica, then every admission is a remainder chunk
            room = scfg.prefill_buckets[-1] - len(shared)
            p = shared + rng.integers(
                0, vocab, int(rng.integers(1, room + 1))).tolist()
        else:
            n = int(rng.integers(2, scfg.prefill_buckets[-1] + 1))
            p = rng.integers(0, vocab, n).tolist()
        prompt_lens.append(len(p))
        requests.append(sched.submit(p, max_new_tokens=max_new))

    # -- interleaved drain: serve steps with training advancing live ----
    stal_max, pulls, train_done, train_s = 0.0, 0, 0, 0.0
    stal_after_pull = []
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    launches0 = _launch_counts()
    # the drain's own latency observations, stamped (disarmed after, as
    # the JAX tool's traffic phase arms the ring itself, empty)
    was_armed = _ts.armed(LAT)
    _ts.arm(LAT)
    m0 = time.monotonic()
    t0 = time.perf_counter()
    guard = 0
    while not sched.done:
        guard += 1
        if guard > 100_000:
            raise RuntimeError("scheduler failed to drain")
        sched.step()
        if train_done < train_steps:
            s0 = time.perf_counter()
            train_params, state, _ = step(train_params, state, toks)
            _sync(dev)
            train_s += time.perf_counter() - s0
            train_done += 1
            refresher.note_train_step(train_done)
            stal_max = max(stal_max, refresher.staleness() or 0.0)
            if refresher.maybe_refresh(train_params, train_done):
                pulls += 1
                stal_after_pull.append(refresher.staleness())
    _sync(dev)
    dt = time.perf_counter() - t0
    m1 = time.monotonic()
    drain_launches = _delta(_launch_counts(), launches0)
    lat_pct = {q: _ts.percentile(LAT, q, window_s=m1 - m0, now=m1)
               for q in (50, 99)}
    n_lat = len(_ts.history(LAT, m1 - m0, m1))
    if not was_armed:
        _ts.disarm(LAT)
    stal_final = refresher.staleness()
    peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else None
    cache_intact = all(engine.cache[k].data_ptr() == p
                       for k, p in cache_ptrs.items())

    # the probes generate tokens too: tokens/s reads the drain's delta
    tokens = int(bfm.counter("bluefog_tokens_generated_total").total()
                 - tokens0)
    tok_per_sec = tokens / dt if dt > 0 else None
    drain_events = {"train_steps": train_done,
                    "decode_calls": sched.decode_calls,
                    "decode_steps": sched.decode_steps,
                    "prefills": len(sched.completed) + sched.requeued_total,
                    "pulls": pulls}

    # -- bursty traffic + autoscaling phase ----------------------------
    trace_doc = trace_kernels = None
    if args.traffic_trace:
        l0 = _launch_counts()
        trace_doc, tsched = _run_traffic_trace(
            engine, args.traffic_trace, steps=args.trace_steps or 24,
            vocab=vocab, max_new=max_new, rng=rng,
            slo_p99_ms=args.slo_p99_ms)
        _sync(dev)
        trace_kernels = {
            "launches": _delta(_launch_counts(), l0),
            "events": {"train_steps": 0,
                       "decode_calls": tsched.decode_calls,
                       "decode_steps": tsched.decode_steps,
                       "prefills": (len(tsched.completed)
                                    + tsched.requeued_total)}}

    ttfts = sorted(r.ttft for r in sched.completed if r.ttft is not None)

    # decode FLOPs/token: the forward weight term + the exact attention
    # context each generated token attended over (score + value matmuls)
    n_tok, ctx_sum = 0, 0
    for req in sched.completed:
        p = len(req.prompt)
        for i in range(len(req.generated)):
            n_tok += 1
            ctx_sum += p + i
    avg_ctx = (ctx_sum / n_tok) if n_tok else 0.0
    # MoE: the weight term counts active params only (top-k experts)
    n_weight = getattr(cfg, "n_active_params", cfg.n_params)
    decode_flops_per_token = (2.0 * n_weight
                              + 4.0 * cfg.layers * cfg.d_model * avg_ctx)
    peak = PEAK_FLOPS if on_card else None
    device_name = (torch.cuda.get_device_name(dev) if on_card
                   else str(dev))

    # -- fast-path rows --------------------------------------------------
    spec_doc = None
    if scfg.spec_decode:
        drafted = int(bfm.counter("bluefog_serve_spec_drafted_total").total()
                      - spec0["bluefog_serve_spec_drafted_total"])
        accepted = int(
            bfm.counter("bluefog_serve_spec_accepted_total").total()
            - spec0["bluefog_serve_spec_accepted_total"])
        spec_doc = {
            "k": scfg.spec_decode,
            "stages": scfg.spec_stages,
            "cost_fraction": round(engine.draft.cost_fraction, 4),
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": (round(accepted / drafted, 4)
                                if drafted else None),
            "accepted_tokens_per_sec": (round(accepted / dt, 1)
                                        if dt > 0 else None),
            **spec_probe,
        }
    prefix_doc = None
    if scfg.prefix_pages:
        hits = int(bfm.counter("bluefog_serve_prefix_hits_total").total()
                   - hitmiss0["bluefog_serve_prefix_hits_total"])
        misses = int(bfm.counter("bluefog_serve_prefix_misses_total").total()
                     - hitmiss0["bluefog_serve_prefix_misses_total"])
        prefix_doc = {"pages": scfg.prefix_pages,
                      "page_tokens": scfg.prefix_page_tokens,
                      "hits": hits, "misses": misses, **prefix_probe}
    kv_doc = None
    if engine.cache_cfg.quantized:
        bpt = engine.cache_cfg.bytes_per_token()
        raw_bpt = dataclasses.replace(
            engine.cache_cfg, store="raw").bytes_per_token()
        kv_doc = {"dtype": scfg.kv_dtype, "bytes_per_token": bpt,
                  "raw_bytes_per_token": raw_bpt,
                  "ratio": round(bpt / raw_bpt, 4)}

    decode_doc = None
    if scfg.decode_kernel == "pallas":
        decode_doc = {
            "kernel": scfg.decode_kernel,
            "block_k": scfg.decode_block_k,
            **flash_probe,
            "attend": _decode_attend_bench(
                scfg, heads, d_model // heads, dev=dev,
                block_k=scfg.kernel_block_k, iters=3 if smoke else 20),
        }

    moe_doc = None
    if moe_probe is not None:
        live = [row for row in (engine.moe_load() or []) if row["tokens"]]
        hist = (np.mean([row["fractions"] for row in live], axis=0)
                if live else np.zeros(scfg.moe_experts))
        tps_m, tps_d = moe_probe["tps_moe"], moe_probe["tps_dense"]
        moe_doc = {
            "experts": scfg.moe_experts,
            "top_k": scfg.moe_top_k,
            "ep": scfg.moe_ep,
            "tile": engine._moe_tile,
            "n_params_total": cfg.n_params,
            "n_params_active": cfg.n_active_params,
            "dense_twin_n_params": moe_probe["dense_n_params"],
            "tokens_per_sec_moe": round(tps_m, 1) if tps_m else None,
            "tokens_per_sec_dense_twin": (round(tps_d, 1)
                                          if tps_d else None),
            "vs_dense_equal_active": (round(tps_m / tps_d, 4)
                                      if tps_m and tps_d else None),
            "serve_devices": 1,
            "bit_identity": moe_probe["bit"],
            "router_entropy_mean": (round(float(np.mean(
                [row["entropy"] for row in live])), 4) if live else None),
            "hot_expert": {
                "counts": [int(c) for c in (np.sum(
                    [row["counts"] for row in live], axis=0) if live
                    else np.zeros(scfg.moe_experts))],
                "fractions": [round(float(f), 4) for f in hist],
                "max_fraction": (round(float(hist.max()), 4)
                                 if len(hist) else None),
            },
            "wire": moe_probe["wire"],
            "wire_note": "the wire-byte ledger over one fused decode call "
                         "at the largest bucket (idle lanes): every call "
                         "the decode makes (its layers and decode steps), "
                         "where the JAX tool counts the lowered program's "
                         "static collectives; the dispatch's all_to_alls "
                         "stay inside a replica (ICI), none is DCN",
        }

    # -- per-request latency breakdown from the tracer -----------------
    breakdown_doc = None
    bundle = _tracing.flush()
    if bundle:
        # the drain's own requests: the bundle also holds the probes' and
        # the trace phase's (and any earlier run's in this process)
        tr_doc, _ = trace_report.report_from_files([bundle])
        drain_ids = {r.trace_id for r in requests}
        reqs_tr = {t: v for t, v in tr_doc["requests"].items()
                   if t in drain_ids}
        if reqs_tr:
            def _mean(key):
                return round(sum(v[key] for v in reqs_tr.values())
                             / len(reqs_tr), 6)
            breakdown_doc = {
                "n_requests": len(reqs_tr),
                "queue_mean_s": _mean("queue_s"),
                "prefill_mean_s": _mean("prefill_s"),
                "decode_mean_s": _mean("decode_s"),
                "gap_mean_s": _mean("gap_s"),
                "slowest": [[t, round(total, 6)] for t, total, *_ in
                            tr_doc["critical_path"] if t in drain_ids][:5],
                "bundle": bundle,
            }

    def pct(q):
        return round(lat_pct[q], 6) if lat_pct[q] is not None else None

    def ttft_at(q):
        if not ttfts:
            return None
        return round(ttfts[min(len(ttfts) - 1, int(q * len(ttfts)))], 6)

    doc = {
        "schema": SCHEMA,
        "ok": True,
        "on_accelerator": on_card,
        "device": device_name,
        "serve": {"replicas": args.serve_dp, "pp": args.pp, "tp": args.tp,
                  "slots": slots, "max_len": max_len,
                  "decode_steps_per_call": steps_per_call,
                  "batch_buckets": list(scfg.batch_buckets),
                  "prefill_buckets": list(scfg.prefill_buckets),
                  "kv_dtype": scfg.kv_dtype,
                  "kv_cache_bytes": engine.cache_cfg.bytes(),
                  "kv_bytes_per_token": engine.cache_cfg.bytes_per_token()},
        "train": {"replicas": args.train_dp, "steps": train_done,
                  "s_per_step": (round(train_s / train_done, 6)
                                 if train_done else None)},
        "config": {"d_model": d_model, "heads": heads, "layers": layers,
                   "vocab": vocab, "n_params": cfg.n_params},
        "requests": {"submitted": n_requests,
                     "completed": len(sched.completed),
                     "failed": len(sched.failed),
                     "max_new_tokens": max_new,
                     "tokens_generated": tokens,
                     "avg_prompt_len": round(float(np.mean(prompt_lens)), 2)},
        "wall_s": round(dt, 4),
        "tokens_per_sec": round(tok_per_sec, 1) if tok_per_sec else None,
        "latency": {
            "per_token_p50_s": pct(50),
            "per_token_p99_s": pct(99),
            "per_token_observations": n_lat,
            "ttft_p50_s": ttft_at(0.5),
            "ttft_p99_s": ttft_at(0.99),
            "ttft_max_s": round(ttfts[-1], 6) if ttfts else None,
        },
        "mfu": {"decode_flops_per_token": round(decode_flops_per_token, 1),
                "avg_context": round(avg_ctx, 1),
                "model_flops_per_sec": (
                    round(tok_per_sec * decode_flops_per_token, 1)
                    if tok_per_sec else None),
                "peak_flops_per_device": peak,
                "peak_name": PEAK_NAME if on_card else None,
                "mfu": (tok_per_sec * decode_flops_per_token / peak
                        if peak and tok_per_sec else None),
                "tpu_peak": None,
                "tpu_peak_note": "the JAX tool's TPU roofline has no "
                                 "meaning on this device"},
        "refresh": {"every": refresher.every, "pulls": pulls,
                    "staleness_max_steps": stal_max,
                    "staleness_final_steps": stal_final,
                    "staleness_after_each_pull": stal_after_pull},
        "memory": {"peak_bytes": peak_bytes},
        "spec": spec_doc,
        "prefix": prefix_doc,
        "kv": kv_doc,
        "decode": decode_doc,
        "moe": moe_doc,
        "trace": trace_doc,
        "latency_breakdown": breakdown_doc,
        "kernels": {"drain": {"launches": drain_launches,
                              "events": drain_events},
                    "trace": trace_kernels},
        "invariants": {
            "cache_in_place": cache_intact,
            "retraces_after_warmup": None,
            "retraces_note": "the engine runs eager kernels at declared "
                             "buckets and compiles nothing per shape, so "
                             "there is no retrace to count",
        },
    }
    fast_ok = True
    if spec_doc is not None:
        fast_ok &= spec_doc["bit_identical"]
    if prefix_doc is not None:
        fast_ok &= bool(prefix_doc["hit_faster"]
                        and prefix_doc["tokens_identical"]
                        and prefix_doc["hits"] >= 1)
    if kv_doc is not None and scfg.kv_dtype == "int8":
        fast_ok &= kv_doc["ratio"] <= 0.5
    if decode_doc is not None:
        fast_ok &= decode_doc["bit_identical"]
    if moe_doc is not None:
        fast_ok &= bool(moe_doc["bit_identity"]["bit_identical"]
                        and moe_doc["tokens_per_sec_moe"]
                        and moe_doc["tokens_per_sec_dense_twin"])
    doc["ok"] = bool(len(sched.completed) == n_requests
                     and not sched.failed
                     and cache_intact
                     and fast_ok
                     and (trace_doc is None or trace_doc["ok"])
                     and (train_steps == 0 or pulls >= 1))
    sched.close()
    out = {"engine": engine, "sched": sched, "requests": requests,
           "refresher": refresher, "train_m": train_m, "serve_m": serve_m,
           "cfg": cfg, "train_params": train_params, "scfg": scfg}
    _emit(doc, args.out)
    return doc, out


def _emit(doc, out):
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
