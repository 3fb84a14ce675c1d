"""Decentralized LM training benchmark (counterpart of ``tools/lm_bench.py``).

Trains the composed LM at the carving ``--dp`` x ``--pp`` x ``--tp`` x
``--sp`` x ``--ep`` (the JAX tool's defaults: 2 x 2 x 2 x 1 x 1), every
peer stacked on
one device: gossip over the ``dp`` replicas (``adapt_with_combine`` over
``ExponentialTwoGraph(dp)``, ``delayed`` unless ``--no-delayed``, Adam at
5e-3; ``--wire`` names the gossip's codec, as in the JAX tool), GPipe
stages, Megatron tp and Ulysses sp inside each replica.  It
prints one JSON line: per-step time, tokens per second (``dp x micro x
batch x seq`` tokens a step), the first and last mean loss, the
carving's ``describe()``, the config, the peak device memory, and
``mfu`` (``flops_per_token`` from ``LMConfig.flops_per_token`` over the
H100's f32 rate outside the tensor cores, since the model trains in f32
without TF32).  On a CUDA device attention runs through the K1/K2 flash
kernels; the JSON names the device the numbers were taken on, and a CPU
run reports no MFU and no memory.

``--moe`` trains the routed-MoE LM instead
(:mod:`bluefog_tpu_torch.moe.model`; ``--ep`` adds the expert axis;
``--experts`` / ``--top-k`` / ``--group-tile`` / ``--capacity-factor`` /
``--router`` default from the ``BLUEFOG_MOE_*`` env knobs as in the JAX
tool): capacity dispatch by default, ``--dropless`` for the sort-based
grouped dispatch (every expert FFN through the grouped kernel K4 and its
hand-written backward on the card), ``--router expert_choice`` (with
``--dropless``, sp 1) for expert-choice routing.  The JSON then carries
the JAX tool's ``moe`` block, with the analytic grouped-GEMM rows per
peer and sublayer of the dropless run against the capacity path
(``rows_per_device``), its routing-health values read off
:func:`~bluefog_tpu_torch.moe.model.make_moe_probe` after the timed run,
and the MFU counts the active parameters (``n_active_params``,
``mfu.flops_source`` "active").  ``--ep`` > 1 without ``--moe`` is
refused, as are ``--dropless``, ``--router`` and ``--group-tile``
without it (exit code 2, the JAX texts).

Run:    python -m bluefog_tpu_torch.tools.lm_bench [--pp 2 --tp 2 | --sp 2]
        python -m bluefog_tpu_torch.tools.lm_bench --moe --dropless --top-k 2
        python -m bluefog_tpu_torch.tools.lm_bench --moe --dropless --pp 1 \
            --tp 1 --ep 2
Smoke:  python -m bluefog_tpu_torch.tools.lm_bench --device cpu [--moe
        [--dropless [--router expert_choice]] [--ep 2]]

``--chaos 'throttle:from=2,until=99,t=0.05,rank=5'`` installs a chaos
plan (``utils/chaos.py``) for the live run and ``--flight-dir DIR``
dumps the flight bundle there after it (``flight_rank0.json``, the
``flight_bundle`` key), as in the JAX tool: ``tools/postmortem.py`` must
blame the throttled rank.  With either one the tool initializes the
context over every stacked peer (``dp x pp x tp x sp x ep`` ranks) and
runs the step wrapper's consensus probe every 2 calls (JAX's
``metrics_every_k=2``), which carries the per-rank step-time table into
the flight ring; ``--chaos`` adds the ``straggler`` block
(``detected_ranks``, ``step_times_s``).  Without them no probe runs (the
JAX tool probes always; here the probe's flat copy of every peer's
params would not fit beside the MoE trainer at its full width).

The JAX tool's ``wire_bytes`` block (ICI-vs-DCN collective bytes per
chip, with their dtypes) comes from the wire-byte ledger
(:mod:`bluefog_tpu_torch.utils.wire_bytes`) over the first warm-up call,
one step's share of it (the JAX tool counts the lowered program's
collectives; the ledger counts every call the step makes, so its ICI
bytes include the pipeline ticks' and layers' trips, and its DCN bytes,
the gossip, are the JAX tool's).  ``wire_sweep`` repeats that for the
codecs None, bf16, fp8@64 and ``--wire``, each one step of a fresh
trainer from the same params (``--no-sweep`` or dp 1 skip it).

Left out of the JAX tool (XLA features or later slices): the
profiler-trace overlap grading, the retrace sentinel, and in the ``moe``
block ``dot_flops`` (the JAX tool counts the ``dot_general`` FLOPs of the
lowered StableHLO; the port lowers no program; its analytic rows are
kept as ``rows_per_device``) and ``per_step_s_capacity`` (the timed
capacity twin): both stay null.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import diagnostics as bfdiag
from .. import optimizers as bfopt
from ..device import resolve_device
from ..fusion import tree_map
from ..moe import model as moe_model
from ..parallel import compose
from ..utils import wire_bytes as _wb

SCHEMA = "bluefog-torch-lm-bench-1"
# H100 SXM, f32 outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_NAME = "H100 SXM f32 (no tensor cores)"
PEAK_FLOPS = 67e12


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2,
                    help="gossip-DP replicas, stacked on one device")
    ap.add_argument("--pp", type=int, default=2, help="pipeline stages")
    ap.add_argument("--tp", type=int, default=2, help="tensor-parallel ways")
    ap.add_argument("--sp", type=int, default=1,
                    help="Ulysses sequence ways")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel ways (requires --moe)")
    ap.add_argument("--wire", default=None,
                    help="gossip DCN codec (bf16 / fp8 / fp8@64 / int8@...)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 2048; smoke 32)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--micro", type=int, default=None,
                    help="microbatches per step (pipeline fill)")
    ap.add_argument("--batch", type=int, default=None,
                    help="per-microbatch batch size")
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--steps-per-call", type=int, default=None)
    ap.add_argument("--no-delayed", action="store_true",
                    help="bulk-synchronous gossip instead of the one-step-"
                         "delayed mixing")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the wire-codec sweep (one step a codec)")
    ap.add_argument("--moe", action="store_true",
                    help="train the routed-MoE LM instead of the dense one")
    ap.add_argument("--experts", type=int, default=None,
                    help="total experts (default BLUEFOG_MOE_EXPERTS or 8)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="router top-k, 1 or 2 (default BLUEFOG_MOE_TOPK)")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="expert capacity factor (default "
                         "BLUEFOG_MOE_CAPACITY_FACTOR or 1.25)")
    ap.add_argument("--dropless", action="store_true",
                    help="dropless grouped dispatch instead of the padded "
                         "capacity path (requires --moe)")
    ap.add_argument("--router", choices=("topk", "expert_choice"),
                    default=None,
                    help="routing mode (default BLUEFOG_MOE_ROUTER or "
                         "topk; expert_choice requires --dropless, sp=1)")
    ap.add_argument("--group-tile", type=int, default=None,
                    help="dropless grouped-GEMM tile rows (default "
                         "BLUEFOG_MOE_TILE or 8)")
    ap.add_argument("--pallas", action="store_true",
                    help="flash attention on the CPU too (the kernels' "
                         "plain versions); on CUDA it always runs")
    ap.add_argument("--chaos", default=None,
                    help="BLUEFOG_CHAOS plan for the live run, e.g. "
                         "'throttle:from=2,until=99,t=0.05,rank=5'")
    ap.add_argument("--flight-dir", default=None,
                    help="dump the flight bundle here after the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda); 'cpu' implies the "
                         "smoke shape")
    return ap.parse_args(argv)


def _refuse(msg: str):
    print(f"refusing: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _moe_config(args, **dense) -> "moe_model.MoELMConfig":
    overrides = {}
    for key, v in (("num_experts", args.experts), ("top_k", args.top_k),
                   ("capacity_factor", args.capacity_factor),
                   ("router_mode", args.router),
                   ("group_tile", args.group_tile)):
        if v is not None:
            overrides[key] = v
    if args.dropless:
        overrides["dispatch"] = "dropless"
    return moe_model.MoELMConfig.from_env(**dense, **overrides)


def _grouped_rows(cfg, m, batch: int, seq: int) -> dict:
    """The JAX tool's analytic grouped-GEMM rows per peer and MoE
    sublayer: the dropless buffer (expert choice: its statically equal
    groups) against the capacity path's padded slots."""
    from ..moe.dropless import dropless_rows
    e_local = cfg.num_experts // m.ep
    if cfg.router_mode == "expert_choice":
        rows_drop = e_local * m.ep * (batch // m.ep) * cfg.ec_capacity(m)
    else:
        rows_drop = dropless_rows(
            m.ep * cfg.top_k * (batch // m.ep) * (seq // m.sp),
            e_local, cfg.group_tile)
    rows_cap = cfg.num_experts * cfg.top_k * cfg.capacity(m)
    return {"dropless": rows_drop, "capacity": rows_cap,
            "row_ratio": round(rows_drop / rows_cap, 6)}


def _wire_sweep(args, carve_kw, grad_fn, params, toks, dev):
    """The ledger's ``{"wire", "dcn_bytes", "dcn_dtypes", "ici_bytes"}``
    of one step of a fresh trainer from a copy of ``params`` at each
    codec (the JAX tool's sweep); the active carving is restored.  The
    step is the gradients and the update alone, outside the step wrapper
    (no metrics, flight events or chaos faults)."""
    from ..parallel import context as _ctx
    prior = _ctx.get_compose()
    codecs = [None, "bf16", "fp8@64"]
    if args.wire and args.wire not in codecs:
        codecs.append(args.wire)
    sweep = []
    try:
        for w in codecs:
            mw = compose.compose_parallelism(
                args.dp, args.pp, args.tp, args.sp, args.ep, device=dev,
                wire=w, **carve_kw)
            _, strategy = compose.make_train_step(
                mw, grad_fn, bfopt.adam(5e-3), delayed=not args.no_delayed)
            p = tree_map(torch.clone, params)
            state = bfopt.init_distributed(strategy, p)
            with _wb.ledger(mw.slice_size) as led:
                _, grads = bfopt.stacked_grads(grad_fn, p, toks,
                                               mw.slice_size)
                with torch.no_grad():
                    strategy.update(grads, state, p)
            st = led.stablehlo_wire_stats()
            sweep.append({"wire": w, "dcn_bytes": st["dcn_bytes"],
                          "dcn_dtypes": st["dcn_dtypes"],
                          "ici_bytes": st["ici_bytes"]})
            del p, state, grads, strategy
    finally:
        _ctx.set_compose(prior)
    return sweep


def main(argv=None) -> dict:
    args = _parse(argv)
    if args.ep > 1 and not args.moe:
        _refuse("--ep > 1 needs --moe (the dense LM has no expert axis)")
    if (args.dropless or args.router or args.group_tile) and not args.moe:
        _refuse("--dropless/--router/--group-tile need --moe")
    dev = resolve_device(args.device)
    smoke = dev.type == "cpu"
    seq = args.seq or (32 if smoke else 2048)
    dense = dict(
        vocab=args.vocab or (64 if smoke else 32768),
        d_model=args.d_model or (32 if smoke else 1024),
        heads=args.heads or (4 if smoke else 16),
        layers=args.layers or (args.pp * (1 if smoke else 2)),
        seq_len=seq,
        micro=args.micro or (max(2 * args.pp, 2) if smoke
                             else 4 * args.pp),
        batch=args.batch or (2 if smoke else 4))
    if args.moe:
        cfg = _moe_config(args, **dense)
        carve_kw = {"num_experts": cfg.num_experts,
                    "capacity_factor": cfg.capacity_factor}
    else:
        cfg, carve_kw = compose.LMConfig(**dense), {}
    m = compose.compose_parallelism(args.dp, args.pp, args.tp, args.sp,
                                    args.ep, device=dev, wire=args.wire,
                                    **carve_kw)
    cfg.validate(m)
    iters = args.iters or (4 if smoke else 8)
    steps_per_call = args.steps_per_call or (1 if smoke else 4)
    if m.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.moe:
        grad_fn = moe_model.make_moe_grad_fn(cfg, m)
        params = moe_model.init_moe_train_params(cfg, m)
        toks = moe_model.make_moe_batch(cfg, m)
    else:
        grad_fn = compose.make_lm_grad_fn(cfg, m, use_pallas=args.pallas)
        params = compose.init_lm_train_params(cfg, m)
        toks = compose.make_lm_batch(cfg, m)
    probe = bool(args.chaos or args.flight_dir)
    if probe:
        # the probe and the step-time table run over every stacked peer
        from ..parallel import context as _ctx
        _ctx.init(size=m.dp * m.slice_size, device=dev)
    step, strategy = compose.make_train_step(
        m, grad_fn, bfopt.adam(5e-3), delayed=not args.no_delayed,
        steps_per_call=steps_per_call, reuse_batch=steps_per_call > 1,
        metrics_every_k=2 if probe else None, metrics_warmup=2)
    state = bfopt.init_distributed(strategy, params)
    if args.chaos:
        from ..utils import chaos as bfchaos
        bfchaos.install(args.chaos)

    def sync():
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)

    losses = []

    def run(k):
        nonlocal params, state
        for _ in range(k):
            params, state, loss = step(params, state, toks)
            losses.append(float(loss.float().mean()))

    sweep = []
    if not args.no_sweep and m.dp > 1:
        sweep = _wire_sweep(args, carve_kw, grad_fn, params, toks, dev)
    # warm-up: the first call under the wire-byte ledger, one step's share
    with _wb.ledger(m.slice_size) as led:
        run(1)
    wire_bytes = led.steps(steps_per_call)[0].stablehlo_wire_stats()
    wire_bytes["slice_size"] = m.slice_size
    run(1)
    sync()
    if m.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(m.device)
    t0 = time.perf_counter()
    run(iters)
    sync()
    dt = time.perf_counter() - t0

    per_step = dt / (iters * steps_per_call)
    tokens_per_step = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    tok_per_sec = tokens_per_step / per_step
    flops_per_token = cfg.flops_per_token()
    on_card = m.device.type == "cuda"
    doc = {
        "schema": SCHEMA,
        "device": (torch.cuda.get_device_name(m.device) if on_card
                   else str(m.device)),
        "mesh": m.describe(),
        "config": {"seq": cfg.seq_len, "layers": cfg.layers,
                   "d_model": cfg.d_model, "heads": cfg.heads,
                   "micro": cfg.micro, "batch": cfg.batch,
                   "vocab": cfg.vocab, "n_params": cfg.n_params,
                   "n_active_params": (cfg.n_active_params if args.moe
                                       else cfg.n_params),
                   "pallas": args.pallas,
                   "delayed": not args.no_delayed,
                   "steps_per_call": steps_per_call, "iters": iters},
        "per_step_s": per_step,
        "tokens_per_step": tokens_per_step,
        "tokens_per_sec": tok_per_sec,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(m.device) / 2 ** 30
                        if on_card else None),
        "mfu": {"flops_per_token": flops_per_token,
                # MoE counts the ACTIVE experts' flops (n_active_params)
                "flops_source": "active" if args.moe else "dense",
                "model_flops_per_sec": tok_per_sec * flops_per_token,
                "peak": PEAK_NAME if on_card else None,
                "peak_flops_per_chip": PEAK_FLOPS if on_card else None,
                "mfu": (tok_per_sec * flops_per_token / PEAK_FLOPS
                        if on_card else None)},
        "wire_bytes": wire_bytes,
        "wire_sweep": sweep,
        "losses": [losses[0], losses[-1]],
        "loss_decreased": losses[-1] < losses[0],
        "chaos": args.chaos,
        "straggler": None,
        "flight_bundle": None,
        "moe": None,
    }
    doc["ok"] = bool(doc["loss_decreased"])
    if args.moe:
        # routing health off the forward-only probe, outside the timed
        # window, on the final params
        health = moe_model.make_moe_probe(cfg, m)(params, toks)
        doc["moe"] = {
            "num_experts": cfg.num_experts, "top_k": cfg.top_k,
            "ep": m.ep, "capacity_factor": cfg.capacity_factor,
            "capacity": cfg.capacity(m),
            "n_active_params": cfg.n_active_params,
            "dispatch": cfg.dispatch, "router_mode": cfg.router_mode,
            "group_tile": cfg.group_tile,
            "routing_entropy": health["token_entropy"],
            "dropped_fraction": health["dropped_fraction"],
            "aux_loss": health["aux_loss"], "z_loss": health["z_loss"],
            "usage_entropy": health["usage_entropy"],
            "ec_coverage": health["ec_coverage"],
            "rows_per_device": (_grouped_rows(cfg, m, cfg.batch,
                                              cfg.seq_len)
                                if cfg.dispatch == "dropless" else None),
            "dot_flops": None, "per_step_s_capacity": None,
            "dot_flops_note": "the JAX tool counts the dot_general FLOPs "
                              "of the lowered StableHLO step; the port "
                              "lowers no program",
        }
        doc["ok"] = bool(doc["ok"]
                         and 0.0 <= health["dropped_fraction"] <= 1.0)
        if cfg.dispatch == "dropless":
            # drop-free by construction: a nonzero value is a bug
            doc["ok"] = bool(doc["ok"]
                             and health["dropped_fraction"] == 0.0)
    if args.chaos:
        from ..utils import chaos as bfchaos
        bfchaos.uninstall()
        table = bfdiag.last_step_times()
        doc["straggler"] = {
            "detected_ranks": [int(r) for r in bfdiag.detect_stragglers()],
            "step_times_s": ([round(float(t), 4) for t in table]
                             if table is not None else None),
        }
    if args.flight_dir:
        from ..utils import flight as bfflight
        os.makedirs(args.flight_dir, exist_ok=True)
        doc["flight_bundle"] = bfflight.dump(
            os.path.join(args.flight_dir, "flight_rank0.json"),
            reason="lm_bench")
    if probe:
        from ..parallel import context as _ctx
        _ctx.shutdown()
    print(json.dumps(doc), flush=True)
    return doc


if __name__ == "__main__":
    main()
