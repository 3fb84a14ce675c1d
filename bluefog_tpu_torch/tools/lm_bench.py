"""Decentralized LM training benchmark (counterpart of ``tools/lm_bench.py``
at ``--pp 1 --tp 1 --sp 1``).

Trains the composed LM by gossip over ``--dp`` data-parallel ranks
stacked on one device (``adapt_with_combine`` over
``ExponentialTwoGraph(dp)``, ``delayed`` unless ``--no-delayed``, Adam at
5e-3) and prints one JSON line: per-step time, tokens per second, the
first and last mean loss, the carving's ``describe()``, the config, and
``mfu`` (``flops_per_token`` from ``LMConfig.flops_per_token`` over the
H100's f32 rate outside the tensor cores, since the model trains in f32
without TF32).  On a CUDA device attention runs through the K1/K2 flash
kernels; the JSON names the device the numbers were taken on, and a CPU
run reports no MFU.

Run:    python -m bluefog_tpu_torch.tools.lm_bench
Smoke:  python -m bluefog_tpu_torch.tools.lm_bench --device cpu

Left out of the JAX tool (XLA features or later slices): the StableHLO
wire sweep, the profiler-trace overlap grading, chaos, the flight
recorder, the retrace sentinel and MoE.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import optimizers as bfopt
from ..parallel import compose

SCHEMA = "bluefog-torch-lm-bench-1"
# H100 SXM, f32 outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_NAME = "H100 SXM f32 (no tensor cores)"
PEAK_FLOPS = 67e12


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=4,
                    help="gossip-DP ranks, stacked on one device")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 2048; smoke 32)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--micro", type=int, default=None,
                    help="microbatches per step")
    ap.add_argument("--batch", type=int, default=None,
                    help="per-microbatch batch size")
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--steps-per-call", type=int, default=None)
    ap.add_argument("--no-delayed", action="store_true",
                    help="bulk-synchronous gossip instead of the one-step-"
                         "delayed mixing")
    ap.add_argument("--pallas", action="store_true",
                    help="flash attention on the CPU too (the kernels' "
                         "plain versions); on CUDA it always runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda); 'cpu' implies the "
                         "smoke shape")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = _parse(argv)
    m = compose.compose_parallelism(args.dp, device=args.device)
    smoke = m.device.type == "cpu"
    seq = args.seq or (32 if smoke else 2048)
    cfg = compose.LMConfig(
        vocab=args.vocab or (64 if smoke else 32768),
        d_model=args.d_model or (32 if smoke else 1024),
        heads=args.heads or (4 if smoke else 16),
        layers=args.layers or (1 if smoke else 2),
        seq_len=seq, micro=args.micro or (2 if smoke else 4),
        batch=args.batch or (2 if smoke else 4))
    iters = args.iters or (4 if smoke else 8)
    steps_per_call = args.steps_per_call or (1 if smoke else 4)
    if m.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    step, strategy = compose.make_train_step(
        m, compose.make_lm_grad_fn(cfg, m, use_pallas=args.pallas),
        bfopt.adam(5e-3), delayed=not args.no_delayed,
        steps_per_call=steps_per_call, reuse_batch=steps_per_call > 1)
    params = compose.init_lm_train_params(cfg, m)
    toks = compose.make_lm_batch(cfg, m)
    state = bfopt.init_distributed(strategy, params)

    def sync():
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)

    losses = []

    def run(k):
        nonlocal params, state
        for _ in range(k):
            params, state, loss = step(params, state, toks)
            losses.append(float(loss.float().mean()))

    run(2)                                          # warm-up
    sync()
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
                   "pallas": args.pallas, "delayed": not args.no_delayed,
                   "steps_per_call": steps_per_call, "iters": iters},
        "per_step_s": per_step,
        "tokens_per_sec": tok_per_sec,
        "mfu": {"flops_per_token": flops_per_token,
                "model_flops_per_sec": tok_per_sec * flops_per_token,
                "peak": PEAK_NAME if on_card else None,
                "peak_flops_per_chip": PEAK_FLOPS if on_card else None,
                "mfu": (tok_per_sec * flops_per_token / PEAK_FLOPS
                        if on_card else None)},
        "losses": [losses[0], losses[-1]],
        "loss_decreased": losses[-1] < losses[0],
    }
    print(json.dumps(doc), flush=True)
    return doc


if __name__ == "__main__":
    main()
