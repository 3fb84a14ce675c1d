"""``python -m bluefog_tpu_torch.serve`` — the serving demo loop.

Builds an engine and a scheduler over a composed LM with random weights
from ``--seed``, answers a burst of random prompts, and prints one JSON
summary line.  Runs on the CUDA card unless ``--device cpu`` is given.
The bucket and KV-store knobs follow ``ServeConfig.from_env``
(``BLUEFOG_SERVE_BUCKETS``, ``BLUEFOG_KV_DTYPE``, ...); with
``BLUEFOG_SERVE_MOE`` set (e.g. ``8x2``) the model is a dropless top-k
MoE LM with that many experts, as in the JAX demo.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bluefog_tpu_torch.serve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..moe.model import MoELMConfig, init_moe_params
    from ..parallel.compose import LMConfig, init_lm_params
    from .engine import ServeConfig, ServeEngine
    from .scheduler import Scheduler

    scfg = ServeConfig.from_env()
    if scfg.moe_experts:
        cfg = MoELMConfig(layers=args.layers, num_experts=scfg.moe_experts,
                          top_k=scfg.moe_top_k, dispatch="dropless")
        model = init_moe_params(cfg, args.seed, device=args.device)
    else:
        cfg = LMConfig(layers=args.layers)
        model = init_lm_params(cfg, args.seed, device=args.device)
    engine = ServeEngine(cfg, model, scfg, device=args.device)
    engine.warmup()
    sched = Scheduler(engine)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        n = int(rng.integers(2, engine.scfg.prefill_buckets[-1] + 1))
        sched.submit(rng.integers(0, cfg.vocab, n).tolist(),
                     max_new_tokens=args.max_new_tokens)
    t0 = time.monotonic()
    sched.drain()
    wall = time.monotonic() - t0
    dev = engine.device
    print(json.dumps({
        "schema": "bluefog-torch-serve-demo-1",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "kv_dtype": engine.scfg.kv_dtype,
        "moe_experts": scfg.moe_experts,
        "completed": len(sched.completed),
        "tokens": sum(len(r.generated) for r in sched.completed),
        "decode_calls": sched.decode_calls,
        "wall_s": wall,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
