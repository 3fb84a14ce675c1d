"""``python -m bluefog_tpu_torch.serve`` — the serving demo loop.

Carves ``--dp`` replicas of ``--pp`` stages x ``--tp`` tensor-parallel
peers (x ep expert peers for an MoE model), stacked on one device,
builds an engine and a scheduler over a composed LM with random weights
from ``--seed`` (the JAX ``init_lm_params`` / ``init_moe_params``
draws), answers a burst of random prompts, and prints one JSON summary
line with the JAX demo's carving fields; the token and fast-path counts
are read from the metrics registry, as the JAX demo reads them.  Runs on
the CUDA card unless ``--device cpu`` is given.  The bucket, KV-store and
fast-path knobs follow ``ServeConfig.from_env``
(``BLUEFOG_SERVE_BUCKETS``,
``BLUEFOG_KV_DTYPE``, ``BLUEFOG_SPEC_DECODE='<k>[@<stages>]'``,
``BLUEFOG_PREFIX_PAGES='<pages>[x<page_tokens>]'``, ...); ``--pp``
(default ``BLUEFOG_SERVE_PP``, else 1) also sets the speculative draft's
depth unit and ``--tp`` defaults to ``BLUEFOG_SERVE_TP``, else 1.  With
``BLUEFOG_SERVE_MOE`` set (e.g. ``8x2`` or ``8x2@2``) the model is a
dropless top-k MoE LM with that many experts, carved over its ``@ep``
expert peers, as in the JAX demo.  ``--dp`` defaults to 1: one card has
no device count to carve replicas from.
"""
from __future__ import annotations

import argparse
import json
import os
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
    ap.add_argument("--dp", type=int, default=1,
                    help="serving replicas (default 1)")
    ap.add_argument("--pp", type=int,
                    default=int(os.environ.get("BLUEFOG_SERVE_PP", "1")),
                    help="pipeline stages of the carving (the draft's "
                         "depth unit; must divide --layers)")
    ap.add_argument("--tp", type=int,
                    default=int(os.environ.get("BLUEFOG_SERVE_TP", "1")),
                    help="tensor-parallel peers a replica")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..moe.model import (MoELMConfig, init_moe_train_params,
                             moe_params_from_jax)
    from ..parallel.compose import (LMConfig, compose_parallelism,
                                    init_lm_train_params, params_from_jax)
    from ..utils import metrics as _metrics
    from .engine import ServeConfig, ServeEngine
    from .scheduler import Scheduler

    scfg = ServeConfig.from_env()
    ep = scfg.moe_ep if scfg.moe_experts else 1
    if scfg.moe_experts:
        m = compose_parallelism(args.dp, args.pp, args.tp, 1, ep,
                                num_experts=scfg.moe_experts,
                                device=args.device)
        cfg = MoELMConfig(layers=args.layers, batch=ep,
                          num_experts=scfg.moe_experts,
                          top_k=scfg.moe_top_k, dispatch="dropless")
        params = moe_params_from_jax(
            init_moe_train_params(cfg, m, args.seed), cfg, m=m)
    else:
        m = compose_parallelism(args.dp, args.pp, args.tp,
                                device=args.device)
        cfg = LMConfig(layers=args.layers)
        params = params_from_jax(init_lm_train_params(cfg, m, args.seed),
                                 cfg, m=m)
    engine = ServeEngine(cfg, params, scfg, device=args.device)
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

    def total(name):
        return int(_metrics.counter(name).total())
    print(json.dumps({
        "schema": "bluefog-torch-serve-demo-1",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "replicas": args.dp, "pp": args.pp, "tp": args.tp, "ep": ep,
        "kv_dtype": engine.scfg.kv_dtype,
        "moe_experts": scfg.moe_experts,
        "spec_decode": scfg.spec_decode, "prefix_pages": scfg.prefix_pages,
        "spec_drafted": total("bluefog_serve_spec_drafted_total"),
        "spec_accepted": total("bluefog_serve_spec_accepted_total"),
        "prefix_hits": total("bluefog_serve_prefix_hits_total"),
        "completed": len(sched.completed),
        "tokens": total("bluefog_tokens_generated_total"),
        "decode_calls": sched.decode_calls,
        "wall_s": wall,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
