"""``python -m bluefog_tpu_torch.tools.serve_calls`` — the serving
engine's host cost, the number that bounds serving (it is host bound).

Builds the carving-1 engine at ``chip_smoke.py``'s phase 3 widths (and,
with ``--moe``, phase 8's: 8 experts top-2), times one fused decode call
of 8 live lanes and 4 steps (median and minimum wall ms over ``--calls``
calls, the first 5 dropped) and a 500-token prefill (median of 5), and
counts the torch operators one decode call dispatches on the host
(``torch.profiler``, top-level operators).  One JSON line.  Runs on the
card unless ``--device cpu`` is given (then at a small width, page
length and prompt: the operator count is the same).

``--root DIR`` imports the package from the checkout ``DIR`` instead (a
parent commit unpacked by ``git archive``); ``--ab DIR`` times ``DIR``
and this checkout alternately, ``--pairs`` times each, one fresh process
a run, parent first, so two trees compare on one card in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def measure(moe: bool, calls: int, device) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bluefog_tpu_torch.device import resolve_device
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    from bluefog_tpu_torch.parallel.compose import LMConfig, init_lm_params
    from bluefog_tpu_torch.serve import ServeConfig, ServeEngine

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(1)       # host cost, not the CPU's matmuls
    card = dev.type == "cuda"
    width = dict(vocab=32768, d_model=1024, heads=16) if card \
        else dict(vocab=64, d_model=32, heads=4)
    L, buckets, n = (1024, (64, 256, 512), 500) if card else (64, (16,), 12)
    extra = {}
    if moe:
        cfg = MoELMConfig(layers=8, num_experts=8, top_k=2,
                          dispatch="dropless", group_tile=8, **width)
        model = init_moe_params(cfg, seed=0, device=dev)
        extra = dict(moe_experts=8, moe_top_k=2)
    else:
        cfg = LMConfig(layers=8, **width)
        model = init_lm_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, model, ServeConfig(
        slots=8, max_len=L, batch_buckets=(1, 2, 4, 8),
        prefill_buckets=buckets, decode_steps_per_call=4,
        decode_kernel="pallas", decode_block_k=128, **extra), device=dev)
    eng.warmup()
    S = 8
    lens = np.linspace(L // 32, L - L // 8, S).astype(np.int32)[None]
    toks = np.zeros((1, S), np.int32)
    slots = np.arange(S, dtype=np.int32)[None]

    def wall(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()              # returns host arrays: the call's work is done
        return 1e3 * (time.perf_counter() - t0)

    walls = [wall(lambda: eng.decode(toks, slots, lens))
             for _ in range(calls + 5)][5:]
    prompt = [t % cfg.vocab for t in range(n)]
    prefill = [wall(lambda: eng.prefill(0, 0, prompt)) for _ in range(7)][2:]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.decode(toks, slots, lens)
    ops = sum(1 for e in prof.events() if e.cpu_parent is None)
    return {"model": "moe" if moe else "dense", "width": width,
            "decode_call_ms_median": float(np.median(walls)),
            "decode_call_ms_min": float(np.min(walls)),
            "prefill_ms_median": float(np.median(prefill)),
            "prefill_tokens": n,
            "ops_per_decode_call": ops, "steps_per_call": 4, "lanes": S,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "bluefog_tpu_torch.tools.serve_calls")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--root", default=None,
                    help="import the package from this checkout")
    ap.add_argument("--ab", default=None,
                    help="a checkout to time alternately with this one")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if args.ab:
        base = [sys.executable, _HERE, "--calls", str(args.calls)]
        base += ["--moe"] if args.moe else []
        base += ["--device", args.device] if args.device else []
        for _ in range(args.pairs):
            for tag, root in (("parent", os.path.abspath(args.ab)),
                              ("change", _ROOT)):
                p = subprocess.run(base + ["--root", root], cwd=root,
                                   capture_output=True, text=True)
                if p.returncode:
                    sys.stderr.write(p.stderr[-3000:])
                    return p.returncode
                doc = json.loads(p.stdout.strip().splitlines()[-1])
                print(json.dumps({"tree": tag, **doc}), flush=True)
        return 0
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    print(json.dumps(measure(args.moe, args.calls, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
