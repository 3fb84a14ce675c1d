"""Sequence-parallel microbenchmark: ring layouts vs Ulysses (counterpart
of ``tools/sp_bench.py``).

Causal attention over ``--seq`` tokens split over ``--ranks`` sequence
ranks stacked on one device, ``--heads`` x ``--head-dim``, forward only,
one row per mode: the contiguous ring (one K1 launch per visible block,
``n (n + 1) / 2``), the zigzag ring (``n + 1`` launches, each rank's
visible chunk pairs stacked), and Ulysses (two all-to-alls around one K1
launch over every rank's heads).  On the card each row is milliseconds
per call from CUDA events around ``--iters`` calls after a warm-up; with
``--device cpu`` the rows are host wall milliseconds of the plain
versions and say so.  The zigzag row runs on the unpermuted data: the
work is the same whatever the values.

Run:    python -m bluefog_tpu_torch.tools.sp_bench [--seq 4096]
Smoke:  python -m bluefog_tpu_torch.tools.sp_bench --device cpu --seq 256
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import flash_attention as fa
from ..ops.ring import ring_attention
from ..ops.ulysses import ulysses_attention


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=8,
                    help="divisible by the ranks so the Ulysses row runs")
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    return ap.parse_args(argv)


def _time_ms(fn, iters: int, dev: torch.device) -> float:
    fn()                                       # warm-up (and build)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> dict:
    args = _parse(argv)
    dev = resolve_device(args.device)
    n, T, H, D = args.ranks, args.seq, args.heads, args.head_dim
    if T % (2 * n):
        raise SystemExit(f"--seq {T} must split into 2 x {n} chunks")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(n, 1, T // n, H, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    modes = {
        "contiguous": lambda: ring_attention(q, k, v, causal=True),
        "zigzag": lambda: ring_attention(q, k, v, causal=True,
                                         layout="zigzag"),
    }
    if H % n == 0:
        modes["ulysses"] = lambda: ulysses_attention(q, k, v, axis=0,
                                                     causal=True)
    else:
        print(f"  (ulysses skipped: heads {H} not divisible by {n} ranks)")
    clock = "CUDA events" if dev.type == "cuda" else "host wall (CPU)"
    print(f"causal attention, seq {T} over {n} ranks ({T // n}/rank), "
          f"{H} heads x {D}, ms per call by {clock}:")
    rows = {}
    with torch.no_grad():
        for name, fn in modes.items():
            before = fa.fwd_launches
            fn()
            launches = fa.fwd_launches - before
            rows[name] = {"ms": _time_ms(fn, args.iters, dev),
                          "k1_launches_per_call": launches}
            print(f"  {name:>11}: {rows[name]['ms']:8.3f} ms/call "
                  f"({launches} K1 launches)")
    doc = {"seq": T, "ranks": n, "heads": H, "head_dim": D,
           "iters": args.iters, "clock": clock, "rows": rows,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
