"""Dispatch-amortization sweep + step trace for the ResNet-50 gossip
benchmark (counterpart of ``tools/step_sweep.py``).

Runs :mod:`bluefog_tpu_torch.tools.bench`'s measurement (``build`` and the
timed calls of ``run``) at several ``steps_per_call`` values on one
device, showing how K optimizer steps a call amortize the host's
per-call cost.  Each row is printed as it lands and, with ``--out``,
banked at once (``partial`` until the last value), as in the JAX tool;
the last line is ``{"summary": dispatch_amortization, "best": row}``.

``--trace DIR`` profiles one more call of the largest value after its
timed calls (``torch.profiler``, CPU and, on the card, CUDA activity)
into ``DIR/step_sweep.pt.trace.json``.  The JAX tool traces the timed
run itself; here the profiler's host cost would slow the row it sits
in, and ResNet-50's step is host bound.  With ``--ranks`` > 1 the sweep
prints the trace's compute / comm split
(:mod:`~bluefog_tpu_torch.tools.trace_analyze`, a ``trace_analysis``
line) beside its rows, and on the card a failed analysis fails the run
(exit 1).  The JAX tool's compile cache and ``--allow-cpu`` have no
meaning without XLA: the port takes ``--device cpu``.

Run:    python -m bluefog_tpu_torch.tools.step_sweep [--ranks 4 --batch 16]
            [--sweep 1,2,5,10] [--trace DIR] [--out sweep.json]
Smoke:  python -m bluefog_tpu_torch.tools.step_sweep --device cpu \\
            --image-size 32 --classes 10 --batch 2 --ranks 2 --sweep 1,2 \\
            --iters 1
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..device import resolve_device
from ..parallel import context as bf
from . import bench, trace_analyze


def _summarize(device_kind, batch, rows, partial):
    """vs_spc1/amortization from whatever rows exist so far (the k=1
    baseline runs first in the sorted sweep) — single home for the
    formula, shared by the stdout summary and the JSON artifact."""
    base = rows[0]["imgs_per_sec_per_chip"]
    rows = [dict(r, vs_spc1=round(r["imgs_per_sec_per_chip"] / base, 3))
            for r in rows]
    summary = {"device": device_kind, "batch": batch, "rows": rows,
               "dispatch_amortization":
                   round(max(r["imgs_per_sec_per_chip"] for r in rows)
                         / base, 3)}
    if partial:
        summary["partial"] = True      # sweep did not finish all k values
    return summary


def _write_summary(out, device_kind, batch, rows, partial):
    summary = _summarize(device_kind, batch, rows, partial)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1)
    os.replace(tmp, out)
    return summary


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", default="1,2,5,10",
                    help="comma-separated steps_per_call values")
    ap.add_argument("--batch", type=int, default=None,
                    help="images a rank a step (the bench's default)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls a value (the bench's default)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks stacked on the device")
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of one "
                         "call at the largest steps_per_call, after its "
                         "timed calls")
    ap.add_argument("--out", default=None, help="json artifact path")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for a smoke run")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    sweep = sorted(int(s) for s in args.sweep.split(","))
    rows, analysis, batch = [], None, args.batch
    for i, spc in enumerate(sweep):
        profiler = None
        tracing = args.trace is not None and spc == sweep[-1]
        if tracing:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
        run_args = argparse.Namespace(
            device=args.device, ranks=args.ranks, batch=args.batch,
            steps_per_call=spc, iters=args.iters,
            image_size=args.image_size, classes=args.classes, plan=None)
        try:
            doc, _ = bench.run(run_args, profiler)
        finally:
            bf.shutdown()
        batch = doc["batch_per_rank"]
        row = {"steps_per_call": spc, "imgs_per_sec_per_chip": doc["value"],
               "mfu": doc["mfu"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if tracing:
            os.makedirs(args.trace, exist_ok=True)
            path = os.path.join(args.trace, "step_sweep.pt.trace.json")
            profiler.export_chrome_trace(path)
            if args.ranks > 1:
                analysis = trace_analyze.analyze_file(path)
                print(json.dumps({"trace_analysis": analysis}), flush=True)
        # bank incrementally: rows already measured survive a later
        # failure; only the last write claims a complete sweep
        if args.out:
            summary = _write_summary(args.out, kind, batch, rows,
                                     partial=i != len(sweep) - 1)
    if not args.out:
        summary = _summarize(kind, batch, rows, partial=False)
    print(json.dumps({"summary": summary["dispatch_amortization"],
                      "best": max(summary["rows"],
                                  key=lambda r: r["imgs_per_sec_per_chip"])}),
          flush=True)
    if args.out:
        print(f"wrote {args.out}", file=sys.stderr)
    if analysis is not None and not analysis["ok"] and on_card:
        print(f"step_sweep: trace analysis failed: {analysis['error']}",
              file=sys.stderr)
        raise SystemExit(1)
    return dict(summary, trace_analysis=analysis)


if __name__ == "__main__":
    main()
