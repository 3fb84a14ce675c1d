"""Gossip-step microbenchmark by topology: the port of
``tools/gossip_bench.py``.

For each topology family at ``--ranks`` ranks stacked on the device: the
number of gossip rounds (the latency chain), the model copies each rank
sends a step (the mean out-degree, from the schedule tables: the
bandwidth cost), and the measured ms of one ``neighbor_allreduce`` step
of a ``[ranks, --params]`` f32 buffer on the device; then the global
allreduce line (``2 (n - 1) / n`` copies a rank).  ``--train-step`` adds
the JAX tool's CTA train-step comparison by communicator (fused, unfused,
empty, allreduce; an MLP of 256 x 256 x 2, batch 32, 4 steps a call).

``--frontier`` is the pod-scale consensus-vs-bytes frontier, host math
only (flat Exp2 against the two-level hierarchical schedule on spectral
gap per cross-slice byte); its JSON report is the JAX tool's.

``--async-frontier`` is refused: its synchronous arm charges the
straggler's delay through ``utils/chaos.py``'s ``throttle`` fault, which
comes with ROADMAP queue 1, item 8.

Differences from the JAX tool: ``--ranks`` (default 8, the JAX tool's
virtual-CPU size) stacks the ranks on one device; ``--device`` defaults
to the card (a missing card raises) and ``cpu`` is for tests; times are
the host's wall clock around ``--iters`` steps between two device
syncs.

Run (card):  python -m bluefog_tpu_torch.tools.gossip_bench [--train-step]
Run (host):  python -m bluefog_tpu_torch.tools.gossip_bench --frontier
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

_WIRE_WIDTH = {"f32": 4, "off": 4, "bf16": 2, "int8": 1, "fp8": 1}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--params", type=int, default=1 << 20,
                    help="elements per rank in the gossip buffer")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train-step", action="store_true",
                    help="also compare full CTA train-step time by "
                         "communicator: fused / unfused / empty / allreduce")
    ap.add_argument("--frontier", action="store_true",
                    help="grade the hierarchical vs flat consensus-vs-bytes "
                         "frontier at pod shapes (host math only)")
    ap.add_argument("--shapes", default="32x32,32x128",
                    help="comma list of MxL pod shapes for --frontier")
    ap.add_argument("--wire", default="bf16", choices=sorted(_WIRE_WIDTH),
                    help="DCN wire codec assumed for the hierarchical "
                         "schedule in --frontier")
    ap.add_argument("--out", default=None,
                    help="write the --frontier report as JSON here")
    ap.add_argument("--async-frontier", action="store_true",
                    help="grade sync vs bounded-staleness async gossip "
                         "(not ported: needs utils/chaos.py)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def frontier(args) -> dict:
    """Consensus-vs-bytes frontier, hierarchical vs flat, per pod shape
    (the JAX tool's ``_frontier``, line for line).  Ranks are contiguous
    per slice, so a flat Exp2(n) hop of distance d crosses the slice
    boundary for d*M of the n senders when d < L and for every sender once
    d >= L; the hierarchical schedule reduces intra-slice at full f32
    width, then runs log2(M) machine permutes in the wire dtype."""
    from .. import topology as tu

    wire_w = _WIRE_WIDTH[args.wire]
    payload = args.params * 4                 # full-width f32 bytes / chip
    report = {"schema": "bluefog-gossip-frontier-1", "params": args.params,
              "wire": args.wire, "shapes": []}
    for spec in args.shapes.split(","):
        m_s, l_s = spec.lower().strip().split("x")
        M, L = int(m_s), int(l_s)
        if M < 2 or L < 2:
            raise SystemExit(f"--shapes wants MxL with M,L >= 2, got {spec}")
        n = M * L

        flat_hops, flat_ici, flat_dcn = [], 0, 0
        for k in range(int(np.log2(n))):
            d = 1 << k
            crossing = n if d >= L else d * M   # senders whose hop leaves
            dcn_b = payload * crossing // n     # their slice (avg per chip)
            ici_b = payload - dcn_b
            flat_hops.append({"hop": f"+{d}", "link": "ici+dcn",
                              "ici_bytes": ici_b, "dcn_bytes": dcn_b})
            flat_ici += ici_b
            flat_dcn += dcn_b
        flat_gap = tu.spectral_gap(tu.ExponentialTwoGraph(n))

        intra_b = 2 * (L - 1) * payload // L
        hier_hops = [{"hop": "intra-mean", "link": "ici",
                      "ici_bytes": intra_b, "dcn_bytes": 0}]
        hier_ici, hier_dcn = intra_b, 0
        for k in range(int(np.log2(M))):
            dcn_b = args.params * wire_w
            hier_hops.append({"hop": f"+{1 << k}m", "link": "dcn",
                              "ici_bytes": 0, "dcn_bytes": dcn_b})
            hier_dcn += dcn_b
        hier_gap = tu.spectral_gap(tu.ExponentialTwoGraph(M))

        mib = float(2 ** 20)
        flat_row = {"topology": f"expo2({n})", "rounds": int(np.log2(n)),
                    "spectral_gap": flat_gap, "hops": flat_hops,
                    "ici_bytes_per_chip": flat_ici,
                    "dcn_bytes_per_chip": flat_dcn,
                    "gap_per_dcn_mib": flat_gap / (flat_dcn / mib)}
        hier_row = {"topology": f"dense({L}) x expo2({M})",
                    "rounds": 1 + int(np.log2(M)),
                    "spectral_gap": hier_gap, "hops": hier_hops,
                    "ici_bytes_per_chip": hier_ici,
                    "dcn_bytes_per_chip": hier_dcn,
                    "gap_per_dcn_mib": hier_gap / (hier_dcn / mib)}
        report["shapes"].append({
            "machines": M, "local": L, "ranks": n,
            "flat": flat_row, "hier": hier_row,
            "dcn_ratio": flat_dcn / hier_dcn,
            "frontier_ratio": (hier_row["gap_per_dcn_mib"]
                               / flat_row["gap_per_dcn_mib"]),
        })

    print(f"consensus-vs-bytes frontier, {args.params} f32/chip "
          f"({payload / 2**20:.1f} MiB model), DCN wire={args.wire}:")
    print(f"{'shape':>9} {'schedule':>22} {'rounds':>7} {'gap':>7} "
          f"{'ICI MiB':>8} {'DCN MiB':>8} {'gap/DCN-MiB':>12}")
    for s in report["shapes"]:
        for tag in ("flat", "hier"):
            r = s[tag]
            print(f"{s['machines']}x{s['local']:<5} {r['topology']:>22} "
                  f"{r['rounds']:>7} {r['spectral_gap']:>7.3f} "
                  f"{r['ici_bytes_per_chip'] / 2**20:>8.2f} "
                  f"{r['dcn_bytes_per_chip'] / 2**20:>8.2f} "
                  f"{r['gap_per_dcn_mib']:>12.3f}")
        print(f"{'':>9} hierarchical moves {s['dcn_ratio']:.1f}x fewer DCN "
              f"bytes -> {s['frontier_ratio']:.1f}x contraction per DCN byte")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return report


def _timed_ms(fn, x, iters: int) -> float:
    """ms a call of ``fn`` over ``iters`` calls fed back into themselves,
    between two device syncs (one warm-up call first)."""
    from ..api import hard_sync
    out = hard_sync(fn(x))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(out)
    hard_sync(out)
    return (time.perf_counter() - t0) / iters * 1e3


def topologies(n: int) -> Dict[str, object]:
    from .. import topology as tu
    return {"ring": tu.RingGraph(n), "expo2": tu.ExponentialTwoGraph(n),
            "mesh2d": tu.MeshGrid2DGraph(n), "star": tu.StarGraph(n),
            "full": tu.FullyConnectedGraph(n)}


def gossip_rows(args) -> List[dict]:
    """One row a topology (and the dynamic one-peer Exp2, and the global
    allreduce): rounds, copies sent a step, ms a step."""
    from .. import schedule as sch
    from .. import topology as tu
    from ..ops import collectives as coll
    from ..parallel import context as bf
    n = bf.size()
    dev = bf.get_context().device
    x = torch.ones((bf.get_context().rows, args.params), dtype=torch.float32,
                   device=dev)
    rows = []
    for name, topo in topologies(n).items():
        s = sch.compile_topology(topo, weighted=True)
        rows.append({"topology": name, "rounds": s.num_rounds,
                     "x_model_sent": float(np.mean(s.out_degree)),
                     "ms_per_step": _timed_ms(
                         lambda t, s=s: coll.neighbor_allreduce(t, s), x,
                         args.iters)})
    dyn = sch.compile_dynamic_schedules(
        lambda r: tu.GetDynamicOnePeerSendRecvRanks(
            tu.ExponentialTwoGraph(n), r), n)
    rows.append({"topology": "expo2-dynamic(1peer)",
                 "rounds": dyn[0].num_rounds,
                 "x_model_sent": float(np.mean(dyn[0].out_degree)),
                 "ms_per_step": _timed_ms(
                     lambda t: coll.neighbor_allreduce(t, dyn[0]), x,
                     args.iters)})
    rows.append({"topology": "global allreduce", "rounds": None,
                 "x_model_sent": 2 * (n - 1) / n,
                 "ms_per_step": _timed_ms(coll.allreduce, x, args.iters)})
    print(f"{n} devices, {args.params} f32/rank "
          f"({args.params * 4 / 2**20:.1f} MiB model):")
    print(f"{'topology':>22} {'rounds':>7} {'x model sent/step':>18} "
          f"{'ms/step':>9}")
    for r in rows:
        rounds = "-" if r["rounds"] is None else r["rounds"]
        print(f"{r['topology']:>22} {rounds:>7} {r['x_model_sent']:>18.2f} "
              f"{r['ms_per_step']:>9.2f}")
    return rows


def train_step_rows(args) -> List[dict]:
    """The full CTA train step (MLP, 4 steps a call) under each
    communicator; the empty one is the compute floor."""
    from .. import optimizers as bfopt
    from .. import topology as tu
    from ..api import hard_sync
    from ..parallel import context as bf
    n = bf.size()
    rows_here = bf.get_context().rows
    dev = bf.get_context().device
    bf.set_topology(tu.ExponentialTwoGraph(n))
    dim, bsz, steps = 256, 32, 4

    def grad_fn(params, batch):
        x, y = batch
        w1 = params["w1"].detach().requires_grad_()
        w2 = params["w2"].detach().requires_grad_()
        loss = torch.mean((torch.tanh(x @ w1) @ w2 - y) ** 2)
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        return loss.detach(), {"w1": g1, "w2": g2}

    comms = {
        "gossip fused": bfopt.neighbor_communicator(bf.static_schedule()),
        "gossip unfused": bfopt.neighbor_communicator(
            bf.static_schedule(), fuse=False),
        "no comm (floor)": bfopt.empty_communicator(),
        "global allreduce": bfopt.allreduce_communicator(),
    }
    print(f"\nCTA train step (MLP {dim}x{dim}x2, batch {bsz}, scan {steps}) "
          f"by communicator:")
    print(f"{'communicator':>22} {'ms/step':>9}")
    rows = []
    for name, comm in comms.items():
        strat = bfopt.adapt_with_combine(bfopt.sgd(0.01), comm)
        params = {"w1": torch.zeros((rows_here, dim, dim), device=dev),
                  "w2": torch.zeros((rows_here, dim, dim), device=dev)}
        state = bfopt.init_distributed(strat, params)
        step = bfopt.make_train_step(grad_fn, strat, steps_per_call=steps)
        batch = tuple(torch.zeros((rows_here, steps, bsz, dim), device=dev)
                      for _ in range(2))
        params, state, loss = step(params, state, batch)     # warm-up
        hard_sync(loss)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            params, state, loss = step(params, state, batch)
        hard_sync(loss)
        ms = (time.perf_counter() - t0) / (args.iters * steps) * 1e3
        rows.append({"communicator": name, "ms_per_step": ms})
        print(f"{name:>22} {ms:>9.2f}")
    return rows


def run(args) -> dict:
    """The chosen mode; returns its rows (or the frontier report)."""
    if args.async_frontier:
        raise SystemExit(
            "--async-frontier charges the straggler's delay to the "
            "synchronous arm through utils/chaos.py's throttle fault, which "
            "is not ported yet (ROADMAP queue 1, item 8: the host runtime)")
    if args.frontier:
        return frontier(args)
    from ..device import resolve_device
    from ..parallel import context as bf
    bf.init(size=args.ranks, device=resolve_device(args.device))
    try:
        doc = {"ranks": args.ranks, "params": args.params,
               "iters": args.iters, "rows": gossip_rows(args)}
        if args.train_step:
            doc["train_step"] = train_step_rows(args)
        return doc
    finally:
        bf.shutdown()


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
