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

``--async-frontier`` grades wall-clock-to-consensus of synchronous
against bounded-staleness asynchronous gossip under a throttled rank, as
the JAX tool does: both arms run ``async_window_gossip`` on the push
schedule of Exp2 (lr 0, pure gossip); the synchronous arm (bound 0) pays
the straggler's delay every tick through a chaos ``throttle`` fault
(``utils/chaos.py``), the asynchronous arm models it with a pace table
and sleeps only before a forced sync-up.  Its JSON report is the JAX
tool's (``bluefog-gossip-async-1``).

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
                         "wall-clock-to-consensus under a throttled rank")
    ap.add_argument("--throttle-rank", type=int, default=3,
                    help="rank the async frontier throttles")
    ap.add_argument("--throttle-factor", type=int, default=10,
                    help="slowdown factor of the throttled rank")
    ap.add_argument("--staleness-bound", type=int, default=4,
                    help="async staleness bound K for --async-frontier")
    ap.add_argument("--target-ratio", type=float, default=0.05,
                    help="stop when max consensus distance falls to this "
                         "fraction of its initial value")
    ap.add_argument("--max-ticks", type=int, default=400,
                    help="per-arm tick budget for --async-frontier")
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


def async_frontier(args) -> dict:
    """Wall-clock-to-consensus, sync vs bounded-staleness async gossip
    (the JAX tool's ``_async_frontier``).  Wall clock counts the step and
    the injected sleeps; the consensus probe between ticks is excluded
    (both arms pay it)."""
    from .. import diagnostics as bfdiag
    from .. import optimizers as bfopt
    from .. import topology as tu
    from ..api import hard_sync
    from ..device import resolve_device
    from ..parallel import context as bf
    from ..utils import chaos

    dev = resolve_device(args.device)
    bf.init(size=args.ranks, device=dev)
    try:
        n = bf.size()
        bf.set_topology(tu.ExponentialTwoGraph(n))
        sched = bfopt.push_schedule(bf.load_topology(), n)
        rank = args.throttle_rank % n
        factor = args.throttle_factor
        bound = args.staleness_bound
        opt = bfopt.sgd(0.0)          # pure gossip: grade mixing, not descent

        rng = np.random.RandomState(7)
        params0 = {"w": torch.from_numpy(
            rng.randn(n, args.params).astype(np.float32)).to(dev)}
        batch = torch.zeros((n, 1), device=dev)

        def grad_fn(p, _):
            return torch.zeros((), device=dev), {
                k: torch.zeros_like(v) for k, v in p.items()}

        def fresh(strat):
            params = {k: v.clone() for k, v in params0.items()}
            return params, bfopt.init_distributed(strat, params)

        def build(strat):
            # one untimed warm-up call, then the start state again (the
            # step updates its params and state in place)
            step = bfopt.make_train_step(grad_fn, strat)
            step(*fresh(strat), batch)
            return (step, *fresh(strat))

        def consensus_max(p):
            return float(bfdiag.consensus_distance(p).max())

        # unthrottled tick time on this device -> the injected delay
        step, params, state = build(
            bfopt.async_window_gossip(opt, sched, staleness_bound=0))
        initial = consensus_max(params)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            hard_sync(params)
            times.append(time.perf_counter() - t0)
        base = float(np.median(times))
        throttle_s = max((factor - 1) * base, 0.02)
        target = args.target_ratio * initial

        def run_arm(strat, straggler_sleeps: bool):
            step, params, state = build(strat)
            wall, ticks, forced, stale_max = 0.0, 0, 0, 0
            stall_next = False
            while ticks < args.max_ticks:
                t0 = time.perf_counter()
                if straggler_sleeps and stall_next:
                    # the fleet blocks on the straggler finishing its step
                    # before the forced sync-up tick can run
                    time.sleep(throttle_s)
                    forced += 1
                params, state, _ = step(params, state, batch)
                hard_sync(params)
                wall += time.perf_counter() - t0
                ticks += 1
                if straggler_sleeps:
                    cs = state.comm_state
                    stall_next = bool(cs.force.any())
                    stale_max = max(stale_max, int(cs.depth.max()))
                if consensus_max(params) <= target:
                    break
            return {"ticks": ticks, "wall_s": round(wall, 6),
                    "reached_target": consensus_max(params) <= target,
                    **({"forced_syncs": forced, "staleness_max": stale_max}
                       if straggler_sleeps else {})}

        # sync arm: lockstep, the chaos throttle charges the straggler's
        # delay to every tick (the whole fleet waits at the barrier)
        chaos.install(f"throttle:from=1,t={throttle_s},rank={rank}")
        try:
            sync_row = run_arm(
                bfopt.async_window_gossip(opt, sched, staleness_bound=0),
                straggler_sleeps=False)
        finally:
            chaos.uninstall()

        # async arm: the straggler completes a step every `factor` ticks
        # (pace table); the fleet sleeps only before forced sync-ups
        pace = [factor if r == rank else 1 for r in range(n)]
        async_row = run_arm(
            bfopt.async_window_gossip(opt, sched, staleness_bound=bound,
                                      pace=pace),
            straggler_sleeps=True)
    finally:
        bf.shutdown()

    speedup = sync_row["wall_s"] / max(async_row["wall_s"], 1e-9)
    report = {
        "schema": "bluefog-gossip-async-1",
        "n": n, "topology": f"expo2({n})", "params": args.params,
        "staleness_bound": bound, "target_ratio": args.target_ratio,
        "base_tick_s": round(base, 6),
        "throttle": {"rank": rank, "factor": factor,
                     "t_s": round(throttle_s, 6)},
        "sync": sync_row, "async": async_row,
        "speedup": round(speedup, 3),
        "won": bool(async_row["wall_s"] < sync_row["wall_s"]
                    and async_row["reached_target"]
                    and sync_row["reached_target"]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    print(f"async frontier: expo2({n}), {args.params} f32/rank, rank {rank} "
          f"throttled {factor}x ({throttle_s * 1e3:.0f} ms/tick), "
          f"staleness bound {bound}, target {args.target_ratio:.2f}x initial "
          f"consensus:")
    print(f"{'arm':>8} {'ticks':>6} {'wall s':>8} {'forced':>7} "
          f"{'max stale':>10}")
    print(f"{'sync':>8} {sync_row['ticks']:>6} {sync_row['wall_s']:>8.3f} "
          f"{'-':>7} {'-':>10}")
    print(f"{'async':>8} {async_row['ticks']:>6} "
          f"{async_row['wall_s']:>8.3f} {async_row['forced_syncs']:>7} "
          f"{async_row['staleness_max']:>10}")
    print(f"async-to-consensus is {speedup:.2f}x "
          f"{'faster' if report['won'] else 'SLOWER'} than sync under a "
          f"{factor}x straggler")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return report


def run(args) -> dict:
    """The chosen mode; returns its rows (or the frontier report)."""
    if args.async_frontier:
        return async_frontier(args)
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
