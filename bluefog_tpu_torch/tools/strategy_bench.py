"""Strategy comparison: collectives, wire bytes and step time a strategy,
the port of ``tools/strategy_bench.py``.

One row per distributed-optimizer strategy (the JAX tool's 10) on the
MLP of ``--dim`` (``features (2 dim, dim, 10)`` on ``dim`` inputs: about
1.05 M parameters a rank at 512) over 8 ranks stacked on one device,
weighted Exp2, ``sgd(0.05, momentum=0.9)``, batch 16 a rank: the moves a
step makes, the bytes the busiest rank puts on the wire a step, and the
measured ms a step.

The JAX tool counts collectives and bytes from its compiled HLO.  The
port has no compiled program, so both come from the schedule tables and
the codecs' widths (``examples/benchmark.py::wire_bytes_per_rank``, as
the ``benchmark_strategy`` lines count them): a gossip round is one
``permute`` of each rank's fused buffer, the busiest rank sending its
out-degree's copies; an allreduce (and ZeRO-1's reduce-scatter with its
all-gather) a ring's ``2 (n - 1) / n`` of its bytes; the codecs at
their widths (bf16 2 bytes, int8 1 byte and one f32 scale a buffer).
The dynamic one-peer row counts every schedule of its period, as the
JAX tool's HLO carries every branch, and its note divides by the period:
one schedule runs a step.

Run (card):  python -m bluefog_tpu_torch.tools.strategy_bench [--json]
Run (CPU):   python -m bluefog_tpu_torch.tools.strategy_bench --device cpu \\
                 --dim 32 --iters 2
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import models
from .. import optimizers as bfopt
from .. import schedule as sch
from .. import topology as tu
from ..api import hard_sync
from ..device import resolve_device
from ..examples import benchmark as ex
from ..fusion import fuse_tree, tree_flatten, tree_map, tree_unflatten
from ..parallel import context as bf

RANKS = 8
BATCH = 16
# name -> (the benchmark example's --dist-optimizer, wire, dynamic)
ACCOUNTING = {
    "allreduce": ("gradient_allreduce", None, False),
    "neighbor (CTA)": ("neighbor_allreduce", None, False),
    "neighbor (ATC)": ("neighbor_allreduce", None, False),
    "dynamic one-peer": ("neighbor_allreduce", None, True),
    "win_put": ("win_put", None, False),
    "push_sum": ("push_sum", None, False),
    "zero-1 allreduce": ("zero_allreduce", None, False),
    "choco (int8 wire)": ("choco", None, False),
    "powersgd r=4": ("powersgd", None, False),
    "neighbor bf16 wire": ("neighbor_allreduce", "bf16", False),
}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def strategies(dyn) -> Dict[str, Callable[[], bfopt.DecentralizedOptimizer]]:
    """The JAX tool's 10 strategies on the live context."""
    def opt():
        return bfopt.sgd(0.05, momentum=0.9)

    return {
        "allreduce": lambda: bfopt.gradient_allreduce(opt()),
        "neighbor (CTA)": lambda: bfopt.adapt_with_combine(
            opt(), bfopt.neighbor_communicator(bf.static_schedule())),
        "neighbor (ATC)": lambda: bfopt.adapt_then_combine(
            opt(), bfopt.neighbor_communicator(bf.static_schedule())),
        "dynamic one-peer": lambda: bfopt.adapt_with_combine(
            opt(), bfopt.neighbor_communicator(schedules=dyn)),
        "win_put": lambda: bfopt.win_put_optimizer(opt()),
        "push_sum": lambda: bfopt.push_sum(opt()),
        "zero-1 allreduce": lambda: bfopt.zero_gradient_allreduce(opt()),
        "choco (int8 wire)": lambda: bfopt.choco_gossip(opt()),
        "powersgd r=4": lambda: bfopt.powersgd_allreduce(
            opt(), compression_rank=4, out_dim=0),
        "neighbor bf16 wire": lambda: bfopt.adapt_with_combine(
            opt(), bfopt.neighbor_communicator(bf.static_schedule(),
                                               wire="bf16")),
    }


def _compressible(params) -> Tuple[int, bool]:
    """PowerSGD's matrices (2-dim leaves of at least 2048 elements a rank)
    and whether any other leaf is allreduced exactly."""
    leaves = tree_flatten(params)[0]
    mats = sum(1 for x in leaves if x.ndim >= 3 and x[0].numel() >= 2048)
    return mats, mats < len(leaves)


def accounting(name: str, params, dyn) -> Tuple[Dict[str, int], float]:
    """``(collective counts, wire bytes the busiest rank sends a step,
    every schedule of a dynamic period counted)`` from the schedule
    tables and the codecs' widths."""
    opt_name, wire, dynamic = ACCOUNTING[name]
    args = argparse.Namespace(dist_optimizer=opt_name, ranks=bf.size(),
                              wire=wire)
    buffers = len(fuse_tree(params).buffers)
    if dynamic:
        per_step = ex.wire_bytes_per_rank(args, params, dyn)
        return ({"permute": buffers * sum(s.num_rounds for s in dyn)},
                per_step * len(dyn))
    nbytes = ex.wire_bytes_per_rank(args, params)
    rounds = bf.static_schedule().num_rounds
    if opt_name in ("gradient_allreduce",):
        counts = {"all-reduce": buffers}
    elif opt_name == "zero_allreduce":
        counts = {"reduce-scatter": buffers, "all-gather": buffers}
    elif opt_name == "powersgd":
        mats, exact = _compressible(params)
        counts = {"all-reduce": 2 * mats + int(exact)}
    elif opt_name == "push_sum":
        counts = {"permute": 2 * buffers * rounds}     # x and its p
    else:
        counts = {"permute": buffers * rounds}
    return counts, float(nbytes)


def _model(dim: int, device):
    model = models.MLP(features=(2 * dim, dim, 10), in_features=dim,
                       generator=torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(device),
                      model.variables()["params"])

    def grad_fn(p, batch):
        xb, yb = batch
        leaves, treedef = tree_flatten(p)
        ps = [t.detach().requires_grad_() for t in leaves]
        loss = F.cross_entropy(
            model.apply({"params": tree_unflatten(treedef, ps)}, xb), yb)
        return loss.detach(), tree_unflatten(
            treedef, list(torch.autograd.grad(loss, ps)))

    return params, grad_fn


def bench(args) -> dict:
    """Every strategy's row on the live context."""
    n = bf.size()
    dev = bf.get_context().device
    topo = tu.ExponentialTwoGraph(n)
    bf.set_topology(topo, is_weighted=True)
    dyn = sch.compile_dynamic_schedules(
        lambda r: tu.GetDynamicOnePeerSendRecvRanks(topo, r), n)
    params0, grad_fn = _model(args.dim, dev)
    p_count = sum(x.numel() for x in tree_flatten(params0)[0])
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.normal(size=(n, BATCH, args.dim)))
             .to(torch.float32).to(dev),
             torch.zeros((n, BATCH), dtype=torch.long, device=dev))
    rows = []
    for name, make in strategies(dyn).items():
        strategy = make()
        params = bfopt.replicate(params0, n)
        state = bfopt.init_distributed(strategy, params)
        step = bfopt.make_train_step(grad_fn, strategy)
        counts, nbytes = accounting(name, params, dyn)
        params, state, loss = step(params, state, batch)        # warm-up
        hard_sync(loss)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            params, state, loss = step(params, state, batch)
        hard_sync(loss)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"{name}: the loss is not finite")
        wire_mib = nbytes / 2 ** 20
        rows.append({
            "strategy": name,
            "collectives": ", ".join(f"{k}x{v}" for k, v in
                                     sorted(counts.items())) or "none",
            "wire_mib": wire_mib,
            "wire_mib_per_step_per_chip": (wire_mib / len(dyn)
                                           if "dynamic" in name
                                           else wire_mib),
            "ms_per_step": ms})
        del params, state, step
    return {"ranks": n, "dim": args.dim, "params_per_rank": p_count,
            "batch_per_rank": BATCH, "iters": args.iters,
            "dynamic_period": len(dyn), "rows": rows}


def report(doc: dict, as_json: bool) -> None:
    if as_json:
        for r in doc["rows"]:
            print(json.dumps({
                "strategy": r["strategy"], "collectives": r["collectives"],
                "wire_mib_per_step_per_chip":
                    round(r["wire_mib_per_step_per_chip"], 3),
                "ms_per_step": round(r["ms_per_step"], 2)}))
        return
    p_count = doc["params_per_rank"]
    print(f"# {doc['ranks']} ranks, Exp2 topology, MLP {p_count:,} params "
          f"({p_count * 4 / 2 ** 20:.1f} MiB f32), batch "
          f"{doc['batch_per_rank']}/rank")
    print(f"{'strategy':<20} {'collectives (per step)':<34} "
          f"{'wire MiB/chip':>13} {'ms/step':>9}")
    for r in doc["rows"]:
        note = ""
        if "dynamic" in r["strategy"]:
            # every schedule of the period is counted; one runs a step
            note = (f"  († executes 1 of {doc['dynamic_period']} "
                    f"branches/step: {r['wire_mib_per_step_per_chip']:.2f} "
                    "MiB)")
        print(f"{r['strategy']:<20} {r['collectives']:<34} "
              f"{r['wire_mib']:>13.2f} {r['ms_per_step']:>9.2f}{note}")


def run(args) -> dict:
    bf.init(size=RANKS, device=resolve_device(args.device))
    try:
        doc = bench(args)
    finally:
        bf.shutdown()
    report(doc, args.json)
    return doc


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
