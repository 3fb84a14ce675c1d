"""Average consensus over virtual topologies (counterpart of
``examples/average_consensus.py``).

Every rank starts from a random vector and repeatedly neighbor-averages
until all ranks agree on the global mean: static topologies (weighted)
and dynamic one-peer Exp2 schedules, over ``--ranks`` ranks stacked on
one device.

Run:    python -m bluefog_tpu_torch.examples.average_consensus [--dynamic]
Smoke:  python -m bluefog_tpu_torch.examples.average_consensus \\
            --device cpu --data-size 100
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import schedule as sch
from bluefog_tpu_torch import topology as topology_util

TOPOLOGIES = {
    "expo2": topology_util.ExponentialTwoGraph,
    "ring": topology_util.RingGraph,
    "mesh2d": topology_util.MeshGrid2DGraph,
    "star": topology_util.StarGraph,
    "full": topology_util.FullyConnectedGraph,
}


def consensus(topology: str = "expo2", *, dynamic: bool = False,
              ranks: int = 8, data_size: int = 1000, max_iters: int = 200,
              seed: int = 2020, device=None) -> List[float]:
    """The example's loop; returns the MSE to the global mean after each
    iteration (it stops below 1e-10)."""
    bf.init(size=ranks, device=device)
    n = bf.size()
    topo = TOPOLOGIES[topology](n)
    bf.set_topology(topo, is_weighted=True)

    rng = np.random.default_rng(seed)
    x = bf.shard_distributed(torch.as_tensor(
        rng.normal(size=(n, data_size)).astype(np.float32)))
    global_mean = x.cpu().numpy().mean(axis=0)

    dynamic_scheds = None
    if dynamic:
        dynamic_scheds = sch.compile_dynamic_schedules(
            lambda r: topology_util.GetDynamicOnePeerSendRecvRanks(topo, r),
            n)

    mse_history = []
    for it in range(max_iters):
        if dynamic_scheds is not None:
            x = bf.neighbor_allreduce(
                x, schedule=dynamic_scheds[it % len(dynamic_scheds)])
        else:
            x = bf.neighbor_allreduce(x)
        mse = float(((x.cpu().numpy() - global_mean) ** 2).mean())
        mse_history.append(mse)
        if mse < 1e-10:
            break
    return mse_history


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-size", type=int, default=1000)
    parser.add_argument("--max-iters", type=int, default=200)
    parser.add_argument("--ranks", type=int, default=8,
                        help="ranks stacked on the device")
    parser.add_argument("--topology", default="expo2",
                        choices=sorted(TOPOLOGIES))
    parser.add_argument("--dynamic", action="store_true",
                        help="dynamic one-peer Exp2 schedule")
    parser.add_argument("--seed", type=int, default=2020)
    parser.add_argument("--device", default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    mse_history = consensus(args.topology, dynamic=args.dynamic,
                            ranks=args.ranks, data_size=args.data_size,
                            max_iters=args.max_iters, seed=args.seed,
                            device=args.device)
    print(f"[{args.topology}{'+dynamic' if args.dynamic else ''}] "
          f"{args.ranks} ranks: consensus MSE {mse_history[-1]:.3e} "
          f"after {len(mse_history)} iterations")
    if mse_history[-1] >= 1e-6:
        raise AssertionError("consensus failed to converge")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
