"""Decentralized optimization algorithms over virtual topologies: the port
of ``examples/decentralized_optimization.py`` (the reference's
``examples/pytorch_optimization.py``).

A distributed least-squares problem (each rank's ``f_r(w) = ||A_r w -
b_r||^2 / 30`` over its own 30 rows, 10 unknowns, data from ``--seed``)
solved over 8 ranks stacked on one device by the classical decentralized
first-order methods:

* **diffusion** (adapt-then-combine):   x+ = Comb(x - lr * grad(x))
* **exact diffusion** (bias-corrected): psi = x - lr grad; x+ =
  Comb_(I+W)/2(psi + x - psi_prev), on the mesh grid's symmetric weights
* **gradient tracking**:                the library strategy
  (:func:`bluefog_tpu_torch.optimizers.gradient_tracking`)
* **push-DIGing** (directed Exp2, push-sum weights): the library strategy
  (:func:`bluefog_tpu_torch.optimizers.push_diging`)

The first two are loops over ``neighbor_allreduce``; the last two run
``--max-iters`` steps through one call of ``make_train_step``.  Each
prints the JAX example's ``[method] max |w - w_opt| = ...`` line, and the
run asserts that every method ends within 0.05 of the global optimum.

Differences from the JAX example: the 8 ranks are stacked on one device
(the JAX example's virtual-CPU size); ``--device`` defaults to the card
(a missing card raises) and ``cpu`` is for tests.

Run (CPU):   python -m bluefog_tpu_torch.examples.decentralized_optimization \\
                 --device cpu
Run (card):  python -m bluefog_tpu_torch.examples.decentralized_optimization
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from .. import optimizers as bfopt
from .. import topology as topology_util
from ..device import resolve_device
from ..ops import collectives as ops
from ..parallel import context as bf

RANKS = 8
D = 10
ROWS = 30


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="all",
                    choices=["all", "diffusion", "exact_diffusion",
                             "gradient_tracking", "push_diging"])
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=2020)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def problem(seed: int, n: int, device):
    """``(A [n, 30, 10], b [n, 30], w_opt [10])``: the JAX example's draws
    (f32 data; ``b`` computed in f32), and the global least-squares
    solution from the host's normal equations."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=(D,))
    A = torch.from_numpy(rng.normal(size=(n, ROWS, D)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(n, ROWS))).to(torch.float32)
    b = A @ torch.from_numpy(w_star).to(torch.float32) + 0.05 * noise
    An, bn = A.numpy(), b.numpy()
    AtA = np.einsum("rij,rik->jk", An, An)
    Atb = np.einsum("rij,ri->j", An, bn)
    return A.to(device), b.to(device), np.linalg.solve(AtA, Atb)


def grad(w: torch.Tensor, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each rank's ``2 A_r^T (A_r w_r - b_r) / 30``, stacked (or one
    rank's, unstacked)."""
    r = (A @ w[..., None])[..., 0] - b
    return 2.0 * (A.transpose(-1, -2) @ r[..., None])[..., 0] / A.shape[-2]


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Every chosen method; returns its ``max |w - w_opt|``."""
    dev = resolve_device(args.device)
    n = RANKS
    bf.init(size=n, device=dev)
    try:
        return _methods(args, n, dev)
    finally:
        bf.shutdown()


def _report(name, w, w_opt, iters, label="w"):
    err = float(np.abs(w.detach().cpu().numpy() - w_opt).max())
    print(f"[{name}] max |{label} - w_opt| = {err:.4e} after {iters} iters")
    return err


def _methods(args, n, dev) -> Dict[str, float]:
    A, b, w_opt = problem(args.seed, n, dev)
    lr, iters = args.lr, args.max_iters
    zeros = torch.zeros((n, D), dtype=torch.float32, device=dev)
    results: Dict[str, float] = {}

    if args.method in ("all", "diffusion"):
        # x+ = Comb(x - lr * grad(x))   (ATC diffusion)
        bf.set_topology(topology_util.ExponentialTwoGraph(n),
                        is_weighted=True)
        sched = bf.static_schedule()
        w = zeros.clone()
        for _ in range(iters):
            w = ops.neighbor_allreduce(w - lr * grad(w, A, b), sched)
        results["diffusion"] = _report("diffusion", w, w_opt, iters)

    if args.method in ("all", "exact_diffusion"):
        # psi = x - lr*grad; phi = psi + x - psi_prev; x+ = Comb_(I+W)/2(phi)
        # on the mesh grid's symmetric doubly-stochastic (Hastings) weights
        bf.set_topology(topology_util.MeshGrid2DGraph(n), is_weighted=True)
        sched = bf.static_schedule()
        w, psi_prev = zeros.clone(), zeros.clone()
        for _ in range(iters):
            psi = w - lr * grad(w, A, b)
            phi = psi + w - psi_prev
            w = 0.5 * phi + 0.5 * ops.neighbor_allreduce(phi, sched)
            psi_prev = psi
        results["exact_diffusion"] = _report("exact_diffusion", w, w_opt,
                                             iters)

    def grad_fn(p, batch):
        Ar, br = batch
        r = Ar @ p["w"] - br
        return torch.mean(r ** 2), {"w": grad(p["w"], Ar, br)}

    def run_strategy(name, strategy, label="w"):
        step = bfopt.make_train_step(grad_fn, strategy,
                                     steps_per_call=iters, reuse_batch=True)
        params = {"w": zeros.clone()}
        state = bfopt.init_distributed(strategy, params)
        params, _, _ = step(params, state, (A, b))
        return _report(name, params["w"], w_opt, iters, label)

    if args.method in ("all", "gradient_tracking"):
        # x+ = Comb(x - lr*y);  y+ = Comb(y) + grad(x) - grad(x_prev)
        bf.set_topology(topology_util.ExponentialTwoGraph(n),
                        is_weighted=True)
        results["gradient_tracking"] = run_strategy(
            "gradient_tracking", bfopt.gradient_tracking(
                bfopt.sgd(lr),
                bfopt.neighbor_communicator(bf.static_schedule())))

    if args.method in ("all", "push_diging"):
        # push-DIGing on the directed Exp2 with column-stochastic push
        # weights: the params the strategy returns are z = u / p
        topo = topology_util.ExponentialTwoGraph(n)
        bf.set_topology(topo)
        results["push_diging"] = run_strategy(
            "push_diging", bfopt.push_diging(
                bfopt.sgd(lr), bfopt.push_schedule(topo, n)), label="w/p")

    bad = {k: v for k, v in results.items() if v > 0.05}
    assert not bad, f"methods failed to converge: {bad}"
    print("all methods converged to the global optimum")
    return results


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
