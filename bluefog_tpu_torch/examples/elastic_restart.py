"""Elastic checkpoint / resume: train on 8 ranks, crash, resume on 4 (the
port of ``examples/elastic_restart.py``).

1. 8 stacked ranks train a least-squares model decentralized
   (combine-then-adapt gossip over weighted ``ExponentialTwoGraph``, Adam
   at 0.05) and checkpoint every K steps through
   :class:`~bluefog_tpu_torch.checkpoint.AsyncSaver` (the save overlaps
   training; its snapshot is taken before ``save`` returns).
2. "Crash": the script shuts the 8-rank context down.
3. A 4-rank context restores the latest complete checkpoint,
   ``resize_distributed`` maps the 8 rank-states onto 4 (survivors keep
   their trajectories), the optimizer state re-initializes, and training
   continues to the 4-rank optimum (end condition: every rank within
   0.35 of it).
4. A wrecked rank (NaN) is re-seeded from rank 0 by
   ``broadcast_parameters`` (the reference's restart primitive).

The numpy draws are the JAX example's; the checkpoints are the port's own
format (``checkpoint.py``).

Run:    python -m bluefog_tpu_torch.examples.elastic_restart
Smoke:  python -m bluefog_tpu_torch.examples.elastic_restart --device cpu
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from .. import checkpoint as ckpt
from .. import optimizers as bfopt
from .. import topology as tu
from ..device import resolve_device
from ..parallel import context as bf
from ..utils.utility import broadcast_parameters


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--checkpoint-every", type=int, default=30)
    ap.add_argument("--dir", default=None,
                    help="checkpoint directory (default: a tmp dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    args = ap.parse_args(argv)
    if args.checkpoint_every < 1:
        ap.error("--checkpoint-every must be >= 1")
    if args.steps // 2 < args.checkpoint_every:
        ap.error("--steps must be at least 2x --checkpoint-every "
                 "(phase 1 must write at least one checkpoint to "
                 "resume from)")
    return args


def run(args: argparse.Namespace) -> dict:
    """The example's three phases; returns the losses and the error."""
    dev = resolve_device(args.device)
    ckdir = args.dir or tempfile.mkdtemp(prefix="bf_elastic_")
    D = 6
    rng = np.random.default_rng(args.seed)
    w_star = rng.normal(size=(D,))
    A8 = rng.normal(size=(8, 20, D)).astype(np.float32)
    b8 = (A8 @ w_star + 0.05 * rng.normal(size=(8, 20))).astype(np.float32)

    def grad_fn(params, batch):
        Ab, bb = batch
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((Ab @ w - bb) ** 2)
        return loss.detach(), {"w": torch.autograd.grad(loss, w)[0]}

    def make(n):
        bf.init(size=n, device=dev)
        bf.set_topology(tu.ExponentialTwoGraph(n), is_weighted=True)
        strat = bfopt.DistributedAdaptWithCombineOptimizer(
            bfopt.adam(0.05), communication_type="neighbor_allreduce")
        return strat, bfopt.make_train_step(grad_fn, strat)

    def dev_batch(A, b):
        return (torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev))

    # ---- phase 1: 8 ranks, checkpoint every K steps (async) -------------
    strat, step = make(8)
    try:
        params = bfopt.replicate({"w": torch.zeros(D, device=dev)}, 8)
        state = bfopt.init_distributed(strat, params)
        batch = dev_batch(A8, b8)
        saver = ckpt.AsyncSaver()
        half = args.steps // 2
        for it in range(half):
            params, state, loss = step(params, state, batch)
            if (it + 1) % args.checkpoint_every == 0:
                saver.save(ckdir, {"params": params}, step=it + 1)
        saver.close()
        l8 = float(loss.mean())
        print(f"[8 ranks] step {half}: loss {l8:.4f}, "
              f"checkpoints at {sorted(ckpt.all_steps(ckdir))}", flush=True)
    finally:
        bf.shutdown()

    # ---- phase 2: "crash"; resume on HALF the ranks ---------------------
    restored, at = ckpt.restore_latest(ckdir)
    print(f"[resume] restored step {at} on a 4-rank world", flush=True)
    strat, step = make(4)
    try:
        params4 = {k: v.to(dev) for k, v in ckpt.resize_distributed(
            restored["params"], 4, mode="slice").items()}
        # fresh optimizer state on the new world (moments are rank-local)
        state4 = bfopt.init_distributed(strat, params4)
        batch4 = dev_batch(A8[:4], b8[:4])
        for _ in range(args.steps - half):
            params4, state4, loss = step(params4, state4, batch4)
        w4 = params4["w"].detach().cpu().numpy()
        # the 4-rank objective has its own optimum (first 4 shards)
        AtA = sum(A8[r].T @ A8[r] for r in range(4))
        Atb = sum(A8[r].T @ b8[r] for r in range(4))
        w_opt4 = np.linalg.solve(AtA, Atb)
        err = max(np.abs(w4[r] - w_opt4).max() for r in range(4))
        print(f"[4 ranks] resumed and converged: max |w - w*| = {err:.3f}",
              flush=True)
        assert err < 0.35, "elastic resume failed to converge"

        # ---- phase 3: wrecked-rank restart (reference flow) -------------
        wrecked = {k: v.clone() for k, v in params4.items()}
        wrecked["w"][2] = float("nan")
        healed = broadcast_parameters(wrecked, root_rank=0)
        hw = healed["w"].cpu().numpy()
        assert np.isfinite(hw).all()
        np.testing.assert_array_equal(hw[2], w4[0])
        print("[restart] rank 2 wrecked (NaN) -> re-seeded from rank 0 via "
              "broadcast_parameters", flush=True)
    finally:
        bf.shutdown()
        if args.dir is None:
            shutil.rmtree(ckdir, ignore_errors=True)
    print("[elastic] 8-rank train -> crash -> 4-rank resume -> "
          "wrecked-rank heal: all OK", flush=True)
    return {"loss8": l8, "restored_step": at, "err": float(err)}


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
