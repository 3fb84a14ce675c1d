"""MNIST training with every distributed-optimizer flavor (the port of
``examples/mnist.py``; the reference's ``examples/pytorch_mnist.py``).

The MNIST CNN over ``--ranks`` ranks stacked on one device (default 8,
the JAX example's virtual-CPU size), trained by the chosen decentralized
strategy (``sgd(lr, momentum=0.9)``; weighted ``ExponentialTwoGraph``;
``--atc`` for adapt-then-combine, ``--dynamic-topology`` for the one-peer
schedules), each rank on its own shard of the data through
:class:`~bluefog_tpu_torch.data.ShardedLoader`: one train-step call an
epoch over the loader's stacked epoch (``steps_per_call`` = the epoch's
steps).  The data is the JAX example's synthetic class-conditional blobs
(the same numpy draws), or real tensors from ``--data-dir``
(``mnist.npz``: ``x_train [N, 28, 28, 1]`` f32, ``y_train [N]`` int32).
Prints the JAX example's lines (each epoch's mean, first and last loss;
rank 0's test accuracy on held-out blobs) and asserts its end condition:
the last steps' mean loss is below the first's.

Differences from the JAX example: the weights are drawn by the port's
init from seed 0 (``train(variables=...)`` takes another set, such as a
flax init converted by ``models.variables_from_jax``); ``--device``
defaults to the card and ``cpu`` is for tests.

Run:    python -m bluefog_tpu_torch.examples.mnist [--dist-optimizer win_put]
Smoke:  python -m bluefog_tpu_torch.examples.mnist --device cpu --epochs 1
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import models
from .. import optimizers as bfopt
from .. import schedule as sch
from .. import topology as topology_util
from ..data import ShardedLoader
from ..device import resolve_device
from ..fusion import tree_flatten, tree_map, tree_unflatten
from ..parallel import context as bf

STRATEGIES = ("neighbor_allreduce", "gradient_allreduce", "zero_allreduce",
              "choco", "allreduce", "hierarchical_neighbor_allreduce",
              "win_put", "push_sum", "empty")


def synthetic_mnist(rng, n_samples=2048):
    """Class-conditional gaussian blobs in image space (the JAX example's
    draws): a learnable stand-in for MNIST."""
    y = rng.integers(0, 10, n_samples)
    x = rng.normal(0.0, 0.3, size=(n_samples, 28, 28, 1))
    for i in range(n_samples):
        c = y[i]
        x[i, 2 * c: 2 * c + 6, 8:20, 0] += 1.5     # class-dependent bar
    return x.astype("float32"), y.astype("int32")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dist-optimizer", default="neighbor_allreduce",
                    choices=STRATEGIES)
    ap.add_argument("--atc", action="store_true",
                    help="adapt-then-combine instead of combine-then-adapt")
    ap.add_argument("--dynamic-topology", action="store_true")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def make_strategy(name: str, opt, *, atc: bool = False, schedules=None):
    """The example's strategy for ``--dist-optimizer name`` on the live
    context."""
    if name == "gradient_allreduce":
        return bfopt.gradient_allreduce(opt)
    if name == "zero_allreduce":
        return bfopt.zero_gradient_allreduce(opt)
    if name == "choco":
        return bfopt.choco_gossip(opt)
    if name == "win_put":
        return bfopt.DistributedWinPutOptimizer(opt)
    if name == "push_sum":
        return bfopt.DistributedPushSumOptimizer(opt)
    factory = (bfopt.DistributedAdaptThenCombineOptimizer if atc
               else bfopt.DistributedAdaptWithCombineOptimizer)
    return factory(opt, communication_type=name,
                   **({"schedules": schedules} if schedules else {}))


def make_grad_fn(model):
    """Mean softmax cross-entropy of the eval-mode logits (the JAX
    example applies the CNN with ``train=False``: no dropout)."""
    def grad_fn(variables, batch):
        xb, yb = batch
        leaves, treedef = tree_flatten(variables)
        ps = [p.detach().requires_grad_() for p in leaves]
        logits = model.apply(tree_unflatten(treedef, ps), xb, train=False)
        loss = F.cross_entropy(logits, yb.long())
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), tree_unflatten(treedef, list(grads))
    return grad_fn


def train(args: argparse.Namespace, variables: Optional[dict] = None
          ) -> dict:
    """The example's loop; returns each epoch's ``[ranks, steps]`` losses,
    the accuracy and the final params.  ``variables`` replaces the
    port's own init (``{"params": ...}`` in the port's layout)."""
    dev = resolve_device(args.device)
    name = args.dist_optimizer
    hier = name.startswith("hier")
    bf.init(size=args.ranks, device=dev,
            nodes_per_machine=2 if hier else None)
    try:
        n = bf.size()
        topo = topology_util.ExponentialTwoGraph(n)
        bf.set_topology(topo, is_weighted=True)
        if hier:
            bf.set_machine_topology(
                topology_util.RingGraph(bf.machine_size()),
                is_weighted=True)

        rng = np.random.default_rng(args.seed)
        if args.data_dir:
            d = np.load(os.path.join(args.data_dir, "mnist.npz"))
            x_all, y_all = d["x_train"], d["y_train"]
        else:
            x_all, y_all = synthetic_mnist(rng)

        model = models.MnistCNN(generator=torch.Generator().manual_seed(0))
        if variables is None:
            variables = model.variables()
        params = tree_map(lambda t: t.to(dev), dict(variables))

        scheds = None
        if args.dynamic_topology:
            scheds = sch.compile_dynamic_schedules(
                lambda r: topology_util.GetDynamicOnePeerSendRecvRanks(
                    topo, r), n)
        strategy = make_strategy(name, bfopt.sgd(args.lr, momentum=0.9),
                                 atc=args.atc, schedules=scheds)

        # shard the dataset: rank r sees shard r (distinct data)
        loader = ShardedLoader([x_all, y_all], args.batch_size,
                               shuffle=True, seed=args.seed)
        steps_per_epoch = loader.steps_per_epoch()
        dist_params = bfopt.replicate(params, n)
        dist_state = bfopt.init_distributed(strategy, dist_params)
        step = bfopt.make_train_step(make_grad_fn(model), strategy,
                                     steps_per_call=steps_per_epoch)

        history = []
        for epoch in range(args.epochs):
            # one call an epoch over the loader's stacked batches
            xb, yb = loader.epoch_arrays()
            dist_params, dist_state, losses = step(dist_params, dist_state,
                                                   (xb, yb))
            losses = losses.detach().cpu().numpy()
            history.append(losses)
            print(f"epoch {epoch}: mean loss {losses.mean():.4f} "
                  f"(first {losses[:, 0].mean():.4f} -> last "
                  f"{losses[:, -1].mean():.4f})", flush=True)

        # rank 0's params on held-out synthetic data
        x_test, y_test = synthetic_mnist(
            np.random.default_rng(args.seed + 1), 512)
        p0 = tree_map(lambda x: x[0], dist_params)
        with torch.no_grad():
            logits = model.apply(p0, torch.from_numpy(x_test).to(dev),
                                 train=False)
        acc = float((logits.argmax(-1).cpu().numpy() == y_test).mean())
        print(f"[{name}{'+dynamic' if args.dynamic_topology else ''}] "
              f"test accuracy: {acc:.3f}", flush=True)
        assert losses[:, -1].mean() < losses[:, 0].mean(), \
            "loss did not decrease"
        return {"losses": history, "accuracy": acc, "params": dist_params}
    finally:
        bf.shutdown()


def main(argv=None) -> int:
    train(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
