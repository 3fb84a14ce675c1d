"""ResNet training: LR warmup and step decay, validation accuracy,
dynamic topology, checkpoint resume (the port of ``examples/resnet.py``;
the reference's ``examples/pytorch_resnet.py``).

ResNet-18 or -50 (16 base filters, 10 classes, bf16 convolutions) over
``--ranks`` stacked ranks (default 8, the JAX example's virtual-CPU
size), trained by gossip (``--dist-optimizer``, weighted
``ExponentialTwoGraph``, ``--dynamic-topology`` for the one-peer
schedules) with SGD (momentum 0.9) whose learning rate warms up linearly
from ``base_lr / 10`` over ``--warmup-epochs``, then drops 10x at 50 % and
again at 75 % of the remaining steps (optax's ``join_schedules`` of the JAX
example, step for step).  One train-step call an epoch over the
:class:`~bluefog_tpu_torch.data.ShardedLoader`'s stacked epoch; rank 0's
validation accuracy after each, with per-batch BatchNorm statistics (the
running statistics stay at their init, as in the JAX example).
``--checkpoint-dir`` saves ``{"params", "state"}`` after every epoch
(``keep=2``) and resumes from the newest complete one.  Data: the JAX
example's synthetic CIFAR-shaped blobs (the same numpy draws), or
``cifar.npz`` from ``--data-dir``.  End condition: every loss is finite.

Run:    python -m bluefog_tpu_torch.examples.resnet [--model resnet50]
Smoke:  python -m bluefog_tpu_torch.examples.resnet --device cpu \\
            --epochs 2 --train-size 512 --batch-size 16
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import checkpoint as ckpt
from .. import models
from .. import optimizers as bfopt
from .. import schedule as sch
from .. import topology as topology_util
from ..data import ShardedLoader
from ..device import resolve_device
from ..fusion import tree_flatten, tree_map, tree_unflatten
from ..parallel import context as bf


def synthetic_cifar(rng, n, size=32):
    """CIFAR-shaped class-conditional blobs (the JAX example's draws)."""
    y = rng.integers(0, 10, n)
    x = rng.normal(0.0, 0.25, size=(n, size, size, 3))
    for i in range(n):
        c = int(y[i])
        x[i, 3 * c: 3 * c + 5, :, c % 3] += 1.2
    return x.astype("float32"), y.astype("int32")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "resnet50"])
    ap.add_argument("--dist-optimizer", default="neighbor_allreduce",
                    choices=["neighbor_allreduce", "gradient_allreduce",
                             "allreduce", "empty"])
    ap.add_argument("--dynamic-topology", action="store_true")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--warmup-epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--base-lr", type=float, default=0.05)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save per-epoch checkpoints and resume from the "
                         "latest one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def lr_schedule(base_lr: float, warmup_steps: int, total_steps: int
                ) -> Callable[[int], float]:
    """``optax.join_schedules([linear_schedule(base / 10, base, warmup),
    piecewise_constant_schedule(base, {total * 0.5: 0.1, total * 0.75:
    0.1})], [warmup])``: the decay's boundaries count from the end of the
    warmup, as ``join_schedules`` passes ``step - boundary`` on."""
    bounds = (int(total_steps * 0.5), int(total_steps * 0.75))

    def lr(step: int) -> float:
        if step < warmup_steps:
            frac = min(max(step, 0), warmup_steps) / warmup_steps
            return base_lr / 10 + (base_lr - base_lr / 10) * frac
        v = base_lr
        for b in bounds:
            if step - warmup_steps >= b:
                v *= 0.1
        return v
    return lr


class ScheduledSGD(torch.optim.SGD):
    """``torch.optim.SGD`` (optax's ``sgd(schedule, momentum)``: momentum
    as a trace, no dampening) whose learning rate follows ``schedule``
    over its own step count, as optax's ``scale_by_learning_rate`` reads
    its count."""

    def __init__(self, params, schedule: Callable[[int], float],
                 momentum: float):
        super().__init__(params, lr=schedule(0), momentum=momentum,
                         dampening=0.0)
        self._schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self._schedule(self.count)
        self.count += 1
        return super().step(closure)


def make_grad_fn(model):
    """Train-mode logits (per-batch BatchNorm statistics) into mean
    softmax cross-entropy; the running statistics' gradient is zero, so
    they stay at their init (as in the JAX example)."""
    zeros = {}

    def grad_fn(train_state, batch):
        images, labels = batch
        leaves, treedef = tree_flatten(train_state["params"])
        ps = [p.detach().requires_grad_() for p in leaves]
        logits, _ = model.apply(
            {"params": tree_unflatten(treedef, ps),
             "batch_stats": train_state["bs"]}, images, train=True)
        loss = F.cross_entropy(logits, labels.long())
        grads = torch.autograd.grad(loss, ps)
        if "bs" not in zeros:
            zeros["bs"] = tree_map(torch.zeros_like, train_state["bs"])
        return loss.detach(), {"params": tree_unflatten(treedef,
                                                        list(grads)),
                               "bs": zeros["bs"]}
    return grad_fn


def train(args: argparse.Namespace, variables: Optional[dict] = None
          ) -> dict:
    """The example's loop; returns each epoch's losses and accuracy and
    the epoch it started from.  ``variables`` replaces the port's own
    init (``{"params", "batch_stats"}`` in the port's layout)."""
    dev = resolve_device(args.device)
    bf.init(size=args.ranks, device=dev)
    try:
        n = bf.size()
        topo = topology_util.ExponentialTwoGraph(n)
        bf.set_topology(topo, is_weighted=True)

        rng = np.random.default_rng(args.seed)
        if args.data_dir:
            d = np.load(os.path.join(args.data_dir, "cifar.npz"))
            x_tr, y_tr, x_te, y_te = (d["x_train"], d["y_train"],
                                      d["x_test"], d["y_test"])
        else:
            x_tr, y_tr = synthetic_cifar(rng, args.train_size)
            x_te, y_te = synthetic_cifar(
                np.random.default_rng(args.seed + 1), 512)

        Model = models.ResNet18 if args.model == "resnet18" \
            else models.ResNet50
        model = Model(num_classes=10, num_filters=16,
                      generator=torch.Generator().manual_seed(0))
        if variables is None:
            variables = model.variables()
        variables = tree_map(lambda t: t.to(dev), dict(variables))
        state0 = {"params": variables["params"],
                  "bs": variables["batch_stats"]}

        loader = ShardedLoader([x_tr, y_tr], args.batch_size, shuffle=True,
                               seed=args.seed)
        steps_per_epoch = loader.steps_per_epoch()
        total_steps = steps_per_epoch * args.epochs
        sched_fn = lr_schedule(args.base_lr,
                               args.warmup_epochs * steps_per_epoch,
                               total_steps)
        opt = lambda ps: ScheduledSGD(ps, sched_fn, momentum=0.9)

        scheds = None
        if args.dynamic_topology:
            scheds = sch.compile_dynamic_schedules(
                lambda r: topology_util.GetDynamicOnePeerSendRecvRanks(
                    topo, r), n)
        name = args.dist_optimizer
        if name == "gradient_allreduce":
            strategy = bfopt.gradient_allreduce(opt)
        else:
            strategy = bfopt.DistributedAdaptWithCombineOptimizer(
                opt, communication_type=name,
                **({"schedules": scheds} if scheds else {}))

        dist_params = bfopt.replicate(state0, n)
        dist_state = bfopt.init_distributed(strategy, dist_params)
        start_epoch = 0
        if args.checkpoint_dir:
            restored, at = ckpt.restore_latest(
                args.checkpoint_dir,
                template={"params": dist_params, "state": dist_state})
            if restored is not None:
                dist_params, dist_state = restored["params"], \
                    restored["state"]
                # the schedule's count is the optimizer's own steps
                dist_state.opt_state.count = at * steps_per_epoch
                start_epoch = at
                # the loader's shuffles continue from the resumed epoch
                loader._epoch = at
                print(f"resumed from epoch {at}", flush=True)

        step = bfopt.make_train_step(make_grad_fn(model), strategy,
                                     steps_per_call=steps_per_epoch)

        def evaluate(p0):
            # per-batch statistics: the running ones are not tracked
            with torch.no_grad():
                logits, _ = model.apply(
                    {"params": p0["params"], "batch_stats": p0["bs"]},
                    torch.from_numpy(x_te).to(dev), train=True)
            return float((logits.argmax(-1).cpu().numpy() == y_te).mean())

        history = []
        losses = None
        for epoch in range(start_epoch, args.epochs):
            xb, yb = loader.epoch_arrays()
            dist_params, dist_state, losses = step(dist_params, dist_state,
                                                   (xb, yb))
            losses = losses.detach().float().cpu().numpy()
            acc = evaluate(tree_map(lambda x: x[0], dist_params))
            history.append((float(losses.mean()), acc))
            print(f"epoch {epoch}: train loss {losses.mean():.4f}, "
                  f"val acc (rank0 model) {acc:.3f}", flush=True)
            if args.checkpoint_dir:
                ckpt.save(args.checkpoint_dir,
                          {"params": dist_params, "state": dist_state},
                          step=epoch + 1, keep=2)
        assert losses is None or np.isfinite(losses).all()
        return {"history": history, "start_epoch": start_epoch}
    finally:
        bf.shutdown()


def main(argv=None) -> int:
    train(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
