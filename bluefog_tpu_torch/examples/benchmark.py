"""Synthetic throughput benchmark over every distributed-optimizer flavor:
the port of ``examples/benchmark.py`` (the reference's
``pytorch_benchmark.py``).

Synthetic image batches (all-ones images, label 0) through the chosen
model, trained by the chosen decentralized strategy with
``sgd(0.01, momentum=0.9)`` over ``--ranks`` ranks stacked on one device
(weighted ``ExponentialTwoGraph``; the hierarchical type groups 4 ranks a
machine over a weighted machine ring).  ``--dynamic-topology`` cycles the
one-peer schedules of the JAX example's choice step by step, ``--wire``
compresses the gossip strategies' bytes, ``--atc`` swaps
combine-then-adapt for adapt-then-combine.  Prints the JAX example's two
lines and asserts the loss is finite.

Differences from the JAX example: ``--ranks`` (default 8, the JAX
example's virtual-CPU size) stacks the ranks on one device; ``--device``
defaults to the card (a missing card raises) and ``cpu`` is for tests.
``--profile PREFIX`` writes the timeline (``utils/timeline.py``:
``PREFIX.activities.json`` with the ``TRAIN`` span around the timed
iterations and the step's phases, and on the card the device trace
beside it).  The zoo keeps torch's
kernel layouts (Dense ``[out, in]``, Conv ``[O, I, kH, kW]``), so the
fused buffers hold the same values as the JAX example's in another
order: ``@B``-blocked codecs cut other blocks, and PowerSGD runs with
``out_dim=0`` to compress the flax kernels' matrices.

Run (CPU, tiny):  python -m bluefog_tpu_torch.examples.benchmark \\
                      --device cpu --model mlp --num-iters 2
Run (card):       python -m bluefog_tpu_torch.examples.benchmark
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import models
from .. import optimizers as bfopt
from .. import schedule as sch
from .. import topology as topology_util
from ..api import hard_sync
from ..device import resolve_device
from ..fusion import fuse_tree, tree_flatten, tree_map, tree_unflatten
from ..ops.collectives import _parse_wire
from ..parallel import context as bf
from ..tools.bench import make_grad_fn
from ..utils import timeline

STRATEGIES = ("neighbor_allreduce", "gradient_allreduce", "zero_allreduce",
              "choco", "allreduce", "hierarchical_neighbor_allreduce",
              "win_put", "pull_get", "push_sum", "powersgd", "empty")
NO_WIRE = ("gradient_allreduce", "zero_allreduce", "push_sum", "allreduce",
           "powersgd", "empty")
NODES_PER_MACHINE = 4


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50",
                    choices=["resnet50", "resnet18", "vgg16", "vgg11", "cnn",
                             "mlp"])
    ap.add_argument("--dist-optimizer", default="neighbor_allreduce",
                    choices=list(STRATEGIES))
    ap.add_argument("--atc", action="store_true")
    ap.add_argument("--wire", default=None,
                    help="compress gossip bytes on the wire (neighbor/"
                         "hierarchical strategies): bf16 | int8 | fp8; "
                         "quantizers accept an @B block suffix "
                         "(e.g. int8@256)")
    ap.add_argument("--dynamic-topology", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-warmup", type=int, default=1)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps a call of the train step")
    ap.add_argument("--profile", default=None,
                    help="write a timeline to this path prefix")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for tests")
    return ap.parse_args(argv)


def check_wire(name: str, wire: Optional[str]) -> None:
    """The JAX example's refusal of ``--wire`` for a strategy that does
    not gossip parameters."""
    if wire and name in NO_WIRE:
        raise SystemExit(
            f"--wire applies to the gossip strategies (neighbor/"
            f"hierarchical/win_put/pull_get/choco), not {name}")


def setup_context(name: str, n: int, device, dynamic: bool):
    """The example's context (``examples/benchmark.py:94-100``) and its
    dynamic schedules (:130-146), or None."""
    hier = name.startswith("hier")
    bf.init(size=n, device=device,
            nodes_per_machine=NODES_PER_MACHINE if hier else None)
    topo = topology_util.ExponentialTwoGraph(n)
    bf.set_topology(topo, is_weighted=True)
    if hier:
        bf.set_machine_topology(
            topology_util.RingGraph(bf.machine_size()), is_weighted=True)
    if not dynamic:
        return None
    L = bf.local_size()
    if hier:
        # machine-level one-peer Exp2 schedules ride the machine axis
        gen = lambda m: topology_util.GetExp2DynamicSendRecvMachineRanks(
            n, L, m * L, 0)
        return sch.compile_dynamic_schedules(gen, bf.machine_size())
    if L > 2 and n > L:
        gen = lambda r: topology_util.GetInnerOuterExpo2DynamicSendRecvRanks(
            n, L, r)
        return sch.compile_dynamic_schedules(gen, n)
    gen = lambda r: topology_util.GetDynamicOnePeerSendRecvRanks(topo, r)
    return sch.compile_dynamic_schedules(gen, n)


def make_strategy(name: str, opt, *, atc: bool = False,
                  wire: Optional[str] = None, schedules=None,
                  out_dim: int = 0) -> bfopt.DecentralizedOptimizer:
    """The example's strategy for ``--dist-optimizer name``
    (``examples/benchmark.py:148-176``) on the live context.
    ``out_dim`` is PowerSGD's output-feature dim of a kernel: 0 for the
    port's zoo, -1 for flax-layout params."""
    check_wire(name, wire)
    if name == "gradient_allreduce":
        return bfopt.gradient_allreduce(opt)
    if name == "zero_allreduce":
        return bfopt.zero_gradient_allreduce(opt)
    if name == "choco":
        return bfopt.choco_gossip(opt, wire=wire or "int8")
    if name == "win_put":
        return bfopt.DistributedWinPutOptimizer(opt, wire=wire)
    if name == "pull_get":
        return bfopt.DistributedPullGetOptimizer(opt, wire=wire)
    if name == "push_sum":
        return bfopt.DistributedPushSumOptimizer(opt)
    if name == "powersgd":
        return bfopt.powersgd_allreduce(opt, compression_rank=4,
                                        out_dim=out_dim)
    factory = (bfopt.DistributedAdaptThenCombineOptimizer if atc
               else bfopt.DistributedAdaptWithCombineOptimizer)
    return factory(opt, communication_type=name,
                   **({"schedules": schedules} if schedules else {}),
                   **({"wire": wire} if wire else {}))


def _plain_grad_fn(model, train_flag: bool) -> Callable:
    """The example's ``grad_fn`` for a model without BatchNorm: mean
    softmax cross-entropy of the logits, the gradient of every leaf."""
    def grad_fn(variables, batch):
        images, labels = batch
        leaves, treedef = tree_flatten(variables)
        ps = [p.detach().requires_grad_() for p in leaves]
        v = tree_unflatten(treedef, ps)
        logits = (model.apply(v, images, train=False) if train_flag
                  else model.apply(v, images))
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), tree_unflatten(treedef, list(grads))
    return grad_fn


def make_model(name: str, device):
    """``(model, image shape, grad_fn, train state)`` as the example
    builds them (:102-128), the weights drawn from seed 0."""
    gen = torch.Generator().manual_seed(0)
    if name == "resnet50":
        model, img = models.ResNet50(num_classes=1000, generator=gen), \
            (224, 224, 3)
    elif name == "resnet18":
        model, img = models.ResNet18(num_classes=1000, generator=gen), \
            (224, 224, 3)
    elif name.startswith("vgg"):
        Model = models.VGG16 if name == "vgg16" else models.VGG11
        model, img = Model(num_classes=1000, generator=gen), (224, 224, 3)
    elif name == "cnn":
        model, img = models.MnistCNN(generator=gen), (28, 28, 1)
    else:
        model, img = models.MLP(features=(256, 128, 10), in_features=64,
                                generator=gen), (64,)
    variables = tree_map(lambda t: t.to(device), model.variables())
    if name.startswith("resnet"):
        state0 = {"params": variables["params"],
                  "bs": variables["batch_stats"]}
        return model, img, make_grad_fn(model), state0
    return (model, img, _plain_grad_fn(model, name != "mlp"),
            {"params": variables["params"]})


@dataclass
class Run:
    """A built benchmark: ``step(params, state, batch)`` and its inputs."""
    step: Callable
    strategy: Any
    params: Any
    state: Any
    batch: Any
    n: int
    schedules: Any = None


def build(args: argparse.Namespace, batch=None,
          dtype: Optional[torch.dtype] = None) -> Run:
    """Context, model, strategy and train step; ``batch`` (rank-stacked
    ``(images, labels)``) replaces the synthetic one, ``dtype`` casts the
    model's variables."""
    name = args.dist_optimizer
    check_wire(name, args.wire)
    dev = resolve_device(args.device)
    n = args.ranks
    scheds = setup_context(name, n, dev, args.dynamic_topology)
    model, img, grad_fn, state0 = make_model(args.model, dev)
    if dtype is not None:
        state0 = tree_map(lambda t: t.to(dtype), state0)
    strategy = make_strategy(name, bfopt.sgd(0.01, momentum=0.9),
                             atc=args.atc, wire=args.wire, schedules=scheds)
    if batch is None:
        B = args.batch_size
        batch = (torch.ones((1, B) + img, device=dev).expand(
                     (n, B) + img),
                 torch.zeros((1, B), dtype=torch.long, device=dev).expand(
                     n, B))
    params = bfopt.replicate(state0, n)
    state = bfopt.init_distributed(strategy, params)
    spc = args.steps_per_call
    step = bfopt.make_train_step(grad_fn, strategy, steps_per_call=spc,
                                 reuse_batch=spc > 1)
    return Run(step, strategy, params, state, batch, n, scheds)


def label(args: argparse.Namespace) -> str:
    return (f"{args.dist_optimizer}"
            f"{'+dynamic' if args.dynamic_topology else ''}"
            f"{' (ATC)' if args.atc else ''}")


def _codec_bytes(wire: Optional[str], numel: int, itemsize: int) -> int:
    """Bytes one buffer of ``numel`` elements takes on the wire."""
    if wire is None:
        return numel * itemsize
    base, blk = _parse_wire(wire)
    if base == "bf16":
        return 2 * numel
    if blk is None:
        return numel + 4                 # 1-byte codes + one f32 scale
    nb = -(-numel // blk)
    return nb * blk + 4 * nb


def wire_bytes_per_rank(args: argparse.Namespace, params,
                        schedules=None) -> int:
    """Bytes the busiest rank puts on the wire a step, counted from the
    schedule tables (out-degrees; the period's mean for a dynamic
    topology) and the codecs' widths, over the fused per-dtype buffers.
    An allreduce is counted as a ring's ``2 (n - 1) / n`` of its bytes;
    the in-machine mean of the hierarchical type likewise over a
    machine's ranks."""
    name, n = args.dist_optimizer, args.ranks
    wire = args.wire or ("int8" if name == "choco" else None)
    bufs = [(b.shape[1], b.element_size())
            for b in fuse_tree(params).buffers]
    full = sum(numel * item for numel, item in bufs)
    coded = sum(_codec_bytes(wire, numel, item) for numel, item in bufs)
    ring = lambda nbytes, k: 2 * (k - 1) * nbytes / k
    if name == "empty":
        return 0
    if name in ("gradient_allreduce", "allreduce", "zero_allreduce"):
        return int(ring(full, n))
    if name == "powersgd":
        total = 0
        for leaf in tree_flatten(params)[0]:
            shape = tuple(leaf.shape[1:])
            if len(shape) >= 2 and leaf[0].numel() >= 2048:
                k, m = shape[0], int(np.prod(shape[1:]))
                total += (m + k) * min(4, m, k) * 4
            else:
                total += leaf[0].numel() * leaf.element_size()
        return int(ring(total, n))
    # only the neighbor types take the dynamic schedules
    if name.startswith("hier"):
        scheds = schedules or [bf.machine_schedule()]
        deg = float(np.mean([s.out_degree.max() for s in scheds]))
        return int(ring(full, bf.local_size()) + deg * coded)
    if name != "neighbor_allreduce" or not schedules:
        schedules = [bf.static_schedule()]
    deg = float(np.mean([s.out_degree.max() for s in schedules]))
    if name == "push_sum":
        return int(deg * (full + 4 * len(bufs)))   # + each buffer's p
    return int(deg * coded)


def run(args: argparse.Namespace, batch=None) -> dict:
    """Build, warm up, time ``--num-iters`` calls; prints the example's
    two lines and returns the numbers with the final params.  On the card
    cuDNN picks its algorithms by timing them (``cudnn.benchmark``) for
    the run, as ``tools/bench.py`` does."""
    benchmark = torch.backends.cudnn.benchmark
    if resolve_device(args.device).type == "cuda":
        torch.backends.cudnn.benchmark = True
    try:
        return _timed(args, batch)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _timed(args: argparse.Namespace, batch) -> dict:
    b = build(args, batch)
    params, state = b.params, b.state
    if args.profile:
        timeline.start_timeline(args.profile)
    loss = None
    for _ in range(args.num_warmup):
        params, state, loss = b.step(params, state, b.batch)
    hard_sync(loss if loss is not None else params)
    first = None if loss is None else loss.detach().clone()
    t0 = time.perf_counter()
    with timeline.timeline_context("benchmark", "TRAIN"):
        for _ in range(args.num_iters):
            params, state, loss = b.step(params, state, b.batch)
        hard_sync(loss)
    dt = time.perf_counter() - t0
    if args.profile:
        timeline.stop_timeline()
    spc, B, n = args.steps_per_call, args.batch_size, b.n
    total = args.num_iters * spc * B * n
    print(f"Model: {args.model}, optimizer: {label(args)}")
    print(f"Total img/sec on {n} device(s): {total / dt:.1f} "
          f"({total / dt / n:.1f} per device)")
    assert np.isfinite(loss.detach().cpu().numpy()).all()
    return {"img_per_s": total / dt, "step_s": dt / (args.num_iters * spc),
            "loss_first": first, "loss_last": loss.detach(),
            "params": params, "state": state, "run": b}


def main(argv=None) -> int:
    args = parse(argv)
    try:
        run(args)
    finally:
        if bf.is_initialized():
            bf.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
