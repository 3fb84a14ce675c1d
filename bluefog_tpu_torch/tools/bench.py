"""ResNet-50 synthetic throughput of the gossip trainer on one card: the
port's counterpart of ``bench.py::run_bench``.

Synthetic ImageNet-shaped data (all-ones images, label 0, the same batch
on every rank) through ``ResNet50`` (bf16 convs, f32 BatchNorm), trained
by adapt-with-combine neighbor averaging with ``sgd(0.1, momentum=0.9)``
over ``--ranks`` ranks stacked on the one device (weighted
``ExponentialTwoGraph`` past one rank).  BatchNorm's running statistics
ride the train state with zero gradients, so they stay at init, as in
``bench.py``.  One warm-up call, then ``--iters`` timed calls of
``--steps-per-call`` steps between ``hard_sync``s.

``--plan PATH`` replays an autotune plan (``bluefog_tpu_torch.autotune``)
in place of the fixed AWC, as ``bench.py --plan`` does: its algorithm,
topology, wire, fused-k (the steps a call) and overlap, recorded as
``algorithm``, ``plan_id`` and ``config_source: "plan:<id>"``; a plan
tuned for another rank count is refused.

Prints ONE JSON line in ``bench.py``'s schema where it applies.  The
card is one chip: ``value`` is every rank's images a second on it
(stacked ranks share the card), and ``mfu`` is the model FLOPs
(``3 x 4.089 GFLOP`` an image, as ``bench.py``) over the card's dense
bf16 peak from :data:`PEAK_BF16_FLOPS` (null for a card not listed).

Run:    python -m bluefog_tpu_torch.tools.bench [--ranks 4 --batch 16]
            [--plan plan.json]
Smoke:  python -m bluefog_tpu_torch.tools.bench --device cpu \\
            --image-size 32 --classes 10 --batch 2 --steps-per-call 2 \\
            --iters 1 --ranks 2
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from .. import optimizers as bfopt
from .. import topology as topology_util
from ..api import hard_sync
from ..device import resolve_device
from ..fusion import tree_flatten, tree_map, tree_unflatten
from ..models import ResNet50
from ..parallel import context as bf

SCHEMA = "bluefog-torch-bench-1"
METRIC = "resnet50_synthetic_imgs_per_sec_per_chip"
BASELINE_PER_GPU = 4310.6 / 16  # reference: img/sec per V100, 16-GPU run
RESNET50_FWD_FLOPS = 4.089e9    # a 224 x 224 image, as bench.py counts
# dense bf16 FLOP/s by the name the card reports (NVIDIA's data sheet)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}
# (card, CPU) defaults: bench.py's accelerator and CPU-fallback workloads
DEFAULTS = {"batch": (64, 4), "steps_per_call": (5, 4), "iters": (10, 2)}


def make_grad_fn(model) -> Callable:
    """bench.py's ``grad_fn`` over one rank's ``{"params", "bs"}``: the
    train-mode logits into mean softmax cross-entropy; the ``bs`` gradient
    is zero, so the running statistics never move."""
    zeros = {}

    def grad_fn(state, data):
        images, labels = data
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        logits, _ = model.apply({"params": params,
                                 "batch_stats": state["bs"]}, images,
                                train=True)
        loss = F.cross_entropy(logits, labels)
        leaves, treedef = tree_flatten(params)
        grads = torch.autograd.grad(loss, leaves)
        if "bs" not in zeros:
            zeros["bs"] = tree_map(torch.zeros_like, state["bs"])
        return loss.detach(), {"params": tree_unflatten(treedef,
                                                        list(grads)),
                               "bs": zeros["bs"]}
    return grad_fn


@dataclass
class Bench:
    """A built benchmark: ``step(params, state, data)`` and its inputs."""
    step: Callable
    params: Any
    state: Any
    data: Any
    n: int
    algorithm: str = "neighbor_cta"
    steps_per_call: int = 1
    plan_id: Optional[str] = None


def load_plan_for(path: str, n: int):
    """The autotune plan at ``path``, refused unless it was tuned for
    ``n`` ranks (``bench.py``'s text: plans replay exactly or not at
    all)."""
    from ..autotune import load_plan
    plan = load_plan(path)
    if int(plan.doc["n_chips"]) != n:
        raise RuntimeError(
            f"plan {plan.plan_id} was tuned for "
            f"{plan.doc['n_chips']} chips but this mesh has {n}; "
            "re-tune on this mesh (plans replay exactly or not at all)")
    return plan


def build(*, ranks: int, batch: int, steps_per_call: int, image_size: int,
          num_classes: int, device=None, dtype: torch.dtype = torch.bfloat16,
          variables: Optional[dict] = None,
          plan_path: Optional[str] = None) -> Bench:
    """The benchmark's setup (``bench.py:443-505``): the context over
    ``ranks`` stacked ranks, the model (``variables`` in the port's
    layout, or a fresh init from seed 0), the AWC strategy (or the
    strategy and step knobs of the plan at ``plan_path``, whose fused-k
    replaces ``steps_per_call``) and the train step over ``replicate``d
    ``{"params", "bs"}``."""
    ctx = bf.init(size=ranks, device=device)
    n = ctx.size
    plan = load_plan_for(plan_path, n) if plan_path else None
    if n > 1:
        bf.set_topology(topology_util.ExponentialTwoGraph(n),
                        is_weighted=True)
    model = ResNet50(num_classes=num_classes, dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    if variables is None:
        variables = model.variables()
    variables = tree_map(lambda x: x.to(ctx.device), variables)
    train_state = {"params": variables["params"],
                   "bs": variables["batch_stats"]}
    images = torch.ones((1, batch, image_size, image_size, 3),
                        device=ctx.device).expand(n, -1, -1, -1, -1)
    labels = torch.zeros((1, batch), dtype=torch.long,
                         device=ctx.device).expand(n, -1)
    opt = bfopt.sgd(0.1, momentum=0.9)
    if plan is not None:
        plan.apply()
        strategy = plan.build_strategy(opt)
        step_kwargs = plan.train_step_kwargs()
        algorithm = plan.algorithm
    else:
        strategy = bfopt.adapt_with_combine(
            opt, bfopt.neighbor_communicator(bf.static_schedule()))
        step_kwargs = {"steps_per_call": steps_per_call,
                       "reuse_batch": steps_per_call > 1}
        algorithm = "neighbor_cta"
    params = bfopt.replicate(train_state, n)
    state = bfopt.init_distributed(strategy, params)
    step = bfopt.make_train_step(make_grad_fn(model), strategy,
                                 **step_kwargs)
    return Bench(step, params, state, (images, labels), n, algorithm,
                 step_kwargs["steps_per_call"],
                 plan.plan_id if plan is not None else None)


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for a smoke run")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks stacked on the device")
    ap.add_argument("--batch", type=int, default=None,
                    help="images a rank a step (card 64, CPU 4)")
    ap.add_argument("--steps-per-call", type=int, default=None,
                    help="optimizer steps a call (card 5, CPU 4)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls (card 10, CPU 2)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--plan", default=None,
                    help="replay this autotune plan's configuration")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, profiler=None):
    """Build, warm up once, time ``iters`` calls; returns ``(doc, bench)``
    with ``bench`` holding the final params.  On the card cuDNN picks its
    algorithms by timing them (``cudnn.benchmark``) for the run, and the
    setting is restored after.  ``profiler`` (a ``torch.profiler``
    context) wraps one more call after the timed ones, so that the
    profiler's host cost stays out of the timed rows."""
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    pick = {k: (v[0] if on_card else v[1]) for k, v in DEFAULTS.items()}
    batch = args.batch or pick["batch"]
    k = args.steps_per_call or pick["steps_per_call"]
    iters = args.iters or pick["iters"]
    benchmark = torch.backends.cudnn.benchmark
    if on_card:
        torch.backends.cudnn.benchmark = True
        torch.cuda.reset_peak_memory_stats()
    try:
        return _timed(args, dev, batch, k, iters, profiler)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _timed(args, dev, batch, k, iters, profiler=None):
    on_card = dev.type == "cuda"
    b = build(ranks=args.ranks, batch=batch, steps_per_call=k,
              image_size=args.image_size, num_classes=args.classes,
              device=dev, plan_path=getattr(args, "plan", None))
    k = b.steps_per_call
    params, state = b.params, b.state
    params, state, loss = b.step(params, state, b.data)
    hard_sync(loss)
    first = loss.reshape(b.n, -1)[:, 0].mean().item()
    t0 = time.perf_counter()
    for _ in range(iters):
        params, state, loss = b.step(params, state, b.data)
    hard_sync(loss)
    dt = time.perf_counter() - t0
    last = loss.reshape(b.n, -1)[:, -1].mean().item()
    if profiler is not None:
        with profiler:
            params, state, _ = b.step(params, state, b.data)
            hard_sync(params)
    b.params, b.state = params, state
    steps = iters * k
    per_card = b.n * batch * steps / dt
    step_flops = 3 * RESNET50_FWD_FLOPS * batch * b.n
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak = PEAK_BF16_FLOPS.get(kind) if on_card else None
    doc = {
        "schema": SCHEMA,
        "metric": METRIC,
        "value": per_card,
        "unit": "img/s/chip",
        "vs_baseline": per_card / BASELINE_PER_GPU,
        "ok": True,
        "strategy": b.algorithm,
        "algorithm": b.algorithm,
        "plan_id": b.plan_id,
        "config_source": (f"plan:{b.plan_id}" if b.plan_id is not None
                          else "default"),
        "on_accelerator": on_card,
        "device": kind,
        "n_chips": 1,
        "n_ranks": b.n,
        "batch_per_chip": batch * b.n,
        "batch_per_rank": batch,
        "mfu": step_flops * steps / dt / peak if peak else None,
        "steps_per_call": k,
        "iters": iters,
        "image_size": args.image_size,
        "num_classes": args.classes,
        "step_flops": step_flops,
        "per_step_s": dt / steps,
        "loss_first": first,
        "loss_last": last,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if on_card else None),
        "power_limit_w": power_limit_w() if on_card else None,
    }
    return doc, b


def main(argv=None) -> int:
    doc, _ = run(parse(argv))
    bf.shutdown()
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
