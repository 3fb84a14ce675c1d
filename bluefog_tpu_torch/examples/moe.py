"""Mixture-of-experts training: expert parallelism end to end
(counterpart of ``examples/moe.py``).

Each of the ``--num-experts`` ranks of the ``expert`` axis owns one
expert FFN (here the ranks are stacked on dim 0 of one device); a
replicated router picks an expert per token, and
:func:`~bluefog_tpu_torch.parallel.expert.moe_apply` moves every rank's
tokens to their expert's rank and back with the stacked ``all_to_all``
pair.  As in the JAX example every rank routes the same batch (the inputs
are replicated over the axis) and the loss is the mean over the ranks;
the gradients are JAX's: the router's the sum of the ranks' (JAX's
gradient of a replicated input arrives summed over the axis, and the
example's ``pmean`` of it changes nothing), each expert's the sum over
the ranks whose tokens reached it.  The autograd of the sum of the
ranks' losses gives both.  The task is expert-friendly by construction
(piecewise-linear regression: each input cluster has its own linear
map), so training converges only if routing, dispatch and return all
work.  No TPU kernel runs on this path (the experts are matmuls).

The numpy draws (clusters, maps, weights, then each step's batch) are the
JAX example's own, in its order; Adam is optax's.

Run:    python -m bluefog_tpu_torch.examples.moe [--top2]
Smoke:  python -m bluefog_tpu_torch.examples.moe --device cpu --steps 30
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch.device import resolve_device
from bluefog_tpu_torch.moe.layers import router_topk
from bluefog_tpu_torch.parallel.expert import (load_balancing_loss,
                                               moe_apply, moe_apply_topk)


def train(num_experts: int = 4, tokens: int = 64, dim: int = 8,
          steps: int = 80, top2: bool = False, balance_alpha: float = 0.01,
          lr: float = 0.05, seed: int = 0, device=None) -> List[float]:
    """The example's loop; returns each step's loss (the mean over the
    ranks, as JAX's ``pmean``)."""
    dev = resolve_device(device)
    E, D, T = num_experts, dim, tokens
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(E, D)) * 4.0
    true_maps = rng.normal(size=(E, D, D))

    def sample_batch():
        c = rng.integers(0, E, size=T)
        x = centers[c] + rng.normal(size=(T, D)) * 0.3
        y = np.einsum("td,tdh->th", x, true_maps[c])
        return (torch.from_numpy(x.astype(np.float32)).to(dev),
                torch.from_numpy(y.astype(np.float32)).to(dev))

    def param(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev) \
            .requires_grad_()

    router = param(rng.normal(size=(D, E)) * 0.1)
    expert = param(rng.normal(size=(E, D, D)) * 0.1)   # rank e owns [e]
    opt = bfopt.adam(lr)([router, expert])

    def expert_fn(w, toks):             # every owner's rows [E, rows, D]
        return torch.matmul(toks, w)

    def rank_losses(x, y):
        xs = x.expand(E, T, D)          # every rank routes the same batch
        kw = dict(capacity=T, axis_size=E, num_experts=E)
        if top2:
            _, probs, idx2, gate2 = router_topk(x, router, top_k=2)
            pred = moe_apply_topk(xs, idx2.expand(E, T, 2),
                                  gate2.expand(E, T, 2), expert_fn, expert,
                                  **kw)
            aux = load_balancing_loss(probs, idx2[:, 0])
            return ((pred - y) ** 2).mean((1, 2)) + balance_alpha * aux
        logits = x @ router
        probs = torch.softmax(logits, dim=-1)
        idx = torch.argmax(logits, dim=-1)
        gate = probs[torch.arange(T, device=dev), idx]
        out = moe_apply(xs, idx.expand(E, T), expert_fn, expert, **kw)
        return ((out * gate[:, None] - y) ** 2).mean((1, 2))

    losses = []
    for it in range(steps):
        x, y = sample_batch()
        per_rank = rank_losses(x, y)
        opt.zero_grad()
        per_rank.sum().backward()
        opt.step()
        losses.append(float(per_rank.detach().mean()))
        if it % 20 == 0 or it == steps - 1:
            print(f"step {it}: loss {losses[-1]:.4f}")
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-experts", type=int, default=4)
    parser.add_argument("--tokens", type=int, default=64)
    parser.add_argument("--dim", type=int, default=8)
    parser.add_argument("--steps", type=int, default=80)
    parser.add_argument("--top2", action="store_true",
                        help="top-2 routing with the switch-transformer "
                             "load-balancing auxiliary loss")
    parser.add_argument("--balance-alpha", type=float, default=0.01)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    losses = train(args.num_experts, args.tokens, args.dim, args.steps,
                   args.top2, args.balance_alpha, args.lr, args.seed,
                   args.device)
    assert losses[-1] < losses[0] * 0.5, "MoE did not train"
    E = args.num_experts
    print(f"[moe{'/top2' if args.top2 else ''}] {E} experts on {E} "
          f"ranks: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
