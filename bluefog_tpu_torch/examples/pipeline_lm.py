"""Pipelined LM training: GPipe stages end to end (counterpart of
``examples/pipeline_lm.py``).

The *depth* of a transformer LM is cut into stages, one decoder block a
stage, stacked on dim 0 of every stage parameter
(:mod:`bluefog_tpu_torch.parallel.pipeline`); microbatched activations
flow stage to stage, and autograd through the schedule is the backward
pipeline.  ``--interleaved V`` runs ``V`` chunks a stage on the
interleaved ring schedule, ``--hetero`` puts the embedding and the head
inside the pipe as stages of their own (``pipeline_apply_stages``).
Attention is plain torch (``einsum`` with the causal mask and softmax,
as the JAX example's ``jnp.einsum``): no TPU kernel runs on this path.

A copy-task LM (predict the token ``lag`` positions back) trains to a
lower loss, which needs gradients through every stage boundary.  The
weights and every step's batch are drawn from ``np.random.default_rng
(seed)`` in the JAX example's order, and Adam is optax's
(:func:`bluefog_tpu_torch.optimizers.adam`), so the port prints the JAX
example's losses.

Run:    python -m bluefog_tpu_torch.examples.pipeline_lm [--remat]
Smoke:  python -m bluefog_tpu_torch.examples.pipeline_lm --device cpu \\
            --steps 30 [--interleaved 2 --micro 4 | --hetero]
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch.device import resolve_device
from bluefog_tpu_torch.fusion import tree_flatten, tree_map
from bluefog_tpu_torch.parallel.pipeline import (
    pack_stage_params, pipeline_apply, pipeline_apply_stages,
    pipeline_interleaved_apply)

BATCH, VOCAB = 2, 32


def ln(z: torch.Tensor) -> torch.Tensor:
    """The example's parameter-free layer norm."""
    mu = z.mean(-1, keepdim=True)
    return (z - mu) / torch.sqrt(z.var(-1, unbiased=False, keepdim=True)
                                 + 1e-6)


def block_fn(p: Dict[str, torch.Tensor], x: torch.Tensor,
             heads: int) -> torch.Tensor:
    """One pre-LN decoder block for each of ``k`` stages at once:
    ``x [k, B, T, D]``, every leaf of ``p`` ``[k, ...]``."""
    k, B, T, D = x.shape
    hsz = D // heads
    h = ln(x)
    qkv = torch.matmul(h, p["wqkv"][:, None])
    q, kk, v = (t.reshape(k, B, T, heads, hsz)
                for t in qkv.split(D, dim=-1))
    s = torch.einsum("nbihd,nbjhd->nbhij", q, kk) / math.sqrt(hsz)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    a = torch.softmax(s, dim=-1)
    att = torch.einsum("nbhij,nbjhd->nbihd", a, v).reshape(k, B, T, D)
    x = x + torch.matmul(att, p["wo"][:, None])
    h = ln(x)
    return x + torch.matmul(
        F.gelu(torch.matmul(h, p["w1"][:, None]), approximate="tanh"),
        p["w2"][:, None])


def masked_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels`` averaged over
    the targets >= 0."""
    shifted = logits - logits.detach().amax(-1, keepdim=True)
    label = shifted.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    ce = torch.log(torch.exp(shifted).sum(-1)) - label
    mask = (targets >= 0).to(logits.dtype)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_params(rng: np.random.Generator, stages: int, chunks: int,
                seq_len: int, d_model: int, hetero: bool) -> Any:
    """The JAX example's draws, in its order, as numpy f32: the stacked
    tree (``stage`` leaves ``[S, ...]``, or ``[S, V, ...]`` with
    ``chunks > 1``, chunk ``k`` of stage ``d`` block ``k * S + d``), or
    with ``hetero`` the list of per-stage trees."""
    S, T, D = stages, seq_len, d_model

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def init_block():
        return {"wqkv": w(D, 3 * D), "wo": w(D, D),
                "w1": w(D, 4 * D), "w2": w(4 * D, D)}

    if hetero:
        return ([{"embed": w(VOCAB, D), "pos": w(T, D)}]
                + [init_block() for _ in range(S - 2)]
                + [{"head": w(D, VOCAB)}])
    blocks = [init_block() for _ in range(S * chunks)]
    stage = {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}
    if chunks > 1:
        stage = {k: np.moveaxis(v.reshape((chunks, S) + v.shape[1:]), 1, 0)
                 for k, v in stage.items()}
    return {"embed": w(VOCAB, D), "pos": w(T, D), "head": w(D, VOCAB),
            "stage": stage}


def params_from_jax(tree, device=None):
    """The JAX example's parameters as the port's: the stacked ``[S,
    ...]`` / ``[S, V, ...]`` tree, or the packed ``[S, P_max]`` buffer of
    ``--hetero``, each leaf a tensor on ``device`` (the layouts are the
    same)."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    if isinstance(tree, dict):
        return tree_map(leaf, tree)
    return leaf(tree)


def train(stages: int = 4, micro: int = 8, seq_len: int = 32,
          d_model: int = 32, heads: int = 2, steps: int = 100, lag: int = 4,
          lr: float = 3e-3, remat: bool = False, interleaved: int = 1,
          hetero: bool = False, seed: int = 0, device=None) -> List[float]:
    """The example's loop; returns each step's loss."""
    dev = resolve_device(device)
    S, M, T, D, H, V = stages, micro, seq_len, d_model, heads, interleaved
    B = BATCH
    rng = np.random.default_rng(seed)
    init = init_params(rng, S, V, T, D, hetero)

    def batch():
        seq = rng.integers(0, VOCAB, size=(M, B, T))
        tgt = np.full((M, B, T), -1, np.int64)
        tgt[..., lag:] = seq[..., :-lag]
        return (torch.from_numpy(seq).to(dev),
                torch.from_numpy(tgt).to(dev))

    def block1(p, x):                   # one stage's block, unstacked
        return block_fn({k: v[None] for k, v in p.items()}, x[None], H)[0]

    if hetero:
        stacked, unpacks = pack_stage_params(
            [{k: torch.from_numpy(v) for k, v in t.items()} for t in init])
        stacked = stacked.to(dev).requires_grad_()
        fns = ([lambda p, t: p["embed"][t] + p["pos"][None]]
               + [block1] * (S - 2)
               + [lambda p, x: ln(x) @ p["head"]])
        shapes = [(B, T, D)] * (S - 1) + [(B, T, VOCAB)]
        leaves = [stacked]

        def loss_fn(tokens, targets):
            out = pipeline_apply_stages(fns, unpacks, stacked, tokens,
                                        boundary_shapes=shapes, remat=remat)
            return masked_ce(out, targets)
        tag = f"(embed|{S - 2} blocks|head in-pipe)"
    else:
        params = tree_map(lambda a: a.requires_grad_(),
                          params_from_jax(init, dev))
        leaves = tree_flatten(params)[0]

        def loss_fn(tokens, targets):
            emb = params["embed"][tokens] + params["pos"][None, None]
            if V > 1:
                out = pipeline_interleaved_apply(
                    lambda p, x: block_fn(p, x, H), params["stage"], emb,
                    remat=remat)
            else:
                out = pipeline_apply(lambda p, x: block_fn(p, x, H),
                                     params["stage"], emb, remat=remat)
            # one copy of embed / pos: their gradient is stage 0's alone,
            # so the JAX example's psum over the stage axis has no
            # counterpart here; the head reads the last stage's outputs
            return masked_ce(ln(out) @ params["head"], targets)
        tag = (f"({S} stages x {M} microbatches"
               f"{f' x {V} chunks' if V > 1 else ''})")

    opt = bfopt.adam(lr)(leaves)
    losses = []
    for it in range(steps):
        tokens, targets = batch()
        loss = loss_fn(tokens, targets)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % 20 == 0 or it == steps - 1:
            print(f"step {it}: loss {losses[-1]:.4f} {tag}")
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stages", type=int, default=4)
    parser.add_argument("--micro", type=int, default=8,
                        help="microbatches per step (pipeline occupancy)")
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lag", type=int, default=4,
                        help="copy-task distance, >= 1")
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--remat", action="store_true",
                        help="recompute stage forwards in the backward")
    parser.add_argument("--interleaved", type=int, default=1, metavar="V",
                        help="virtual chunks per device (V>1: Megatron-style "
                             "interleaved ring schedule, ~V-fold smaller "
                             "bubble; requires --micro <= --stages)")
    parser.add_argument("--hetero", action="store_true",
                        help="heterogeneous stages: embed and head live "
                             "INSIDE the pipeline (stage 0 / stage S-1) "
                             "via pipeline_apply_stages, instead of being "
                             "replicated on every device")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    if args.lag < 1:
        parser.error("--lag must be >= 1 (predicting the current token "
                     "would be trivial)")
    if args.d_model % args.heads:
        parser.error(f"--d-model {args.d_model} must be divisible by "
                     f"--heads {args.heads}")
    if args.interleaved > 1 and args.micro > args.stages:
        parser.error("interleaved schedule needs --micro <= --stages "
                     "(stream bigger batches in groups of S)")
    if args.hetero and args.interleaved > 1:
        parser.error("--hetero and --interleaved are separate schedules")
    if args.hetero and args.stages < 3:
        parser.error("--hetero needs >= 3 stages (embed + blocks + head)")
    losses = train(args.stages, args.micro, args.seq_len, args.d_model,
                   args.heads, args.steps, args.lag, args.lr, args.remat,
                   args.interleaved, args.hetero, args.seed, args.device)
    assert losses[-1] < losses[0], "no training progress through stages"
    S, M, V = args.stages, args.micro, args.interleaved
    if args.hetero:
        print(f"[pipeline/hetero] loss {losses[0]:.3f} -> {losses[-1]:.3f}: "
              f"embed + {S - 2} blocks + head as {S} heterogeneous stages")
    else:
        print(f"[pipeline] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{S} stages ({M} microbatches/step"
              f"{f', interleaved V={V}' if V > 1 else ''}"
              f"{', remat' if args.remat else ''})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
