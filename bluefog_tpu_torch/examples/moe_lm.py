"""Long-context MoE LM: ring-SP attention x expert-parallel FFN over one
rank axis (counterpart of ``examples/moe_lm.py``).

The ``RANKS`` ranks (8, the JAX example's virtual devices) are stacked
on dim 0 of one device.  The sequence is sharded over them (each holds
``T / n`` tokens, and the K/V blocks go round the ring by
:func:`~bluefog_tpu_torch.ops.ring.ring_attention`: K1/K2 on the card,
the head dim 16 padded to 64 by their wrappers), and each rank also owns
one expert FFN: every token, wherever it lies in the sequence, goes to
its expert's rank and back by the stacked ``all_to_all`` pair of
:func:`~bluefog_tpu_torch.parallel.expert.moe_apply`.  Gradients as in
JAX: the replicated groups (embed, attention, router, head) get the sum
over the ranks of their losses' gradients (the example's psum over the
ring; in JAX that gradient arrives already summed over the ring, so the
psum counts it n times, a scale Adam does not see), the experts their
own (every rank's tokens that reached them); the reported loss is the
ranks' mean.  A copy-task LM (predict the token ``lag``
back) must train to a lower loss.

The numpy draws (weights, then each step's sequence) are the JAX
example's own, in its order; Adam is optax's.

Run:    python -m bluefog_tpu_torch.examples.moe_lm
Smoke:  python -m bluefog_tpu_torch.examples.moe_lm --device cpu
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch.device import resolve_device
from bluefog_tpu_torch.ops.ring import ring_attention
from bluefog_tpu_torch.parallel.compose import _ln
from bluefog_tpu_torch.parallel.expert import load_balancing_loss, moe_apply

RANKS = 8


def train(seq_len: int = 64, d_model: int = 32, heads: int = 2,
          ffn_hidden: int = 64, steps: int = 80, lag: int = 2,
          lr: float = 3e-3, balance_alpha: float = 0.01, seed: int = 0,
          device=None) -> List[float]:
    """The example's loop; returns each step's loss (the mean over the
    ranks, as JAX's ``pmean``)."""
    dev = resolve_device(device)
    n, T, D, H, Hid = RANKS, seq_len, d_model, heads, ffn_hidden
    B, vocab = 2, 32
    assert T % n == 0, "seq_len must divide the rank count"
    local_T, hsz = T // n, D // H
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev).requires_grad_()

    p = {"embed": w(vocab, D), "wqkv": w(D, 3 * D), "wo": w(D, D),
         "router": w(D, n, scale=0.05),
         "e_w1": w(n, D, Hid), "e_w2": w(n, Hid, D),   # rank r owns [r]
         "head": w(D, vocab)}
    opt = bfopt.adam(lr)(list(p.values()))
    positions = torch.arange(T, device=dev, dtype=torch.float32).view(
        n, 1, local_T, 1)
    rows = torch.arange(B * local_T, device=dev)

    def expert_fn(wz, toks):                  # every owner's [n, rows, D]
        w1, w2 = wz
        return torch.matmul(torch.relu(torch.matmul(toks, w1)), w2)

    def rank_losses(tokens, targets):         # [n, B, local_T] each
        x = p["embed"][tokens] + 0.02 * positions
        q, k, v = (t.reshape(n, B, local_T, H, hsz) for t in
                   (_ln(x) @ p["wqkv"]).chunk(3, dim=-1))
        att = ring_attention(q, k, v, causal=True)
        x = x + att.reshape(n, B, local_T, D) @ p["wo"]
        h = _ln(x).reshape(n, B * local_T, D)
        logits = h @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        idx = torch.argmax(logits, dim=-1)
        gate = probs[:, rows].gather(-1, idx[..., None])
        out = moe_apply(h, idx, expert_fn, (p["e_w1"], p["e_w2"]),
                        capacity=B * local_T, axis_size=n, num_experts=n)
        x = x + (out * gate).reshape(n, B, local_T, D)
        out_logits = _ln(x) @ p["head"]
        mask = (targets >= 0).to(torch.float32)
        ce = F.cross_entropy(out_logits.reshape(-1, vocab),
                             targets.clamp(min=0).reshape(-1).long(),
                             reduction="none").view(mask.shape)
        task = (ce * mask).sum((1, 2)) / mask.sum((1, 2)).clamp(min=1.0)
        aux = torch.stack([load_balancing_loss(probs[r], idx[r])
                           for r in range(n)])
        return task + balance_alpha * aux

    losses = []
    for it in range(steps):
        seq = rng.integers(0, vocab, size=(B, T))
        tgt = np.full((B, T), -1, np.int64)
        tgt[:, lag:] = seq[:, :-lag]

        def shard(a):                         # [B, T] -> [n, B, local_T]
            return torch.from_numpy(np.ascontiguousarray(
                a.reshape(B, n, local_T).transpose(1, 0, 2))).to(dev)

        per_rank = rank_losses(shard(seq), shard(tgt))
        opt.zero_grad()
        per_rank.sum().backward()
        opt.step()
        losses.append(float(per_rank.detach().mean()))
        if it % 20 == 0 or it == steps - 1:
            print(f"step {it}: loss {losses[-1]:.4f} "
                  f"({n} seq shards x {n} experts)")
    return losses


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--ffn-hidden", type=int, default=64)
    parser.add_argument("--steps", type=int, default=80)
    parser.add_argument("--lag", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--balance-alpha", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    losses = train(args.seq_len, args.d_model, args.heads, args.ffn_hidden,
                   args.steps, args.lag, args.lr, args.balance_alpha,
                   args.seed, args.device)
    assert losses[-1] < losses[0], "no training progress"
    print(f"[moe_lm] ring-SP x expert-parallel: loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f} over {RANKS} ranks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
