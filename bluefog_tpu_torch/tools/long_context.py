"""Long-context LM training over stacked sequence ranks (counterpart of
``examples/long_context.py``).

The sequence is split over ``--ranks`` sequence ranks (the JAX example's
mesh; 8 by default, as its virtual CPU mesh), stacked on dim 0 of one
device, and exact causal attention runs by the ring (contiguous or
zigzag layout) or by Ulysses.  A copy-task LM (predict the token
``--lag`` positions back) trains with Adam and the loss must fall.  As in
the JAX example: vocab 32, 2 layers, 2 heads (one per rank with
Ulysses), float32; with ``--sp-layout zigzag`` tokens and targets are
permuted by ``zigzag_order`` and positions come from
``zigzag_positions``.  The step sums the per-rank losses' gradients (the
JAX ``psum`` over the ring) and reports their mean.

Run:    python -m bluefog_tpu_torch.tools.long_context [--sp-layout zigzag
        --rope --use-pallas]   (on the card: attention through K1/K2)
Smoke:  python -m bluefog_tpu_torch.tools.long_context --device cpu
        --steps 10
"""
from __future__ import annotations

import argparse
from typing import Callable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import RingTransformerLM, lm_loss
from ..ops.ring import zigzag_order, zigzag_positions

VOCAB = 32


def copy_batch(rng: np.random.Generator, T: int, lag: int, vocab: int,
               order: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One copy-task sequence ``[1, T]`` and its targets (the token ``lag``
    positions back, ``-1`` before it), both permuted by ``order``: the
    JAX example's draw."""
    seq = rng.integers(0, vocab, size=(1, T))
    targets = np.full((1, T), -1, np.int64)
    targets[:, lag:] = seq[:, :-lag]
    return seq[:, order], targets[:, order]


def stack_ranks(x: np.ndarray, n: int, device) -> torch.Tensor:
    """``[B, T]`` -> ``[n, B, T/n]``: rank i holds block i."""
    B, T = x.shape
    return torch.as_tensor(np.ascontiguousarray(
        x.reshape(B, n, T // n).transpose(1, 0, 2))).to(device)


def rank_positions(n: int, local_T: int, zigzag: bool,
                   device) -> torch.Tensor:
    """Every rank's global positions ``[n, T/n]``."""
    ranks = torch.arange(n)
    if zigzag:
        pos = zigzag_positions(ranks, n, local_T // 2)
    else:
        pos = ranks[:, None] * local_T + torch.arange(local_T)
    return pos.to(torch.int32).to(device)


def make_step(model: RingTransformerLM, opt: torch.optim.Optimizer,
              positions: torch.Tensor
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``step(tokens [n, B, T/n], targets) -> loss``: one Adam step on the
    sum over ranks of each rank's masked-mean loss (JAX: ``psum`` of the
    replicated params' grads), returning the mean over ranks (JAX:
    ``pmean`` of the loss)."""
    def step(tokens, targets):
        opt.zero_grad(set_to_none=True)
        per_rank = lm_loss(model(tokens, positions=positions), targets)
        per_rank.sum().backward()
        opt.step()
        return per_rank.detach().mean()
    return step


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq-len", type=int, default=256,
                    help="global sequence length (split over the ranks)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lag", type=int, default=8,
                    help="copy-task distance (crosses ranks when > "
                         "seq_len / ranks)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp-mode", default="ring", choices=["ring", "ulysses"],
                    help="K/V ring rotation or all-to-all head scatter "
                         "(needs heads %% ranks == 0)")
    ap.add_argument("--sp-layout", default="contiguous",
                    choices=["contiguous", "zigzag"],
                    help="zigzag: balanced causal ring (striped)")
    ap.add_argument("--rope", action="store_true",
                    help="rotary positions instead of learned absolute")
    ap.add_argument("--use-pallas", action="store_true",
                    help="on the CPU, attention through the K1/K2 plain "
                         "versions (on CUDA it always runs the kernels)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="sequence ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = _parse(argv)
    dev = resolve_device(args.device)
    n, T = args.ranks, args.seq_len
    if T % n:
        raise SystemExit("seq-len must divide the rank count")
    local_T = T // n
    if args.sp_mode == "ulysses" and args.d_model % n:
        raise SystemExit(
            f"--sp-mode ulysses needs --d-model divisible by the rank "
            f"count ({n}); got {args.d_model}")
    heads = n if args.sp_mode == "ulysses" else 2
    zigzag = args.sp_layout == "zigzag"
    if zigzag and args.sp_mode != "ring":
        raise SystemExit("--sp-layout zigzag goes with --sp-mode ring")
    if zigzag and local_T % 2:
        raise SystemExit("zigzag needs an even per-rank block")
    model = RingTransformerLM(
        vocab_size=VOCAB, num_layers=2, num_heads=heads,
        d_model=args.d_model, max_seq_len=T, axis="rank",
        dtype=torch.float32, sp_mode=args.sp_mode,
        sp_layout=args.sp_layout, rope=args.rope,
        use_pallas=args.use_pallas).reset_parameters(args.seed).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_step(model, opt, rank_positions(n, local_T, zigzag, dev))
    rng = np.random.default_rng(args.seed)
    order = zigzag_order(n, T) if zigzag else np.arange(T)
    losses = []
    for it in range(args.steps):
        seq, targets = copy_batch(rng, T, args.lag, VOCAB, order)
        loss = step(stack_ranks(seq, n, dev), stack_ranks(targets, n, dev))
        losses.append(float(loss))
        if it % 10 == 0 or it == args.steps - 1:
            print(f"step {it}: loss {losses[-1]:.4f} "
                  f"(seq {T} over {n} ranks, {local_T}/rank)")
    assert losses[-1] < losses[0], "no training progress through the ring"
    tag = "/zigzag" if zigzag else ""
    print(f"[{args.sp_mode}-SP{tag}] loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} on {T}-token context split {n} ways")
    return {"losses": losses, "device": str(dev)}


if __name__ == "__main__":
    main()
