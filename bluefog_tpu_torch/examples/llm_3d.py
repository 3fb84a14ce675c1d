"""Decentralized LLM: gossip-DP x PP x TP x Ulysses (x expert) on one card
(counterpart of ``examples/llm_3d.py``).

One call to :func:`~bluefog_tpu_torch.parallel.compose.compose_parallelism`
carves the peers into the five axes and validates the carving eagerly;
every peer is stacked on dim 0 of one device in the JAX flat order, and
the composed transformer trains through the step machinery
(``adapt_with_combine(delayed=True)`` gossip over the ``dp`` replicas,
through ``--wire`` when given):

* ``dp``: gossip data parallelism over the replicas;
* ``pp``: the block stack pipelined by the GPipe schedule;
* ``tp``: Megatron tensor parallelism inside every block;
* ``sp``: Ulysses sequence parallelism around K1/K2 (the flash kernels on
  the card; the plain online-softmax path on the CPU, as JAX's default);
* ``ep`` (``--ep``, with ``--experts`` / ``--capacity-factor``): the
  routed-MoE LM instead of the dense one, ``num_experts // ep`` experts a
  peer.  As in JAX it builds ``MoELMConfig`` with its defaults, so its
  experts run capacity dispatch (``torch.matmul``, no K4).

A copy-task LM (predict the token ``lag`` positions back) must reach 0.7
of its first loss.

Run:    python -m bluefog_tpu_torch.examples.llm_3d [--steps 60]
        python -m bluefog_tpu_torch.examples.llm_3d --sp 2 --tp 1 \\
            --wire fp8@64
        python -m bluefog_tpu_torch.examples.llm_3d --tp 1 --ep 2 \\
            --experts 4 --steps 40
Smoke:  add ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from bluefog_tpu_torch import optimizers as bfopt
from bluefog_tpu_torch.parallel import compose


def _parse(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dp", type=int, default=2)
    parser.add_argument("--pp", "--stages", type=int, default=2, dest="pp")
    parser.add_argument("--tp", type=int, default=2)
    parser.add_argument("--sp", type=int, default=1,
                        help="Ulysses sequence-parallel ways")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel ways (routed MoE when > 1 "
                             "or when --experts is given)")
    parser.add_argument("--experts", type=int, default=None,
                        help="total routed experts (enables the MoE LM)")
    parser.add_argument("--capacity-factor", type=float, default=2.0,
                        help="expert capacity factor for the MoE LM")
    parser.add_argument("--wire", default=None,
                        help="gossip codec (bf16 / fp8@64 / ...)")
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--micro", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lag", type=int, default=2)
    parser.add_argument("--lr", type=float, default=5e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="default: the card (cuda)")
    return parser.parse_args(argv)


def train(args) -> Tuple[List[float], compose.Mesh3D]:
    """The example's carving and loop; returns each step's loss (the mean
    over every peer) and the carving."""
    moe = args.experts is not None or args.ep > 1
    carve_kw, cfg = {}, None
    if moe:
        from bluefog_tpu_torch.moe import model as bfmoe
        num_experts = args.experts or 4
        cfg = bfmoe.MoELMConfig(
            d_model=args.d_model, heads=args.heads, layers=args.layers,
            seq_len=args.seq_len, micro=args.micro, lag=args.lag,
            batch=max(2, args.ep), num_experts=num_experts,
            capacity_factor=args.capacity_factor)
        carve_kw = {"num_experts": num_experts,
                    "capacity_factor": args.capacity_factor}
    m = compose.compose_parallelism(
        args.dp, args.pp, args.tp, args.sp, args.ep, device=args.device,
        wire=args.wire, **carve_kw)
    if not moe:
        cfg = compose.LMConfig(
            d_model=args.d_model, heads=args.heads, layers=args.layers,
            seq_len=args.seq_len, micro=args.micro, lag=args.lag)
    cfg.validate(m)
    print(f"[llm_3d] carving {m.describe()}")
    if moe:
        grad_fn = bfmoe.make_moe_grad_fn(cfg, m)
        params = bfmoe.init_moe_train_params(cfg, m, seed=args.seed)
        toks = bfmoe.make_moe_batch(cfg, m, seed=args.seed)
    else:
        grad_fn = compose.make_lm_grad_fn(cfg, m)
        params = compose.init_lm_train_params(cfg, m, seed=args.seed)
        toks = compose.make_lm_batch(cfg, m, seed=args.seed)
    step, strategy = compose.make_train_step(m, grad_fn,
                                             bfopt.adam(args.lr))
    state = bfopt.init_distributed(strategy, params)
    losses = []
    for i in range(args.steps):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss.mean()))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {losses[-1]:.4f}")
    return losses, m


def main(argv=None) -> int:
    args = _parse(argv)
    losses, m = train(args)
    moe = args.experts is not None or args.ep > 1
    first, last = losses[0], losses[-1]
    print(f"[llm_3d] mesh dp={m.dp} x pp={m.pp} x tp={m.tp} x sp={m.sp}"
          f" x ep={m.ep}"
          + (f" (E={m.num_experts} cf={m.capacity_factor})" if moe else "")
          + f" (wire={m.wire}): loss {first:.3f} -> {last:.3f}")
    assert last < first * 0.7, "composed LM failed to train"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
