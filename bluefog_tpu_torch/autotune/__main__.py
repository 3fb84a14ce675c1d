"""CLI for the autotuner: tune, emit the plan, optionally apply + train
(counterpart of ``python -m bluefog_tpu.autotune``).

``python -m bluefog_tpu_torch.autotune --device cpu --ranks 8 --smoke
--apply-steps 5`` tunes on a restricted space over 8 stacked ranks,
prints the plan as one JSON line, then applies it, builds the strategy
and train step it prescribes, runs N steps on a tiny model, and prints
the JAX tool's report fields beside the plan id.  On the card drop
``--device`` (the context's device is CUDA by default).
"""
import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.autotune")
    parser.add_argument("--device", default=None,
                        help="torch device of the stacked ranks (default "
                             "cuda; 'cpu' for the JAX tool's --virtual-cpu)")
    parser.add_argument("--ranks", type=int, default=8,
                        help="ranks stacked on the device (default 8)")
    parser.add_argument("--objective", default="step_time",
                        help="step_time | consensus_per_byte | JSON blend "
                             'dict like {"step_time": 1, '
                             '"consensus_per_byte": 0.5}')
    parser.add_argument("--trials", default="0",
                        help='0, an int K, or "auto" '
                             "(BLUEFOG_AUTOTUNE_TRIALS)")
    parser.add_argument("--smoke", action="store_true",
                        help="restrict the space to a fast representative "
                             "subset (the JAX tool's)")
    parser.add_argument("--out", default=None,
                        help="write the plan JSON to this path")
    parser.add_argument("--apply-steps", type=int, default=0,
                        help="after tuning: apply the plan, train N steps "
                             "on a tiny model and report.  The port "
                             "compiles no program and donates no buffer: "
                             "its step updates params and state in place "
                             "(in_place true, donated null), and "
                             "retraces_after_warmup is the port's counter "
                             "of that name, which nothing increments")
    args = parser.parse_args(argv)

    import torch

    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.api import hard_sync
    from bluefog_tpu_torch.autotune import autotune
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.utils import metrics as bfm

    bf.init(size=args.ranks, device=args.device)

    objective = args.objective
    if objective.lstrip().startswith("{"):
        objective = json.loads(objective)
    trials = args.trials if args.trials == "auto" else int(args.trials)

    space = {}
    if args.smoke:
        n = bf.size()
        space = {
            "algorithms": ("allreduce", "neighbor_cta", "neighbor_atc",
                           "push_diging"),
            "topologies": ({"family": "exp2", "size": n},
                           {"family": "ring", "size": n}),
            "wires": (None,),
            "fused_k": (1, 4),
        }

    plan = autotune(objective=objective, trials=trials, **space)
    print(plan.to_json(), flush=True)
    if args.out:
        plan.save(args.out)

    if args.apply_steps <= 0:
        bf.shutdown()
        return 0

    # apply + train: the plan must reconstruct a working configuration
    plan.apply()
    n = bf.size()
    dev = bf.get_context().device
    params = {"w": torch.ones((64, 16), device=dev),
              "b": torch.zeros((16,), device=dev)}

    def grad_fn(p, batch):
        x, y = batch
        w = p["w"].detach().requires_grad_()
        b = p["b"].detach().requires_grad_()
        loss = torch.mean((x @ w + b - y) ** 2)
        gw, gb = torch.autograd.grad(loss, (w, b))
        return loss.detach(), {"w": gw, "b": gb}

    strategy = plan.build_strategy(bfopt.sgd(0.01))
    step = bfopt.make_train_step(grad_fn, strategy,
                                 **plan.train_step_kwargs())
    dist_params = bfopt.replicate(params, n)
    dist_state = bfopt.init_distributed(strategy, dist_params)
    batch = (torch.ones((n, 8, 64), device=dev),
             torch.zeros((n, 8, 16), device=dev))
    loss = None
    for _ in range(args.apply_steps):
        dist_params, dist_state, loss = step(dist_params, dist_state, batch)
    hard_sync(loss)
    retraces = int(bfm.counter(
        "bluefog_retrace_after_warmup_total").total())
    finite = bool(torch.isfinite(loss).all())
    report = {
        "applied": True,
        "plan_id": plan.plan_id,
        "algorithm": plan.algorithm,
        "steps": args.apply_steps,
        "loss_finite": finite,
        "donated": None,
        "in_place": True,
        "retraces_after_warmup": retraces,
        "ok": finite and retraces == 0,
    }
    print(json.dumps(report, sort_keys=True), flush=True)
    bf.shutdown()
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
