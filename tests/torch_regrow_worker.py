"""A mesh regrowth across gloo processes on the CPU: one worker of
``bfrun-torch``, run by path from ``tests/test_torch_regrow_processes.py``.

Each process forms the world from torchrun's variables with ``--rows``
stacked ranks, takes ``--steps`` gossip steps on a float64 ``[n, 16]``
tensor drawn from seed 7 (each process its block), regrows the world,
takes one step on the new world, commits, and saves its block (with its
first rank) to ``--out``.  Two ways to grow:

* ``--mode rows``: the processes stay, each holds more rows
  (``regrow_world(processes * new_rows)``): the survivors' rows move
  between processes through the carry's gather;
* ``--mode processes``: a process joins (``bfrun-torch --elastic``): the
  survivors' process 0 writes the scale file, the supervisor publishes
  the re-formed group's port in ``$BLUEFOG_PORT_FILE`` and starts the
  joiner (``BLUEFOG_JOIN_COUNT``), the survivors run ``regrow_world(...,
  processes=world + 1)`` and the joiner ``regrow_join``.

:func:`reference` runs the same steps in one process; the blocks joined
in process order equal it (``tests/test_torch_regrow_processes.py``
holds them).

Run: ``bfrun-torch -np 2 --elastic --scale-file S -- python
tests/torch_regrow_worker.py --mode processes --scale-file S --out OUT``
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bluefog_tpu_torch import api  # noqa: E402
from bluefog_tpu_torch import resilience as rz  # noqa: E402
from bluefog_tpu_torch.parallel import context as bf  # noqa: E402
from bluefog_tpu_torch.run.launcher import _write_scale  # noqa: E402

D = 16


def _start(n: int) -> np.ndarray:
    return np.random.default_rng(7).standard_normal((n, D))


def reference(rows: int, world: int, new_world: int, new_rows: int,
              steps: int = 2) -> np.ndarray:
    """The whole ``[new_world * new_rows, 16]`` result in one process."""
    n = rows * world
    bf.init(size=n, device="cpu")
    try:
        w = torch.tensor(_start(n))
        for _ in range(steps):
            w = api.neighbor_allreduce(w)
        out, handle = rz.regrow_world(new_world * new_rows, {"w": w})
        w = api.neighbor_allreduce(out["w"])
        handle.commit()
        return w.numpy()
    finally:
        bf.shutdown()
        rz.reset()


def run(args) -> None:
    torch.set_num_threads(1)
    world = int(os.environ["WORLD_SIZE"])
    joiner = bool(os.environ.get("BLUEFOG_JOIN_COUNT"))
    bf.init(size=world * args.rows, device="cpu")
    ctx = bf.get_context()
    if joiner:
        old_n = (world - 1) * args.rows
        state = rz.regrow_join({"w": torch.zeros(args.rows, D,
                                                 dtype=torch.float64)},
                               world_before=old_n)
        w = state["w"]
    else:
        n = ctx.size
        w = torch.tensor(_start(n)[ctx.first_rank:ctx.first_rank + ctx.rows])
        for _ in range(args.steps):
            w = api.neighbor_allreduce(w)
        if args.mode == "processes":
            if ctx.process == 0:
                _write_scale(args.scale_file, world + 1)
            target, procs = (world + 1) * args.rows, world + 1
        else:
            target, procs = world * args.new_rows, world
        out, handle = rz.regrow_world(target, {"w": w}, processes=procs)
        w = out["w"]
    w = api.neighbor_allreduce(w)
    rz.commit_regrow()
    ctx = bf.get_context()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / f"block{ctx.process}.npy", w.numpy())
    (out_dir / f"block{ctx.process}.txt").write_text(
        f"{ctx.first_rank} {ctx.size} {ctx.world}")
    bf.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("rows", "processes"),
                    required=True)
    ap.add_argument("--rows", type=int, default=2,
                    help="ranks a process before the regrowth")
    ap.add_argument("--new-rows", type=int, default=3,
                    help="--mode rows: ranks a process after it")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--scale-file", default=None,
                    help="--mode processes: the supervisor's scale file")
    ap.add_argument("--out", required=True)
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
