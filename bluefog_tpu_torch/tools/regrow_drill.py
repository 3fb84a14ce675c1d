"""Mesh-regrowth drill: grow a live world by K ranks, no files (the port
of ``tools/regrow_drill.py``).

Forms a gossip world of ``--world`` stacked ranks, trains it a couple of
neighbor-averaging steps, then drives the full
:func:`bluefog_tpu_torch.resilience.regrow_world` protocol to ``--target``
ranks — quiesce, coordinator handshake, host snapshot, world re-init,
state carry, joiner neighbor-pull — takes one step on the NEW world, and
only then commits (releasing the old world).  With ``--chaos`` the same
drill proves the abort path instead: the injected
``kill_coordinator``/``kill_joiner``/``hang_reinit`` fault must roll the
process back to the OLD world, which then demonstrates it can still
step.

Writes a flight bundle into ``--flight-dir`` (the ``regrow`` block +
event timeline ``tools/postmortem.py`` surfaces in its verdict) and
prints a one-line JSON artifact on stdout (last line)::

    {"schema": "bluefog-regrow-drill-1", "ok": true, "world_before": 4,
     "world_after": 6, "committed": true, "aborted": false, ...}

The JAX drill's ``retraces_after_warmup`` has no counterpart (the port
compiles no programs); the line counts the kernel builds and library loads
of the regrowth instead (``ops/_build.py``), which must be 0.

Run:   python -m bluefog_tpu_torch.tools.regrow_drill --world 4 --target 6 \
           --flight-dir /tmp/regrow_flight
Abort: python -m bluefog_tpu_torch.tools.regrow_drill --world 4 --target 6 \
           --chaos "kill_coordinator:step=1" --flight-dir /tmp/rg
(``--device cpu`` runs it without a card.)
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SCHEMA = "bluefog-regrow-drill-1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual-cpu", type=int, default=8,
                    help="the rank pool the world may grow into (must "
                         "cover --target; the JAX drill's virtual CPU "
                         "device count)")
    ap.add_argument("--world", type=int, default=4,
                    help="initial world size")
    ap.add_argument("--target", type=int, default=6,
                    help="regrown world size")
    ap.add_argument("--steps", type=int, default=2,
                    help="gossip steps before the regrowth")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="joiner entry-scale ramp ticks")
    ap.add_argument("--chaos", default=None,
                    help="fault plan (e.g. 'kill_coordinator:step=1') — "
                         "drills the abort/rollback path instead")
    ap.add_argument("--flight-dir", default=None,
                    help="flight bundle directory for the postmortem")
    ap.add_argument("--device", default=None,
                    help="where the ranks live (default: CUDA)")
    return ap.parse_args(argv)


def run(args) -> dict:
    if args.virtual_cpu < args.target:
        raise SystemExit(
            f"--virtual-cpu {args.virtual_cpu} cannot host "
            f"--target {args.target}")
    if args.flight_dir:
        os.environ["BLUEFOG_FLIGHT_DIR"] = args.flight_dir
    import numpy as np
    import torch

    from .. import api
    from .. import resilience as rz
    from ..ops import _build
    from ..parallel import context as bf
    from ..utils import chaos as bfchaos
    from ..utils import flight as bfflight

    bf.init(size=args.world, device=args.device)
    dev = bf.get_context().device
    rng = np.random.default_rng(7)
    w = torch.tensor(rng.standard_normal((args.world, 16)).astype(
        np.float32), device=dev)
    params = {"w": w}
    for _ in range(args.steps):
        params = {"w": api.neighbor_allreduce(params["w"])}
    pre = params["w"].cpu().numpy()

    doc = {"schema": SCHEMA, "ok": False, "world_before": args.world,
           "world_after": None, "target": args.target,
           "committed": False, "aborted": False, "chaos": args.chaos}
    if args.chaos:
        bfchaos.install(args.chaos)
    b0 = _build.build_counts()
    try:
        new_params, handle = rz.regrow_world(
            args.target, params, warmup_steps=args.warmup_steps)
    except rz.RegrowAborted as e:
        doc["aborted"] = True
        doc["abort_phase"] = e.phase
        doc["abort_rank"] = e.rank
        doc["world_after"] = bf.get_context().size
        # the rollback contract: the OLD world must still step
        api.neighbor_allreduce(params["w"]).cpu()
        doc["old_world_steps_after_abort"] = True
        doc["ok"] = bool(doc["world_after"] == args.world
                         and not rz.regrow_pending())
    else:
        # survivors' rows crossed the world boundary losslessly
        keep = min(args.world, args.target)
        carried = new_params["w"][:keep].cpu().numpy()
        lossless = bool(np.array_equal(carried, pre[:keep]))
        api.neighbor_allreduce(new_params["w"]).cpu()
        b1 = _build.build_counts()
        doc["committed"] = handle.commit()
        doc["world_after"] = bf.get_context().size
        doc["coordinator"] = handle.coordinator
        doc["joiners"] = list(handle.joiners)
        doc["duration_s"] = round(handle.duration_s, 6)
        doc["carry_lossless"] = lossless
        doc["kernel_builds_during_regrow"] = b1["builds"] - b0["builds"]
        doc["kernel_loads_during_regrow"] = b1["loads"] - b0["loads"]
        doc["ok"] = bool(doc["world_after"] == args.target
                         and doc["committed"] and lossless
                         and not rz.regrow_pending()
                         and b1 == b0)
    finally:
        if args.chaos:
            bfchaos.uninstall()
    if args.flight_dir:
        doc["flight_bundle"] = bfflight.dump(reason="regrow_drill")
    bf.shutdown()
    return doc


def main(argv=None) -> int:
    doc = run(parse(argv))
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
