"""Preemptible-fleet goodput bench: replay a spot trace, grade the
recovery (the port of ``tools/preempt_bench.py``, schema
``bluefog-preempt-bench-1``).

Forms a gossip fleet of stacked ranks, replays a preemption trace
(``bluefog-preempt-trace-1``, see ``preempt_trace``) through the real
in-process machinery — the chaos ``preempt`` fault fires through
``on_train_step``, the shrink and the re-grant regrowth run the full
:func:`bluefog_tpu_torch.resilience.regrow_world` protocol — and grades:

* **goodput fraction** — useful rank-steps achieved vs the ideal
  never-preempted fleet over the same step count (outage windows run at
  reduced width, scaled by each event's re-grant delay);
* **optimizer-progress continuity** — params are float64 and every
  preempt→regrow cycle checks that the survivors' rows cross the world
  boundary bit-identical (zero lost optimizer progress);
* **regrowth latency, cold vs warm** — the first cycle is the cold one,
  later cycles re-enter previously-seen world sizes;
* **the build-counter invariant** — where the JAX bench counts fresh XLA
  compiles of a regrow, this one counts the port's kernel builds and
  library loads (``ops/_build.py``) over each shrink and regrow cycle and
  its steps: they must be 0 once the first build is done.

The JAX line's ``exec_cache`` block is left out: it reports the pool of
compiled XLA executables a world shape that the JAX regrowth re-enters,
and the port compiles no program for a world (its kernels are keyed by
their sources), so there is no pool to report.

Prints a one-line JSON artifact on stdout (last line) and exits non-zero
when any gate fails.  With ``--flight-dir`` the run dumps a flight bundle
whose ``preempt`` chaos events ``tools/postmortem.py`` blames as
"preempted" (zone, grace, victims) rather than "killed".

Run::

    python -m bluefog_tpu_torch.tools.preempt_trace --pattern mass \\
        --world 4 --zones 2 --duration 8 --regrant 3 --out /tmp/mass.json
    python -m bluefog_tpu_torch.tools.preempt_bench --trace /tmp/mass.json \\
        --virtual-cpu 4 --flight-dir /tmp/preempt_flight

(``--device cpu`` runs it without a card.)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SCHEMA = "bluefog-preempt-bench-1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True,
                    help="bluefog-preempt-trace-1 JSON file to replay")
    ap.add_argument("--virtual-cpu", type=int, default=8,
                    help="the rank pool the fleet may use (must cover the "
                         "world; the JAX bench's virtual CPU device count)")
    ap.add_argument("--world", type=int, default=None,
                    help="fleet size (default: the trace's world)")
    ap.add_argument("--steps-per-phase", type=int, default=2,
                    help="gossip steps between trace phases")
    ap.add_argument("--steps-per-second", type=float, default=1.0,
                    help="how many outage steps one re-grant second costs")
    ap.add_argument("--goodput-floor", type=float, default=0.5,
                    help="fail the run below this goodput fraction")
    ap.add_argument("--flight-dir", default=None,
                    help="flight bundle directory for the postmortem")
    ap.add_argument("--device", default=None,
                    help="where the ranks live (default: CUDA)")
    return ap.parse_args(argv)


def run(args) -> dict:
    from ..run.launcher import _load_preempt_trace
    trace = _load_preempt_trace(args.trace)
    world = int(args.world or trace.get("world") or 4)
    if not trace["events"]:
        raise SystemExit(f"--trace {args.trace}: no events to replay")
    if args.virtual_cpu < world:
        raise SystemExit(f"--virtual-cpu {args.virtual_cpu} cannot host "
                         f"world {world}")
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
    from ..utils import metrics as bfm

    bf.init(size=world, device=args.device)
    dev = bf.get_context().device
    rng = np.random.default_rng(11)
    params = {"w": torch.tensor(rng.standard_normal((world, 16)),
                                dtype=torch.float64, device=dev)}
    state = {"tick": 0, "achieved": 0, "ideal": 0}

    def fresh():
        c = _build.build_counts()
        return c["builds"] + c["loads"]

    def run_steps(k):
        for _ in range(k):
            params["w"] = api.neighbor_allreduce(params["w"])
            state["tick"] += 1
            state["achieved"] += bf.get_context().size
            state["ideal"] += world
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def regrow(target):
        t0 = time.perf_counter()
        new_params, handle = rz.regrow_world(target, params)
        dt = time.perf_counter() - t0
        handle.commit()
        return new_params, dt

    def one_cycle(ev, label):
        """Preempt -> shrink -> outage -> re-grant regrowth; returns the
        per-cycle record."""
        run_steps(args.steps_per_phase)
        size_before = bf.get_context().size
        # fire the fault through the real chaos path so the flight bundle
        # carries the preempt event postmortem blames
        if ev["zone"] is not None:
            plan = (f"zones={trace['zones']};preempt:step={state['tick']+1},"
                    f"zone={ev['zone']},grace={ev['grace']},"
                    f"regrant={ev['regrant']}")
        else:
            plan = (f"preempt:step={state['tick']+1},rank={ev['victims'][0]},"
                    f"grace={ev['grace']},regrant={ev['regrant']}")
        bfchaos.install(plan)
        victims = ()
        try:
            bfchaos.on_train_step(state["tick"] + 1)
            raise SystemExit(f"preempt fault at tick {state['tick']+1} "
                             "did not fire")
        except bfchaos.RankPreempted as e:
            victims = tuple(r for r in e.ranks if r < size_before)
        finally:
            bfchaos.uninstall()
        state["tick"] += 1                    # the reclaimed step: no progress

        target = max(1, size_before - len(victims))
        pre = params["w"].cpu().numpy()
        f_shrink0 = fresh()
        new_params, shrink_s = regrow(target)
        carried = new_params["w"][:target].cpu().numpy()
        shrink_lossless = bool(np.array_equal(carried, pre[:target]))
        params.update(new_params)
        shrink_builds = fresh() - f_shrink0

        # the outage window: reduced capacity until the re-grant lands
        outage = max(1, int(round(ev["regrant"] * args.steps_per_second)))
        run_steps(outage)

        # re-grant: regrow back to the full fleet (a previously-seen size)
        pre2 = params["w"].cpu().numpy()
        f0 = fresh()
        new_params, regrow_s = regrow(world)
        carried2 = new_params["w"][:target].cpu().numpy()
        regrow_lossless = bool(np.array_equal(carried2, pre2[:target]))
        params.update(new_params)
        run_steps(args.steps_per_phase)       # steps on the regrown world
        return {
            "label": label, "zone": ev["zone"], "victims": list(victims),
            "grace": ev["grace"], "regrant": ev["regrant"],
            "world_during_outage": target, "outage_steps": outage,
            "shrink_s": round(shrink_s, 6), "regrow_s": round(regrow_s, 6),
            "shrink_fresh_builds": int(shrink_builds),
            "regrow_fresh_builds": int(fresh() - f0),
            "continuity_ok": bool(shrink_lossless and regrow_lossless),
        }

    cycles = [one_cycle(ev, f"event{i}")
              for i, ev in enumerate(trace["events"])]
    # always at least one warm cycle: replay the first event again so the
    # build-counter invariant is tested even on a single-event trace
    cycles.append(one_cycle(trace["events"][0], "warm_verify"))
    run_steps(args.steps_per_phase)

    goodput = state["achieved"] / max(1, state["ideal"])
    cold = cycles[0]
    warm = cycles[1:]
    warm_fresh = max(c["regrow_fresh_builds"] for c in warm)
    continuity = all(c["continuity_ok"] for c in cycles)
    doc = {
        "schema": SCHEMA, "ok": False, "trace": os.path.abspath(args.trace),
        "pattern": trace.get("pattern"), "world": world,
        "zones": trace["zones"], "events": len(trace["events"]),
        "steps": state["tick"],
        "achieved_rank_steps": state["achieved"],
        "ideal_rank_steps": state["ideal"],
        "goodput_fraction": round(goodput, 6),
        "goodput_floor": args.goodput_floor,
        "continuity_ok": continuity,
        "cold_regrow_s": cold["regrow_s"],
        "warm_regrow_s": round(min(c["regrow_s"] for c in warm), 6),
        "warm_fresh_builds": int(warm_fresh),
        "preempt_events": len(cycles),
        "victims_total": sum(len(c["victims"]) for c in cycles),
        "faults_injected": int(
            bfm.counter("bluefog_faults_injected_total").total()),
        "device": str(dev),
        "cycles": cycles,
    }
    doc["ok"] = bool(continuity and warm_fresh == 0
                     and goodput >= args.goodput_floor)
    if args.flight_dir:
        doc["flight_bundle"] = bfflight.dump(reason="preempt_bench")
    bf.shutdown()
    return doc


def main(argv=None) -> int:
    doc = run(parse(argv))
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
