"""Generate spot-preemption traces (schema ``bluefog-preempt-trace-1``):
the port of ``tools/preempt_trace.py``.

The trace grammar the preemptible-fleet story replays: a JSON document of
timed preemption events, each naming its victims (an explicit rank list or
a correlated ``zone``), the advance-notice ``grace`` window, and the
``regrant`` delay before the reclaimed capacity returns.  Consumers:

* ``bfrun-torch -np N --preempt-trace trace.json`` — the launcher SIGTERMs
  the victims at each event time, waits out the grace window while they
  drain (flight + trace bundles flush), SIGKILLs whatever remains, and
  respawns the capacity as fresh-identity joins after the re-grant delay.
* ``bluefog_tpu_torch.tools.preempt_bench`` — replays the trace in-process
  against a stacked fleet and grades goodput / progress continuity /
  regrowth latency.

Patterns (all seeded and deterministic; the draws are Python's
``random.Random(seed)``, as the JAX tool's, so both give the same document
for the same flags):

* ``diurnal``       — reclaim waves at a regular period, rotating through
                      the zones (the evening-peak reclaim cycle).
* ``mass``          — one correlated event takes out a large fraction of
                      the zones at once (the capacity-crunch stampede).
* ``slow-regrant``  — scattered single-zone reclaims whose capacity is
                      slow to come back (regrant >> grace).

Example::

    python -m bluefog_tpu_torch.tools.preempt_trace --pattern mass \
        --world 8 --zones 4 --duration 30 --seed 0 --out /tmp/mass.json
"""
from __future__ import annotations

import argparse
import json
import random
import sys

SCHEMA = "bluefog-preempt-trace-1"


def _diurnal(args, rng) -> list:
    period = args.duration / max(1, args.events)
    events = []
    for i in range(args.events):
        events.append({
            "t": round((i + 0.5) * period, 3),
            "zone": i % args.zones,
            "grace": args.grace,
            "regrant": args.regrant,
        })
    return events


def _mass(args, rng) -> list:
    """One correlated wave: most zones reclaimed within a short burst."""
    hit = max(1, int(round(args.zones * args.fraction)))
    zones = rng.sample(range(args.zones), hit)
    t0 = args.duration * 0.4
    return [{
        "t": round(t0 + 0.05 * j, 3),     # near-simultaneous, stable order
        "zone": z,
        "grace": args.grace,
        "regrant": args.regrant,
    } for j, z in enumerate(sorted(zones))]


def _slow_regrant(args, rng) -> list:
    events = []
    for i in range(args.events):
        events.append({
            "t": round(rng.uniform(0.1, 0.9) * args.duration, 3),
            "zone": rng.randrange(args.zones),
            "grace": args.grace,
            # the defining feature: capacity stays gone for a long time
            "regrant": args.regrant * args.slow_factor,
        })
    events.sort(key=lambda e: e["t"])
    return events


PATTERNS = {"diurnal": _diurnal, "mass": _mass, "slow-regrant": _slow_regrant}


def build_trace(args) -> dict:
    rng = random.Random(args.seed)
    events = PATTERNS[args.pattern](args, rng)
    return {
        "schema": SCHEMA,
        "pattern": args.pattern,
        "seed": args.seed,
        "world": args.world,
        "zones": args.zones,
        "events": events,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pattern", choices=sorted(PATTERNS), required=True)
    p.add_argument("--world", type=int, default=8,
                   help="fleet size the zone blocks divide (default 8)")
    p.add_argument("--zones", type=int, default=4,
                   help="correlated-failure zones (default 4)")
    p.add_argument("--duration", type=float, default=30.0,
                   help="trace horizon in seconds (default 30)")
    p.add_argument("--events", type=int, default=4,
                   help="event count for diurnal/slow-regrant (default 4)")
    p.add_argument("--fraction", type=float, default=0.5,
                   help="mass: fraction of zones reclaimed (default 0.5)")
    p.add_argument("--grace", type=float, default=2.0,
                   help="advance-notice seconds per event (default 2)")
    p.add_argument("--regrant", type=float, default=5.0,
                   help="re-grant delay seconds per event (default 5)")
    p.add_argument("--slow-factor", type=float, default=6.0,
                   help="slow-regrant: multiplier on --regrant (default 6)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output path (default: stdout)")
    args = p.parse_args(argv)
    if args.zones < 1 or args.world < args.zones:
        raise SystemExit(
            f"need 1 <= zones <= world, got zones={args.zones} "
            f"world={args.world}")
    if not (0.0 < args.fraction <= 1.0):
        raise SystemExit(f"--fraction must be in (0, 1], got {args.fraction}")
    doc = build_trace(args)
    text = json.dumps(doc, indent=2) + "\n"
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {len(doc['events'])} event(s) to {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
