"""fleet_top: live terminal dashboard over the gossiped fleet view (the
port of ``tools/fleet_top.py``).

Any rank running with a fleet view armed (``BLUEFOG_FLEET_EVERY=K`` /
``bfrun-torch --fleet-view K``) and the metrics HTTP server up
(``--metrics-port``) serves its view of the *whole fleet* at ``/fleet``
— per-rank step time, consensus distance, queue depth, SLO burn,
hot-expert skew, and the staleness age of every row.  This tool renders
that JSON as a ranks × signals table with a refresh loop; because the
view is gossiped, pointing it at ANY rank shows the whole fleet.

Sources (one required):
    --url http://host:port/fleet    scrape a live rank
    --from-file fleet.json          render a saved view

Modes:
    (default)                       refresh loop (--interval seconds)
    --once                          one frame, then exit
    --once --json [--out f.json]    machine-readable frame for CI: the
                                    raw /fleet JSON, schema-checked

The JAX tool's ``--virtual-cpu`` self-estate has no counterpart here: the
port's estate with the carrier armed is ``chip_smoke.py``'s phase 22 (and
``tests/test_torch_fleetview.py`` on the CPU).

Exit codes: 0 ok; 1 source unreachable / not armed / bad schema.
"""
import argparse
import json
import os
import sys
import time
import urllib.request

SCHEMA = "bluefog-fleet-1"

# dashboard columns: (header, metric name, format)
COLUMNS = (
    ("step_s", "bluefog_step_time_ewma_s", "{:.4f}"),
    ("consens", "bluefog_consensus_distance_max", "{:.2e}"),
    ("stale", "bluefog_async_staleness_steps", "{:.0f}"),
    ("queue", "bluefog_serve_queue_depth", "{:.0f}"),
    ("p99_s", "bluefog_serve_p99_s", "{:.4f}"),
    ("burn", "bluefog_slo_burn_rate", "{:.2f}"),
    ("hot_exp", "bluefog_serve_hot_expert_fraction", "{:.2f}"),
)


def check_schema(doc):
    """Raise ValueError unless ``doc`` looks like a /fleet frame (the CI
    schema assert)."""
    if not isinstance(doc, dict):
        raise ValueError("fleet frame is not a JSON object")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema {doc.get('schema')!r} != {SCHEMA!r}")
    for key in ("n", "round", "live_ranks", "staleness", "metrics"):
        if key not in doc:
            raise ValueError(f"fleet frame missing key {key!r}")
    st = doc["staleness"]
    for key in ("rounds_per_rank", "rounds_max", "bound_rounds"):
        if key not in st:
            raise ValueError(f"fleet staleness missing key {key!r}")
    for name, m in doc["metrics"].items():
        if "kind" not in m:
            raise ValueError(f"metric {name!r} missing kind")
        if m["kind"] != "histogram" and "per_rank" not in m:
            raise ValueError(f"metric {name!r} missing per_rank table")
    return doc


def _per_rank(doc, name, rank):
    m = doc.get("metrics", {}).get(name)
    if not m or m.get("kind") == "histogram":
        return None
    per = m.get("per_rank", {})
    # JSON object keys are strings; in-process dicts use ints
    return per.get(str(rank), per.get(rank))


def render(doc):
    """One frame as text: header + ranks × signals table."""
    st = doc["staleness"]
    ages = st.get("rounds_per_rank") or []
    dead = set(doc.get("dead_ranks", ()))
    lines = [
        f"fleet_top — {len(doc['live_ranks'])}/{doc['n']} ranks live, "
        f"round {doc['round']}, view of rank {doc.get('rank', '?')}",
        f"staleness: max {st.get('rounds_max')} rounds "
        f"(bound {st.get('bound_rounds')}), "
        f"probe cadence {_fmt(st.get('probe_cadence_s'), '{:.3f}')}s, "
        f"age est {_fmt(st.get('age_s_est'), '{:.3f}')}s",
        "",
    ]
    headers = ["rank"] + [h for h, _, _ in COLUMNS] + ["age", ""]
    rows = [headers]
    for r in range(int(doc["n"])):
        cells = [str(r)]
        for _, name, fmt in COLUMNS:
            cells.append(_fmt(_per_rank(doc, name, r), fmt))
        age = ages[r] if r < len(ages) else None
        cells.append(_fmt(age, "{:.0f}"))
        cells.append("DEAD" if r in dead else "")
        rows.append(cells)
    widths = [max(len(row[i]) for row in rows) for i in range(len(headers))]
    for i, row in enumerate(rows):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    global_bits = []
    for name, m in sorted(doc.get("metrics", {}).items()):
        if m.get("kind") == "counter" and m.get("global") is not None:
            short = name[len("bluefog_"):] if name.startswith("bluefog_") \
                else name
            global_bits.append(f"{short}={m['global']:g}")
    if global_bits:
        lines += ["", "fleet totals: " + "  ".join(global_bits)]
    return "\n".join(lines)


def _fmt(v, fmt):
    if v is None:
        return "-"
    try:
        return fmt.format(float(v))
    except (TypeError, ValueError):
        return str(v)


def fetch(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Live terminal dashboard over the gossiped fleet view.")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--url", default=None,
                     help="a live rank's /fleet endpoint "
                          "(http://host:port/fleet)")
    src.add_argument("--from-file", default=None,
                     help="render a saved /fleet JSON instead of scraping")
    ap.add_argument("--once", action="store_true",
                    help="one frame, then exit (no refresh loop)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the raw fleet JSON (schema-checked) "
                         "instead of the table")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after this many frames (default: forever)")
    ap.add_argument("--out", default=None,
                    help="also write the last frame's JSON here")
    args = ap.parse_args(argv)
    if not (args.url or args.from_file):
        ap.error("give --url or --from-file")

    def get_frame():
        if args.from_file:
            with open(args.from_file) as f:
                return json.load(f)
        return fetch(args.url)

    try:
        frame = get_frame()
        check_schema(frame)
    except Exception as e:
        print(json.dumps({"ok": False,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        return 1

    frames = 0
    while True:
        doc = dict(frame)
        if args.as_json:
            print(json.dumps(doc))
        else:
            if not args.once:
                print("\033[2J\033[H", end="")       # clear + home
            print(render(frame))
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=1)
        frames += 1
        if args.once or (args.frames is not None and frames >= args.frames):
            break
        try:
            time.sleep(args.interval)
            frame = check_schema(get_frame())
        except KeyboardInterrupt:
            break
        except Exception as e:
            print(f"fleet_top: source lost: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
