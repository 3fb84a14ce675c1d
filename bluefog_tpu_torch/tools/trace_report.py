"""Per-request latency breakdown from trace bundles (the port's own copy
of ``report_from_files`` from the JAX package's ``tools/trace_report.py``
and the functions it calls; the Chrome-trace writer and the CLI stay
there and read the port's bundles, whose schema is the same).

A bundle is ``<dir>/trace_rank<r>.trace.jsonl`` (schema
``bluefog-trace-1``, written by :func:`bluefog_tpu_torch.utils.tracing.
flush`): a ``meta`` line with a ``(monotonic, wall)`` clock anchor, then
one line per span.  The critical path splits each retired request's
end-to-end time (its root ``request`` span) into queue wait, prefill,
summed decode calls and the scheduling gap between them, so ``queue +
prefill + decode + gap == total``.
"""
import json
import sys
import time

SCHEMA = "bluefog-trace-report-1"
BUNDLE_SCHEMA = "bluefog-trace-1"


def load_bundle(path, notes=None):
    """One bundle -> (meta, [spans]).  Torn trailing lines (the writer
    died mid-append) are skipped with a warning, never fatal."""
    meta, spans = None, []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError as e:
                msg = (f"warning: {path}:{lineno}: skipping torn JSONL "
                       f"line ({e.msg})")
                print(msg, file=sys.stderr)
                if notes is not None:
                    notes.append(msg)
                continue
            if doc.get("kind") == "meta":
                meta = doc
            elif doc.get("kind") == "span":
                spans.append(doc)
    if meta is None:
        raise ValueError(f"{path}: no meta line (not a {BUNDLE_SCHEMA} "
                         "bundle?)")
    if meta.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(f"{path}: schema {meta.get('schema')!r} != "
                         f"{BUNDLE_SCHEMA!r}")
    return meta, spans


def _wall(meta, t):
    """Per-rank monotonic timestamp -> shared wall-clock seconds."""
    return meta["wall"] + (t - meta["mono"])


def critical_path(bundles):
    """Per-request breakdown from the serve span trees.

    Only requests with a root ``request`` span (i.e. retired) get a row.
    ``gap_s`` is everything the named child spans don't cover: host-side
    scheduling between the fused calls.
    """
    reqs = {}
    for meta, spans in bundles:
        for s in spans:
            if s.get("cat") != "serve":
                continue
            acc = reqs.setdefault(s["trace"], {
                "queue_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
                "n_decode_calls": 0, "spec_accepted": 0,
                "prefix_hit": None, "total_s": None})
            name = s.get("name")
            dur = max(s["t1"] - s["t0"], 0.0)
            if name == "queue":
                acc["queue_s"] += dur
            elif name == "prefill":
                acc["prefill_s"] += dur
                acc["prefix_hit"] = bool(s.get("hit"))
            elif name == "decode":
                acc["decode_s"] += dur
                acc["n_decode_calls"] += 1
                acc["spec_accepted"] += int(s.get("accepted", 0))
            elif name == "request":
                acc["total_s"] = dur
                acc["tokens"] = s.get("tokens")
                acc["replica"] = s.get("replica")
    out = {}
    for trace, acc in reqs.items():
        if acc["total_s"] is None:
            continue                          # still in flight at flush
        acc["gap_s"] = max(acc["total_s"] - acc["queue_s"]
                           - acc["prefill_s"] - acc["decode_s"], 0.0)
        out[trace] = {k: (round(v, 9) if isinstance(v, float) else v)
                      for k, v in acc.items()}
    return out


def train_summary(bundles):
    steps, probes, total = 0, 0, 0.0
    for meta, spans in bundles:
        for s in spans:
            if s.get("cat") != "train":
                continue
            if s.get("name") == "train_step":
                steps += 1
                total += max(s["t1"] - s["t0"], 0.0)
            elif s.get("name") == "consensus_probe":
                probes += 1
    return {"steps": steps,
            "step_mean_s": round(total / steps, 9) if steps else None,
            "probes": probes}


def window_bounds(since=None, last=None, now=None):
    """``--since <wall-ts>`` / ``--last <secs>`` -> one lower wall-clock
    bound (None = keep everything; both given: later bound wins)."""
    if since is None and last is None:
        return None
    bounds = []
    if since is not None:
        bounds.append(float(since))
    if last is not None:
        if last <= 0:
            raise ValueError(f"--last must be > 0 seconds, got {last}")
        bounds.append((time.time() if now is None else float(now))
                      - float(last))
    return max(bounds)


def filter_bundles(bundles, cut):
    """Drop spans that *ended* before wall time ``cut`` (a span still
    running into the window counts: its tail is inside)."""
    if cut is None:
        return bundles
    return [(meta,
             [s for s in spans if _wall(meta, s["t1"]) >= cut])
            for meta, spans in bundles]


def report_from_files(paths, since=None, last=None):
    notes = []
    cut = window_bounds(since, last)
    bundles = [load_bundle(p, notes=notes) for p in paths]
    if cut is not None:
        before = sum(len(s) for _, s in bundles)
        bundles = filter_bundles(bundles, cut)
        dropped = before - sum(len(s) for _, s in bundles)
        if dropped:
            notes.append(f"window filter dropped {dropped} span(s) "
                         f"ending before {cut:.3f}")
    reqs = critical_path(bundles)
    table = sorted(
        ([t, v["total_s"], v["queue_s"], v["prefill_s"], v["decode_s"],
          v["gap_s"]] for t, v in reqs.items()),
        key=lambda row: -row[1])
    doc = {
        "ok": True,
        "schema": SCHEMA,
        "n_ranks": len(bundles),
        "ranks": sorted(m.get("rank", 0) for m, _ in bundles),
        "n_spans": sum(len(s) for _, s in bundles),
        "dropped": sum(m.get("dropped", 0) for m, _ in bundles),
        "requests": reqs,
        "critical_path": table,
        "train": train_summary(bundles),
    }
    if cut is not None:
        doc["window"] = {"since_ts": cut}
    if notes:
        doc["notes"] = notes
    return doc, bundles
