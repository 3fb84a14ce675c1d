"""Step-time decomposition from a profiler trace (counterpart of
``tools/trace_analyze.py``).

Attributes device time to COMPUTE vs COMM and measures how much
communication is EXPOSED (not overlapped by compute): the overlap story
of the gossip permutes hiding behind the backward's compute.  Reported
numbers, as the JAX tool's:

    wall_ms            last device event end - first start
    busy_ms            union of all device intervals
    compute_ms         union of compute intervals
    comm_ms            union of comm intervals
    comm_exposed_ms    comm intervals minus compute coverage
    overlap_fraction   1 - exposed/comm (1.0 = fully hidden)
    idle_ms            wall - busy — dispatch gaps
    top_exposed_comm_ops  per-op attribution of the exposed time, top-k
                       groups by exposed ms
    n_events           device events analyzed

Two trace shapes are read:

* **A ``torch.profiler`` (Kineto) trace with CUDA activity** (the port's:
  ``*.pt.trace.json`` from ``export_chrome_trace``, ``utils.timeline``'s
  ``*.device_trace.json``).  Device work is the complete events whose
  ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, selected by
  category, not by track name: Kineto names its tracks differently from
  version to version (torch 2.11 with CUDA 12.8 on an H100 names every
  process ``python``, labels the host's ``CPU`` and the card's ``GPU 0``
  in ``process_labels`` events, and names the stream threads ``stream 7
  ``), so the JAX tool's name match would find no device track there.
  ``gpu_user_annotation`` events are ranges, not work, and count toward
  neither class.  A device event is comm when the host event that
  launched it (the one sharing its ``args.correlation``) lies inside a
  ``bluefog::<op>`` range on the same pid/tid — the ranges
  ``ops/collectives.py`` opens around every move and its transpose — or
  when it is an NCCL kernel (``nccl`` in its name).  Comm is grouped by
  the innermost enclosing range's name (``bluefog::psum``, ...) or, for
  NCCL, by the kernel's name.  Such a trace with no device event (a CPU
  run: the CPU has no device track to split), or with ``bluefog::``
  ranges but no device work launched inside any of them, is refused
  (``ok`` false, the error names what is missing; :func:`analyze_file`
  adds the file).
* **A TPU-shaped trace** (``jax.profiler``; the JAX tests' fixtures):
  the JAX tool's method, unchanged — the device tracks by process name
  (fallback: the busiest track) and comm by collective op name.

Run: python -m bluefog_tpu_torch.tools.trace_analyze <dir|file> [--out f]
(prints one JSON line; exit 1 when ``ok`` is false).
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys

# The JAX tool's collective classifier and device-track names (TPU-shaped
# traces): collective op spellings, async -start/-done halves included;
# copy-start/copy-done must NOT match.
COMM_RE = re.compile(
    r"ragged[-_]?all[-_]?to[-_]?all"
    r"|all[-_]?reduce|all[-_]?gather|reduce[-_]?scatter"
    r"|collective[-_]?permute|all[-_]?to[-_]?all|collective[-_]?broadcast"
    r"|\bsend(?:[-_]done)?\b|\brecv(?:[-_]done)?\b"
    r"|ppermute|collective", re.I)
DEVICE_RE = re.compile(r"tpu|/device:|gpu", re.I)

#: Kineto's device-work categories
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories only a torch.profiler (Kineto) trace carries
KINETO_CATS = DEVICE_CATS + ("cpu_op", "user_annotation",
                             "gpu_user_annotation", "cuda_runtime",
                             "cuda_driver", "python_function")
#: the prefix of the port's communication ranges
COMM_PREFIX = "bluefog::"
NCCL_RE = re.compile(r"nccl", re.I)

__all__ = ["find_trace_file", "load_events", "merge", "subtract",
           "canonical_op", "top_exposed_comm_ops", "analyze",
           "analyze_file", "COMM_RE", "DEVICE_RE", "DEVICE_CATS",
           "COMM_PREFIX"]


def find_trace_file(path):
    if os.path.isfile(path):
        return path
    for pat in ("**/*.trace.json.gz", "**/*.trace.json",
                "**/*.device_trace.json"):
        hits = sorted(glob.glob(os.path.join(path, pat), recursive=True))
        if hits:
            return hits[-1]                  # newest run dir sorts last
    raise FileNotFoundError(f"no *.trace.json[.gz] or *.device_trace.json "
                            f"under {path}")


def load_events(trace_file):
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc if isinstance(doc, list) else [])


def merge(intervals):
    """Union of [start, end) intervals; returns merged list + total."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out, sum(e - s for s, e in out)


def subtract(base, cover):
    """Total length of ``base`` intervals not covered by ``cover``."""
    total = 0.0
    ci = 0
    for s, e in base:
        pos = s
        while pos < e:
            while ci < len(cover) and cover[ci][1] <= pos:
                ci += 1
            if ci >= len(cover) or cover[ci][0] >= e:
                total += e - pos
                break
            c0, c1 = cover[ci]
            if c0 > pos:
                total += c0 - pos
            pos = c1
    return total


_INSTANCE_RE = re.compile(r"(\.\d+)+$")


def canonical_op(name):
    """Collapse per-instance HLO names: ``collective-permute-start.5`` and
    ``collective-permute-start.12`` are the same op for attribution."""
    return _INSTANCE_RE.sub("", name or "")


def top_exposed_comm_ops(comm_events, comp_cover, k=5, key=None):
    """Per-op exposed time: group comm events by ``key(event)`` (default
    the canonical name), measure each group's merged intervals against
    the compute cover.  Returns the top-k groups by exposed ms (ties
    broken by total ms), each as ``{"name", "count", "total_ms",
    "exposed_ms"}``."""
    key = key or (lambda ev: canonical_op(ev.get("name", "")))
    by_name = {}
    for ev in comm_events:
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        by_name.setdefault(key(ev), []).append(iv)
    us = 1e-3
    rows = []
    for name, ivs in by_name.items():
        merged, total = merge(ivs)
        rows.append({
            "name": name,
            "count": len(ivs),
            "total_ms": round(total * us, 3),
            "exposed_ms": round(subtract(merged, comp_cover) * us, 3),
        })
    rows.sort(key=lambda r: (-r["exposed_ms"], -r["total_ms"], r["name"]))
    return rows[:k]


def _split(xs, is_comm, key=None):
    """The JAX tool's numbers from device events ``xs`` classed by
    ``is_comm``."""
    comm_iv, comp_iv, comm_events = [], [], []
    for ev in xs:
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if is_comm(ev):
            comm_iv.append(iv)
            comm_events.append(ev)
        else:
            comp_iv.append(iv)
    comm_m, comm_total = merge(comm_iv)
    comp_m, comp_total = merge(comp_iv)
    all_m, busy_total = merge(comm_iv + comp_iv)
    wall = max(e for _, e in all_m) - min(s for s, _ in all_m)
    exposed = subtract(comm_m, comp_m)
    us = 1e-3                                 # trace timestamps are in us
    return {
        "ok": True,
        "n_events": len(xs),
        "wall_ms": round(wall * us, 3),
        "busy_ms": round(busy_total * us, 3),
        "compute_ms": round(comp_total * us, 3),
        "comm_ms": round(comm_total * us, 3),
        "comm_exposed_ms": round(exposed * us, 3),
        "overlap_fraction": (round(1.0 - exposed / comm_total, 4)
                             if comm_total > 0 else None),
        "idle_ms": round((wall - busy_total) * us, 3),
        "top_exposed_comm_ops": top_exposed_comm_ops(comm_events, comp_m,
                                                     key=key),
    }


def _innermost(ranges, points):
    """``{key: name}`` of the innermost range ``(start, end, name)``
    holding each point ``(ts, key)``; the ranges of one thread nest."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, ri = {}, [], 0
    for ts, key in sorted(points):
        while ri < len(ranges) and ranges[ri][0] <= ts:
            while stack and stack[-1][1] <= ranges[ri][0]:
                stack.pop()
            stack.append(ranges[ri])
            ri += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _analyze_kineto(events):
    pid_names = {}
    for ev in events:                  # a track's label, else its name
        if ev.get("ph") == "M" and ev.get("name") in ("process_name",
                                                      "process_labels"):
            args = ev.get("args", {})
            label = args.get("labels") or args.get("name") or ""
            if ev["name"] == "process_labels" or ev.get("pid") not in \
                    pid_names:
                pid_names[ev.get("pid")] = label
    xs, ranges, launches = [], {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            if ev.get("dur", 0) > 0:
                xs.append(ev)
            continue
        if cat == "gpu_user_annotation":
            continue
        where = (ev.get("pid"), ev.get("tid"))
        name = ev.get("name", "")
        if cat == "user_annotation" and name.startswith(COMM_PREFIX):
            ts = float(ev["ts"])
            ranges.setdefault(where, []).append(
                (ts, ts + float(ev.get("dur", 0)), name))
        corr = (ev.get("args") or {}).get("correlation")
        if corr is not None:
            launches.setdefault(where, []).append((float(ev["ts"]), corr))
    n_ranges = sum(len(r) for r in ranges.values())
    if not xs:
        return {"ok": False, "error": (
            "no CUDA device events (kernel / gpu_memcpy / gpu_memset) in "
            "the trace: a CPU profile has no device track to split")}
    in_range = {}
    for where, points in launches.items():
        if where in ranges:
            in_range.update(_innermost(ranges[where], points))

    def group(ev):
        corr = (ev.get("args") or {}).get("correlation")
        name = in_range.get(corr)
        if name is None and NCCL_RE.search(ev.get("name", "")):
            name = canonical_op(ev.get("name", ""))
        return name

    doc = _split(xs, lambda ev: group(ev) is not None, key=group)
    if n_ranges and not doc["comm_ms"]:
        return {"ok": False, "error": (
            f"the trace holds {n_ranges} {COMM_PREFIX} ranges but no device "
            "work launched inside any of them: the moves' launches were "
            "not linked to the device events")}
    doc["n_comm_ranges"] = n_ranges
    doc["device_tracks"] = sorted({str(pid_names.get(ev.get("pid"),
                                                     ev.get("pid")))
                                   for ev in xs})
    return doc


def analyze(events):
    if any(ev.get("cat") in KINETO_CATS for ev in events):
        return _analyze_kineto(events)
    pid_names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
    device_pids = {p for p, n in pid_names.items() if DEVICE_RE.search(n)}
    xs = [ev for ev in events
          if ev.get("ph") == "X" and ev.get("dur", 0) > 0]
    if device_pids:
        xs = [ev for ev in xs if ev.get("pid") in device_pids]
    elif xs:
        # fallback: the busiest pid is the device/op track
        busy = {}
        for ev in xs:
            busy[ev.get("pid")] = busy.get(ev.get("pid"), 0) + ev["dur"]
        top = max(busy, key=busy.get)
        xs = [ev for ev in xs if ev.get("pid") == top]
    if not xs:
        return {"ok": False, "error": "no complete events on device tracks"}
    return _split(xs, lambda ev: COMM_RE.search(ev.get("name", "")))


def analyze_file(path):
    """:func:`analyze` of the trace at ``path`` (a file, or the newest
    trace under a directory), with ``trace_file`` set and the file named
    in any error."""
    tf = find_trace_file(path)
    doc = analyze(load_events(tf))
    doc["trace_file"] = tf
    if not doc["ok"]:
        doc["error"] = f"{tf}: {doc['error']}"
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="trace dir (or .trace.json[.gz] file)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    try:
        doc = analyze_file(args.trace)
    except (OSError, ValueError, FileNotFoundError) as e:
        doc = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
    print(json.dumps(doc))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    sys.exit(0 if doc.get("ok") else 1)


if __name__ == "__main__":
    main()
