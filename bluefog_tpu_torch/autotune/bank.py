"""Tier-2 evidence: banked on-hardware artifacts from ``docs/measured/``
(the port's copy of ``bluefog_tpu/autotune/bank.py``, the same rules).

A banked bench artifact that recorded which algorithm it ran (an
``algorithm`` field with ``fused_per_step_s``) or a banked autotune trial
can override the analytic pseudo-seconds for candidates on MATCHING
hardware (device kind + chip count) — never steering a differently-sized
mesh.  Only ``ok`` + ``on_accelerator`` artifacts count, so a CPU run can
never rank candidates.  The port's device kind is
``torch.cuda.get_device_name()`` on the card and ``"cpu"`` on the CPU,
and ``on_accelerator`` is true only for CUDA; the TPU artifacts the repo
keeps in ``docs/measured/`` name TPU device kinds, so they never match a
card (nor the CPU, where nothing is ``on_accelerator``).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional, Tuple


def measured_dir() -> str:
    return os.environ.get(
        "BLUEFOG_MEASURED_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "docs", "measured"))


def _iter_artifacts(prefixes: Tuple[str, ...], mdir: Optional[str]):
    mdir = mdir or measured_dir()
    for prefix in prefixes:
        for p in sorted(glob.glob(os.path.join(mdir, prefix + "*.json"))):
            try:
                with open(p) as f:
                    d = json.load(f)
                if not (isinstance(d, dict) and d.get("ok")
                        and d.get("on_accelerator")):
                    continue
            except (OSError, ValueError, TypeError):
                continue
            yield d, os.path.basename(p)


def banked_step_time(algorithm: str, device_kind: Optional[str],
                     n_chips: int,
                     mdir: Optional[str] = None,
                     key: Optional[str] = None,
                     ) -> Optional[Tuple[float, str, bool]]:
    """Fastest banked ``(seconds_per_step, source, exact)`` for
    ``algorithm`` on matching hardware, or None.

    Sources, in one pass: autotune trial artifacts
    (``autotune_trial_*.json``, exact per-candidate timings — when ``key``
    is given an artifact recording a *different* candidate key is skipped)
    and strategy-aware bench artifacts (``bench*.json`` carrying the
    schema-2 ``algorithm`` field with ``fused_per_step_s`` — coarse,
    algorithm-level evidence, returned with ``exact=False``).  An exact
    match always beats a coarse one.  Artifacts that never recorded the
    hardware or algorithm fields cannot be verified and are skipped.
    """
    best = None
    for d, src in _iter_artifacts(("autotune_trial_", "bench"), mdir):
        try:
            if d.get("algorithm") != algorithm:
                continue
            if device_kind is not None and d.get("device") != device_kind:
                continue
            if int(d.get("n_chips", -1)) != int(n_chips):
                continue
            exact = "key" in d
            if exact and key is not None and d["key"] != key:
                continue
            t = float(d.get("seconds_per_step",
                            d.get("fused_per_step_s", 0.0)))
        except (ValueError, TypeError):
            continue
        if t <= 0:
            continue
        if best is None or (exact, -t) > (best[2], -best[0]):
            best = (t, src, exact)
    return best


def bank_trial(doc: dict, mdir: Optional[str] = None) -> Optional[str]:
    """Write one trial artifact immediately (incremental banking: a
    mid-search death loses only the unfinished trial — the ``hw_watch``
    discipline).  Returns the path, or None when the dir is unwritable
    (banking is best-effort; a read-only checkout must not kill a tune)."""
    mdir = mdir or measured_dir()
    name = "autotune_trial_{}.json".format(
        doc.get("trial_id", doc.get("plan_id", "x")))
    path = os.path.join(mdir, name)
    try:
        os.makedirs(mdir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        return None
    return path
