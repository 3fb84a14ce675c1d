"""The elastic scale file (the port's own copy of ``_write_scale`` and
``_read_scale`` from ``bluefog_tpu/run/launcher.py``).

The rest of the JAX launcher (bfrun over processes and hosts) waits for
ROADMAP queue 1, item 10.  The file's contract is the JAX supervisor's:
one integer, the target world size in RANKS (live serve replicas x the
ranks of one replica's slice), written atomically; the serving
autoscaler writes it on every scale action.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

__all__ = ["_write_scale", "_read_scale"]


def _write_scale(path: str, target: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{int(target)}\n")
    os.replace(tmp, path)      # atomic: the supervisor never reads a torn file


_warned_scale: set = set()


def _read_scale(path: str, min_world: Optional[int] = None) -> Optional[int]:
    """Read the elastic scale target; ``None`` when absent or unusable.

    A missing file is the normal idle state (silent), but a *malformed*
    file or a target below ``min_world`` means a hand-written target is
    silently disabling elastic scaling — warn once per offending content
    naming the path, so the operator can fix it.
    """
    try:
        with open(path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    try:
        target = int(raw)
    except ValueError:
        key = (path, raw)
        if key not in _warned_scale:
            _warned_scale.add(key)
            print(f"bfrun-tpu: ignoring malformed scale file {path}: "
                  f"expected an integer target, got {raw!r}",
                  file=sys.stderr, flush=True)
        return None
    if min_world is not None and target < min_world:
        key = (path, raw)
        if key not in _warned_scale:
            _warned_scale.add(key)
            print(f"bfrun-tpu: ignoring scale file {path}: target "
                  f"{target} is below the minimum world size {min_world}",
                  file=sys.stderr, flush=True)
        return None
    return target
