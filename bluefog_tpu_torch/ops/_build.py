"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for ``sm_90a`` from a plain-C
interface (no PyTorch headers, so a build takes seconds) into
``bluefog_tpu_torch/_build/``, keyed by a hash of its sources and flags
(nvcc's output beside it, for :func:`build_log`), and loaded with
``ctypes``.  Every ``csrc/*.cuh`` header is on the include
path (``-I csrc``) and in the hash, so an edit to a shared header rebuilds
each library that may include it.  Nothing is compiled at import: the first
call that needs a library builds it.

:func:`build_counts` counts the ``nvcc`` builds and the library loads of
this process.  A library is built and loaded once a process, keyed by its
sources and never by the world it runs in, so a world re-formed at a new
rank count (``parallel.context.reinit``) builds and loads nothing: these
counts are what the preemption bench and the chip smoke read where the JAX
package reads its compile counter.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "headers", "load_library",
           "build_log", "build_counts"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, Path] = {}   # nvcc's output, beside each library
_COUNTS = {"builds": 0, "loads": 0}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def headers() -> List[Path]:
    """The shared headers under ``csrc/``, in name order."""
    return sorted(CSRC.glob("*.cuh"))


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library ``name`` built from ``sources`` (paths relative
    to ``csrc/``), compiling it first if this source hash has no build."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
        log = so.with_suffix(".log")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)                 # atomic: concurrent builders
        _COUNTS["builds"] += 1
    _LOGS[name] = so.with_suffix(".log")
    _LIBS[name] = ctypes.CDLL(str(so))
    _COUNTS["loads"] += 1
    return _LIBS[name]


def build_counts() -> Dict[str, int]:
    """``{"builds": nvcc runs, "loads": libraries loaded}`` in this
    process so far."""
    return dict(_COUNTS)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory use) from
    the build of the library ``name`` this process loaded, kept beside it
    (a build by an earlier process included); empty before the load."""
    log = _LOGS.get(name)
    return log.read_text() if log is not None and log.exists() else ""
