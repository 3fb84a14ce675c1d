"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for ``sm_90a`` from a plain-C
interface (no PyTorch headers, so a build takes seconds) into
``bluefog_tpu_torch/_build/``, keyed by a hash of its sources and flags,
and loaded with ``ctypes``.  Nothing is compiled at import: the first call
that needs a library builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "load_library", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library ``name`` built from ``sources`` (paths relative
    to ``csrc/``), compiling it first if this source hash has no build."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.read_bytes())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)                 # atomic: concurrent builders
        _LOGS[name] = proc.stdout + proc.stderr
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory use) from
    this process's build of ``name``; empty when it was already built."""
    return _LOGS.get(name, "")
