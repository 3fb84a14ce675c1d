"""Host C++ helpers, bound with ctypes (the port's own copies of
``bluefog_tpu/_native``):

* ``timeline.cc``: the Chrome-trace writer, a ring buffer drained by a
  flush thread (reference: ``common/timeline.{h,cc}``);
* ``schedule.cc``: the edge -> gossip-round colorer;
* ``loader.cc``: the thread-pool row gather.

Only the timeline writer is on a path of the port
(``utils/timeline.py``).  The colorer and the row gather are bound and
held equal to their numpy paths, which ``schedule.color_edges`` and
``data.ShardedLoader`` use: the port's topologies have at most tens of
edges, and at the examples' batches the gather runs one memcpy loop
behind a ctypes call (chip_smoke's phase 21 times it against numpy's).

The host C++ compiler (``$CXX``, else ``g++``) builds them at first use
into ``bluefog_tpu_torch/_build/``, keyed by a hash of the sources and
flags as the CUDA libraries are (``ops/_build.py``).  Every entry point
keeps a Python path for a machine without a compiler; :func:`available`
says which one runs, and :func:`build_error` why the library did not
load.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

__all__ = ["load", "available", "build_error", "library_path",
           "color_edges_native", "gather_rows_native", "timeline_start",
           "timeline_record", "timeline_stop"]

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build"
_SOURCES = ("timeline.cc", "schedule.cc", "loader.cc")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_error: Optional[str] = None


def _cxx() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _target() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.encode())
        h.update((_HERE / s).read_bytes())
    return _BUILD / f"libbft_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    cxx = _cxx()
    if cxx is None:
        return "no host C++ compiler (set CXX)"
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *_FLAGS, "-o", str(tmp),
           *(str(_HERE / s) for s in _SOURCES), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        return f"{' '.join(cmd)}:\n{proc.stderr[-2000:]}"
    os.replace(tmp, so)             # atomic against a concurrent build
    return None


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (building it first if this source hash has no
    build); None when it cannot be built or loaded."""
    global _lib, _lib_path, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        so = _target()
        if not so.exists():
            _error = _build(so)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _error = str(e)
            return None
        lib.bft_timeline_start.argtypes = [ctypes.c_char_p]
        lib.bft_timeline_start.restype = ctypes.c_int
        lib.bft_timeline_record.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.bft_timeline_record.restype = ctypes.c_int
        lib.bft_timeline_stop.argtypes = []
        lib.bft_timeline_stop.restype = ctypes.c_int64
        lib.bft_timeline_dropped.argtypes = []
        lib.bft_timeline_dropped.restype = ctypes.c_int64
        lib.bft_color_edges.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.bft_color_edges.restype = ctypes.c_int32
        lib.bft_gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32]
        lib.bft_gather_rows.restype = ctypes.c_int32
        _lib, _lib_path = lib, so
        return _lib


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    """Why the library did not load (None when it did, or before a try)."""
    return _error


def library_path() -> Optional[str]:
    """The loaded library's file (None before a successful load)."""
    return None if _lib_path is None else str(_lib_path)


# ---------------------------------------------------------------------------
# schedule: native edge coloring
# ---------------------------------------------------------------------------

def color_edges_native(
    edges: Sequence[Tuple[int, int]], size: int,
) -> Optional[List[List[Tuple[int, int]]]]:
    """Native edge -> round partitioning with ``schedule.color_edges``'
    output contract (the same greedy order); None without the library."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    dedup = sorted(set((int(s), int(d)) for s, d in edges))
    n = len(dedup)
    srcs = np.asarray([e[0] for e in dedup], dtype=np.int32)
    dsts = np.asarray([e[1] for e in dedup], dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    n_rounds = lib.bft_color_edges(
        srcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dsts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n_rounds < 0:
        raise ValueError("invalid edge set (self-loop or rank out of range)")
    rounds: List[List[Tuple[int, int]]] = [[] for _ in range(n_rounds)]
    # rebuild each round in the colorer's processing order
    order = sorted(range(n),
                   key=lambda i: ((dedup[i][1] - dedup[i][0]) % size,
                                  dedup[i][0]))
    for i in order:
        rounds[int(out[i])].append(dedup[i])
    return rounds


# ---------------------------------------------------------------------------
# loader: native multi-threaded row gather
# ---------------------------------------------------------------------------

def gather_rows_native(src, idx, threads: int = 4):
    """``src[idx]`` for row indices through the native thread-pool
    memcpy engine.

    Returns None when the library is unavailable or the layout is not a
    plain C-contiguous row gather (callers fall back to numpy)."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    src = np.asarray(src)
    # raw-memcpy engine: refuse layouts it cannot handle rather than pay a
    # hidden whole-array copy (non-contiguous) or corrupt refcounts (object
    # dtype) — callers fall back to numpy
    if src.dtype.hasobject or not src.flags.c_contiguous or src.ndim < 1:
        return None
    idx = np.asarray(idx)
    # bool masks and float indices mean something different (or error) under
    # numpy — only integer row gathers belong to this engine
    if idx.dtype == np.bool_ or not np.issubdtype(idx.dtype, np.integer):
        return None
    flat_idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    # numpy row-gather semantics: negative indices wrap
    flat_idx = np.where(flat_idx < 0, flat_idx + src.shape[0], flat_idx)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    if row_bytes <= 0:
        return None
    dst = np.empty((flat_idx.size,) + src.shape[1:], dtype=src.dtype)
    rc = lib.bft_gather_rows(
        dst.ctypes.data_as(ctypes.c_char_p),
        src.ctypes.data_as(ctypes.c_char_p),
        row_bytes,
        flat_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flat_idx.size, src.shape[0], int(threads))
    if rc != 0:
        raise IndexError("gather index out of range")
    return dst.reshape(tuple(np.shape(idx)) + src.shape[1:])


# ---------------------------------------------------------------------------
# timeline: native writer
# ---------------------------------------------------------------------------

def timeline_start(path: str) -> bool:
    lib = load()
    return bool(lib and lib.bft_timeline_start(path.encode()))


def timeline_record(name: str, cat: str, ph: str, ts_us: int,
                    dur_us: int = 0, pid: int = 0, tid: int = 0) -> bool:
    lib = load()
    return bool(lib and lib.bft_timeline_record(
        name.encode(), cat.encode(), ph.encode(), int(ts_us), int(dur_us),
        int(pid), int(tid)))


def timeline_stop() -> int:
    """Stop and flush; returns the dropped-event count (-1 if not
    running)."""
    lib = load()
    return int(lib.bft_timeline_stop()) if lib else -1
