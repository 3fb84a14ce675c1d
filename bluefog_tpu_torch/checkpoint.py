"""Checkpoint / resume for distributed training state (the port's
counterpart of ``bluefog_tpu/checkpoint.py``).

Every leaf carries the leading rank axis, so one checkpoint holds every
rank's (generally different, pre-consensus) state, and restoring
reproduces the decentralized state exactly.  The JAX package writes with
orbax, which the port does not have: the port writes its own format and
does not read JAX's checkpoints.  A checkpoint is the directory
``<dir>/step_<n>`` (``serving_step_<n>`` for a serving snapshot) holding

* ``state.pt`` (``state_<p>-of-<w>.pt`` for process ``p`` of ``w``, each
  with its block of rows): a ``torch.save`` of ``{"format", "state"}``,
  the tree's host snapshot (``utils/snapshot.py``: dicts, lists, tuples,
  CPU tensors and plain values; an optimizer as its per-parameter state
  dicts), so ``torch.load(weights_only=True)`` reads it;
* ``.bluefog_complete``, the completion marker, written last: a directory
  without it was interrupted mid-write and is never restored from, and
  ``keep`` pruning never deletes it.

``restore`` without a template gives the snapshot (CPU tensors); with a
template (a live tree of the same shape: a fresh trainer's params and
``DecentralizedState`` with its ``torch.optim`` optimizer) the
checkpoint is copied into the template's own tensors (its optimizer's
state in place, NamedTuples and counters rebuilt) and the template
returned.  After a restore on another world size,
:func:`resize_distributed` and ``utils.utility.broadcast_parameters``
re-seed the ranks.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .utils.snapshot import live_tensors, restore_into, snapshot

__all__ = ["save", "restore", "restore_latest", "latest_step", "all_steps",
           "is_complete", "resize_distributed", "AsyncSaver",
           "save_for_serving", "load_for_serving", "all_serving_steps",
           "latest_serving_step", "FORMAT"]

FORMAT = "bluefog-torch-checkpoint-1"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_SERVING_DIR = re.compile(r"^serving_step_(\d+)$")
_COMPLETE_MARKER = ".bluefog_complete"


def _process() -> Tuple[int, int]:
    """``(process, world)`` of the live context (``(0, 1)`` without)."""
    from .parallel import context as _ctx
    if not _ctx.is_initialized():
        return 0, 1
    ctx = _ctx.get_context()
    return ctx.process, ctx.world


def _state_file(path: str) -> str:
    p, w = _process()
    name = "state.pt" if w == 1 else f"state_{p}-of-{w}.pt"
    return os.path.join(path, name)


def _barrier() -> None:
    if _process()[1] > 1:
        import torch.distributed as dist
        dist.barrier()


def _mark_complete(path: str) -> None:
    """Stamp a finished checkpoint, after every process wrote its file
    (process 0 only: shared directory)."""
    _barrier()
    if _process()[0] != 0:
        return
    with open(os.path.join(path, _COMPLETE_MARKER), "w") as f:
        f.write("complete\n")


def is_complete(path: str) -> bool:
    """True iff ``path`` is a fully-written checkpoint directory."""
    return os.path.exists(os.path.join(path, _COMPLETE_MARKER))


# ---------------------------------------------------------------------------
# The format: a host snapshot of the tree
# ---------------------------------------------------------------------------

def _write(path: str, doc: dict) -> None:
    os.makedirs(path, exist_ok=True)
    target = _state_file(path)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(doc, tmp)
    os.replace(tmp, target)


def _check_leaves(snap: Any) -> None:
    """Refuse a leaf ``torch.load(weights_only=True)`` could not read."""
    if isinstance(snap, dict):
        for v in snap.values():
            _check_leaves(v)
    elif isinstance(snap, (list, tuple)):
        for v in snap:
            _check_leaves(v)
    elif not (snap is None or isinstance(
            snap, (torch.Tensor, bool, int, float, str))):
        raise TypeError(
            f"cannot checkpoint a leaf of type {type(snap).__name__}")


def _snapshot(state: Any, pinned: bool = False) -> dict:
    """The checkpoint document: a completed host copy of ``state`` (not
    views of live tensors, which the next train step overwrites)."""
    snap = snapshot(state, pin=pinned)
    _check_leaves(snap)
    if pinned and any(t.is_cuda for t in live_tensors(state)):
        torch.cuda.synchronize()
    return {"format": FORMAT, "state": snap}


def save(directory: str, state: Any, step: int, *,
         keep: Optional[int] = None) -> str:
    """Write ``state`` (any tree of tensors) as ``<directory>/step_<step>``.

    ``keep`` prunes to the newest N complete step directories (None =
    keep all; must be >= 1 otherwise).  Returns the checkpoint path."""
    if keep is not None and keep < 1:
        raise ValueError(
            f"keep must be >= 1 (got {keep}); use keep=None to keep all")
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{int(step)}")
    _write(path, _snapshot(state))
    _mark_complete(path)
    # Prune from one process only: only *complete* checkpoints count
    # against ``keep``, and only complete ones are deleted (an unmarked
    # directory might be another save still in flight).
    if keep is not None and _process()[0] == 0:
        steps = sorted(all_steps(directory))
        for s in steps[:-keep]:
            _rmtree(os.path.join(directory, f"step_{s}"))
    return path


def restore(path: str, template: Optional[Any] = None) -> Any:
    """Load a checkpoint: the host snapshot, or with ``template`` (a live
    tree of the same shape, e.g. a fresh trainer's params and state) the
    template with the checkpoint written into it (see the module
    docstring)."""
    doc = torch.load(_state_file(path), map_location="cpu",
                     weights_only=True)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint "
                         f"(format {doc.get('format')!r})")
    if template is None:
        return doc["state"]
    out = restore_into(template, doc["state"])
    if any(t.is_cuda for t in live_tensors(template)):
        torch.cuda.synchronize()
    return out


def all_steps(directory: str, include_incomplete: bool = False):
    """Sorted step numbers of the checkpoints in ``directory``; partially
    written ``step_*`` directories (no completion marker) are skipped
    unless ``include_incomplete=True``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_DIR.match(name)
        if m and (include_incomplete
                  or is_complete(os.path.join(directory, name))):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """Newest *complete* checkpoint step (None when there is none)."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_latest(
    directory: str, template: Optional[Any] = None,
) -> Tuple[Optional[Any], Optional[int]]:
    """Load the newest *complete* checkpoint in ``directory``, past any
    partially-written one (a respawned rank never resumes from the save
    its predecessor died in).  ``(None, None)`` when nothing complete
    exists."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(os.path.join(directory, f"step_{step}"), template), step


# ---------------------------------------------------------------------------
# Serving snapshots: params only, no optimizer/comm state
# ---------------------------------------------------------------------------

def save_for_serving(directory: str, params: Any, step: int) -> str:
    """Write a params-only snapshot as ``<directory>/serving_step_<step>``.
    A training tuple ``(params, opt_state[, step])`` or a dict with an
    ``opt_state`` / ``comm`` / ``dstate`` key is refused, so a serve fleet
    never restores optimizer slots as weights."""
    if isinstance(params, tuple) and len(params) in (2, 3):
        raise ValueError(
            "save_for_serving takes the parameter tree only; this looks "
            "like a (params, opt_state[, step]) training tuple — pass "
            "checkpoint.save for full training state")
    if isinstance(params, dict) and ({"opt_state", "comm", "dstate"}
                                     & set(params.keys())):
        raise ValueError(
            "save_for_serving takes the parameter tree only (found "
            "optimizer/comm state keys); a serving snapshot must not "
            "carry training state")
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"serving_step_{int(step)}")
    _write(path, _snapshot(params))
    _mark_complete(path)
    return path


def all_serving_steps(directory: str, include_incomplete: bool = False):
    """Sorted step numbers of *complete* serving snapshots in ``directory``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _SERVING_DIR.match(name)
        if m and (include_incomplete
                  or is_complete(os.path.join(directory, name))):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_serving_step(directory: str) -> Optional[int]:
    steps = all_serving_steps(directory)
    return steps[-1] if steps else None


def load_for_serving(
    directory: str, template: Optional[Any] = None,
) -> Tuple[Optional[Any], Optional[int]]:
    """Load the newest *complete* serving snapshot: ``(params, step)``,
    torn directories skipped; ``(None, None)`` when nothing complete
    exists."""
    step = latest_serving_step(directory)
    if step is None:
        return None, None
    path = os.path.join(directory, f"serving_step_{step}")
    return restore(path, template), step


class AsyncSaver:
    """Non-blocking checkpointing: ``save`` returns once the state is
    snapshotted to host memory; serialization and IO run on a background
    thread while training continues.

    The port's train step overwrites its params and optimizer state in
    place, so the snapshot is a completed device-to-pinned-host copy (one
    ``torch.cuda.synchronize`` after the copies) before ``save`` returns;
    only ``torch.save`` runs in the background.  A new save first waits
    for the previous one; a background failure surfaces at the next
    ``save`` / ``wait``, and the completion marker lands only on a
    directory whose write finished.

    Usage::

        saver = checkpoint.AsyncSaver()
        for step in ...:
            ...
            if step % k == 0:
                saver.save(directory, state, step)
        saver.close()         # drain before exiting
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: List[str] = []   # written but not yet marked

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _check_for_errors(self) -> None:
        """Raise a background save's failure on the caller's thread (its
        directory stays unmarked)."""
        err, self._error = self._error, None
        if err is not None:
            self._pending.clear()
            raise RuntimeError(f"background checkpoint save failed: "
                               f"{type(err).__name__}: {err}") from err

    def _finalize_pending(self) -> None:
        for path in self._pending:
            if os.path.isdir(path):
                _mark_complete(path)
        self._pending.clear()

    def save(self, directory: str, state: Any, step: int) -> str:
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"step_{int(step)}")
        # serialize with the previous save, surface its errors HERE, and
        # only then mark it complete: readers never see a premature marker
        self._join()
        self._check_for_errors()
        self._finalize_pending()
        doc = _snapshot(state, pinned=torch.cuda.is_available())

        def run():
            try:
                _write(path, doc)
            except BaseException as e:         # surfaced at save / wait
                self._error = e

        self._pending.append(path)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until every in-flight save is on disk (raising if a
        background save failed), then mark it complete."""
        self._join()
        self._check_for_errors()
        self._finalize_pending()

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def resize_distributed(state: Any, new_size: int, *,
                       mode: str = "slice") -> Any:
    """Re-target a distributed tree (leading rank axis) to a new world
    size: a checkpoint taken on n ranks resumes on m.  Modes (JAX's):

    - ``"slice"`` — shrink keeps the first m ranks' states; grow gives
      rank r the state of rank ``r % n``;
    - ``"mean"`` — the f32 mean over the old rank axis, replicated
      (integer and bool leaves take rank 0's);
    - ``"rank0"`` — rank 0's state, replicated.

    Works on the host: every leaf comes back as a CPU tensor (0-dim
    leaves pass through).  Strategy state whose shape depends on the
    world size must be re-initialized on the new world instead."""
    if mode not in ("slice", "mean", "rank0"):
        raise ValueError(f"unknown resize mode {mode!r}")

    def leaf(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        if x.ndim == 0:            # global scalars (step counters) pass
            return x
        n = x.shape[0]
        if mode == "mean":
            if x.dtype.is_floating_point:
                # numpy's float32 mean, as the JAX function computes it
                core = torch.from_numpy(
                    x.float().numpy().mean(axis=0)).to(x.dtype)
            else:
                core = x[0]
            return core[None].expand((new_size,) + tuple(x.shape[1:])) \
                .clone()
        if mode == "rank0":
            return x[:1].expand((new_size,) + tuple(x.shape[1:])).clone()
        return x[torch.arange(new_size) % n].clone()

    def walk(t):
        if isinstance(t, dict):
            return type(t)((k, walk(v)) for k, v in t.items())
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, tuple):
            vals = [walk(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return leaf(t)

    return walk(state)


def _rmtree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
