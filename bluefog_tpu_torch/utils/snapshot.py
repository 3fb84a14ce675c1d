"""The state a train step returns, as a tree: its tensors, a host copy of
it, and that copy written back.

The port's step updates its params, its optimizer's per-parameter state
(a ``torch.optim.Optimizer`` inside ``DecentralizedState``) and its
carries in place, so a copy taken for a rollback or a checkpoint must
be a completed copy, never a view, and a restore writes into the live
tensors.  Trees are dicts, lists, tuples (NamedTuples too), dataclasses,
optimizers, tensors and plain values; a snapshot holds only dicts,
lists, tuples, tensors and plain values, so ``torch.load(...,
weights_only=True)`` reads one back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["live_tensors", "snapshot", "snapshot_tensors", "restore_into"]


def _fields(x):
    """A dataclass instance's fields (None for anything else)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.fields(x)
    return None


def live_tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor of ``tree`` in a fixed order: dict values by sorted
    key, list and tuple items, dataclass fields, and each optimizer's
    per-parameter state."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.optim.Optimizer):
            for group in x.param_groups:
                for p in group["params"]:
                    st = x.state.get(p)
                    if st:
                        walk(st)
        elif _fields(x) is not None:
            for f in _fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


def snapshot(tree: Any, pin: bool = False,
             spare: Optional[List[torch.Tensor]] = None) -> Any:
    """A host copy of ``tree``: each tensor copied to a CPU tensor (pinned
    and asynchronous from a card with ``pin``: synchronize before reading
    it; into ``spare``'s buffers, consumed in order, where shape and dtype
    match), numpy arrays as tensors, containers rebuilt (a NamedTuple as
    a tuple, a dataclass as a dict of its fields), an optimizer as the
    list of its per-parameter state dicts (None where a slot has none),
    other leaves as they are."""
    spare = [] if spare is None else spare

    def cap(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            t = x.detach()
            host = spare.pop(0) if spare else None
            if host is None or host.shape != t.shape or \
                    host.dtype != t.dtype:
                host = torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=pin and t.is_cuda)
            host.copy_(t, non_blocking=t.is_cuda)
            return host
        if isinstance(x, dict):
            return {k: cap(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cap(v) for v in x]
        if isinstance(x, tuple):
            return tuple(cap(v) for v in x)
        if isinstance(x, torch.optim.Optimizer):
            return [None if not x.state.get(p) else
                    {k: cap(v) for k, v in x.state[p].items()}
                    for group in x.param_groups for p in group["params"]]
        if _fields(x) is not None:
            return {f.name: cap(getattr(x, f.name)) for f in _fields(x)}
        return x

    return cap(tree)


def snapshot_tensors(snap: Any) -> List[torch.Tensor]:
    """A snapshot's tensors in :func:`snapshot`'s order (the buffers a
    later snapshot may reuse)."""
    if isinstance(snap, torch.Tensor):
        return [snap]
    if isinstance(snap, dict):
        return [t for v in snap.values() for t in snapshot_tensors(v)]
    if isinstance(snap, (list, tuple)):
        return [t for v in snap for t in snapshot_tensors(v)]
    return []


def restore_into(live: Any, snap: Any) -> Any:
    """Write a :func:`snapshot` into ``live`` (a tree of the same shape)
    and return it: every tensor by ``copy_`` (the references its holders
    keep stay valid), an optimizer's state in place (a state it lacks is
    created on its parameter's device), immutable containers and plain
    values rebuilt from the snapshot's."""
    if isinstance(live, torch.Tensor):
        with torch.no_grad():
            live.copy_(snap, non_blocking=live.is_cuda)
        return live
    if isinstance(live, np.ndarray):
        return snap.numpy().astype(live.dtype)
    if isinstance(live, dict):
        return type(live)((k, restore_into(live[k], snap[k]))
                          for k in live)
    if isinstance(live, list):
        live[:] = [restore_into(v, s) for v, s in zip(live, snap)]
        return live
    if isinstance(live, tuple):
        vals = [restore_into(v, s) for v, s in zip(live, snap)]
        return type(live)(*vals) if hasattr(live, "_fields") else tuple(vals)
    if isinstance(live, torch.optim.Optimizer):
        slots = [p for g in live.param_groups for p in g["params"]]
        if len(slots) != len(snap):
            raise ValueError(
                f"the snapshot holds optimizer state for {len(snap)} "
                f"parameters, the live optimizer has {len(slots)}")
        for p, st in zip(slots, snap):
            if st is None:
                live.state.pop(p, None)
                continue
            cur = live.state[p]
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and isinstance(
                        cur.get(k), torch.Tensor):
                    restore_into(cur[k], v)
                elif isinstance(v, torch.Tensor):
                    cur[k] = v.to(p.device, copy=True)
                else:
                    cur[k] = v
        return live
    if _fields(live) is not None:
        return dataclasses.replace(live, **{
            f.name: restore_into(getattr(live, f.name), snap[f.name])
            for f in _fields(live)})
    return snap
