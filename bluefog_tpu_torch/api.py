"""Blocking op API over stacked distributed tensors (the part of
``bluefog_tpu/api.py`` the single-process context serves).

A *distributed tensor* is ``[size, ...]``: ``x[i]`` is rank i's value,
all of them on the context's device.  CUDA work is asynchronous, so
:func:`synchronize` and :func:`hard_sync` give the reference's handle
semantics without a handle table.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .fusion import tree_flatten
from .ops import collectives as _coll
from .parallel import context as _ctx
from .schedule import CommSchedule, compile_from_weights

__all__ = ["neighbor_allreduce", "barrier", "synchronize", "hard_sync",
           "resolve_schedule", "shard_distributed"]


def _check_distributed(x: torch.Tensor, n: int) -> None:
    if x.shape[0] != n:
        raise ValueError(
            f"distributed tensor must have leading rank axis of size {n}, "
            f"got shape {tuple(x.shape)}")


def shard_distributed(x) -> torch.Tensor:
    """Place a distributed tensor (``[size, ...]``) on the context's
    device."""
    ctx = _ctx.get_context()
    x = torch.as_tensor(x)
    _check_distributed(x, ctx.size)
    return x.to(ctx.device)


def resolve_schedule(
    self_weight: Optional[Union[float, Sequence[float]]] = None,
    src_weights: Optional[Sequence[Dict[int, float]]] = None,
    dst_weights: Optional[Sequence[Union[Dict[int, float], List[int]]]] = None,
    schedule: Optional[CommSchedule] = None,
    *,
    size: Optional[int] = None,
    default_schedule=None,
) -> CommSchedule:
    """Resolve neighbor-op weights to a compiled schedule.

    Policy (mirroring the reference):
      * nothing given -> the static topology schedule (topology weights when
        the topology was set ``is_weighted``, else uniform 1/(in_degree+1));
      * ``schedule`` given -> used as-is (the idiomatic dynamic-topology path:
        precompile with :func:`bluefog_tpu_torch.schedule.compile_dynamic_schedules`);
      * explicit weights -> ``self_weight`` (scalar or per-rank), per-rank
        ``src_weights`` dicts, optional per-rank ``dst_weights`` (lists mean
        scale 1).  Both of ``self_weight``/``src_weights`` must be present
        together, and ``dst_weights`` requires both — same contract as the
        reference.
    """
    if schedule is not None:
        if self_weight is not None or src_weights is not None or dst_weights is not None:
            raise ValueError("pass either a schedule or explicit weights, not both")
        return schedule
    if self_weight is None and src_weights is None:
        if dst_weights is not None:
            raise ValueError(
                "self_weight and src_weights must be given when dst_weights is used")
        return (default_schedule or _ctx.static_schedule)()
    if self_weight is None or src_weights is None:
        raise ValueError(
            "self_weight and src_weights must be presented at the same time")

    n = _ctx.size() if size is None else size
    if np.isscalar(self_weight):
        self_weights = [float(self_weight)] * n
    else:
        self_weights = [float(w) for w in self_weight]
    if isinstance(src_weights, dict):
        raise ValueError(
            "src_weights must be a per-rank sequence of {src_rank: weight} "
            "dicts (the SPMD program needs every rank's weights)")
    src_list = [dict(d) for d in src_weights]

    dst_list = None
    if dst_weights is not None:
        dst_list = []
        for d in dst_weights:
            if isinstance(d, dict):
                dst_list.append({int(k): float(v) for k, v in d.items()})
            else:
                dst_list.append({int(k): 1.0 for k in d})
    return compile_from_weights(n, self_weights, src_list, dst_list)


def neighbor_allreduce(
    x: torch.Tensor,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    schedule: Optional[CommSchedule] = None,
    wire: Optional[str] = None,
    concurrent: Optional[bool] = None,
) -> torch.Tensor:
    """Weighted neighbor averaging of each rank's row (the flagship op;
    reference: ``bf.neighbor_allreduce``) under the schedule
    :func:`resolve_schedule` picks.  Wire codecs are not ported yet and
    raise."""
    ctx = _ctx.get_context()
    _check_distributed(x, ctx.size)
    sched = resolve_schedule(self_weight, src_weights, dst_weights, schedule)
    return _coll.neighbor_allreduce(x, sched, wire=wire,
                                    concurrent=concurrent)


def synchronize(x):
    """Wait until the device work producing ``x`` is done; returns ``x``
    (reference: ``bf.synchronize(handle)``)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_flatten(x)[0]):
        torch.cuda.synchronize()
    return x


def hard_sync(x):
    """Device-to-host barrier: returns ``x`` after every computation
    producing it has finished.  On the card: ``torch.cuda.synchronize()``
    and one element read to the host, which cannot complete before the
    work that wrote it.  Use it around timed sections."""
    leaves = [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    if leaves and leaves[-1].numel():
        last = leaves[-1]
        last[(0,) * last.ndim].item()
    return x


def barrier() -> None:
    """Wait for all pending work on the context's device (reference:
    ``bf.barrier``)."""
    if _ctx.get_context().device.type == "cuda":
        torch.cuda.synchronize()
