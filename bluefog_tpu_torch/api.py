"""Blocking op API over stacked distributed tensors (counterpart of
``bluefog_tpu/api.py``).

A *distributed tensor* is ``[size, ...]``: ``x[i]`` is rank i's value.
In one process every row is on the context's device.  Across processes
(torchrun) each process passes its block of the rows, ``[size / world,
...]`` (:func:`shard_distributed` cuts it from a global tensor), and gets
its block of the result, as each JAX process holds its addressable
shards.  CUDA work is asynchronous, so :func:`synchronize`,
:func:`hard_sync` and :func:`poll` give the reference's handle semantics
without a handle table.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .fusion import tree_flatten
from .ops import collectives as _coll
from .parallel import context as _ctx
from .schedule import CommSchedule, compile_from_weights

__all__ = ["allreduce", "allgather", "ragged_allgather", "broadcast",
           "neighbor_allreduce", "neighbor_allgather",
           "ragged_neighbor_allgather", "pair_gossip",
           "hierarchical_neighbor_allreduce", "barrier", "synchronize",
           "poll", "hard_sync", "resolve_schedule", "shard_distributed"]


def _check_distributed(x: torch.Tensor, n: int) -> None:
    """``x`` holds this process's rows of ``n`` ranks (all of them in one
    process)."""
    ctx = _ctx._context
    rows = ctx.rows if ctx is not None and ctx.size == n else n
    if x.shape[0] != rows:
        raise ValueError(
            f"distributed tensor must have leading rank axis of size {rows}, "
            f"got shape {tuple(x.shape)}")


def shard_distributed(x) -> torch.Tensor:
    """Place a distributed tensor (``[size, ...]``, every rank's row) on
    the context's device: the whole of it in one process, this process's
    block of rows across processes."""
    ctx = _ctx.get_context()
    x = torch.as_tensor(x)
    if x.shape[0] != ctx.size:
        raise ValueError(
            f"distributed tensor must have leading rank axis of size "
            f"{ctx.size}, got shape {tuple(x.shape)}")
    return x[ctx.first_rank:ctx.first_rank + ctx.rows].to(ctx.device)


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
    step: Optional[int] = None,
    wire: Optional[str] = None,
    concurrent: Optional[bool] = None,
) -> torch.Tensor:
    """Weighted neighbor averaging of each rank's row (the flagship op;
    reference: ``bf.neighbor_allreduce``) under the schedule
    :func:`resolve_schedule` picks.  With a dynamic topology installed
    (``set_dynamic_topology``) pass the iteration counter as ``step``: the
    period's schedule ``step % period`` is used.  ``wire`` compresses the
    gossiped bytes (``"bf16"``/``"int8"``/``"fp8"``, ``"@B"`` blocks)."""
    ctx = _ctx.get_context()
    _check_distributed(x, ctx.size)
    dyn = ctx.dynamic_schedules
    if (dyn and schedule is None and self_weight is None
            and src_weights is None and dst_weights is None):
        if step is None:
            raise ValueError(
                "a dynamic topology is installed; pass step= (the iteration "
                "counter) so the period's schedule can be selected")
        schedule = dyn[int(step) % len(dyn)]
    sched = resolve_schedule(self_weight, src_weights, dst_weights, schedule)
    return _coll.neighbor_allreduce(x, sched, wire=wire,
                                    concurrent=concurrent)


def neighbor_allgather(
    x: torch.Tensor,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    schedule: Optional[CommSchedule] = None,
) -> torch.Tensor:
    """Concatenate in-neighbor slices along each rank's first value dim.

    Output shape ``[n, max_in_degree * d0, ...]``; slots beyond a rank's
    in-degree are zero (regular topologies fill every slot).  Reference:
    ``bf.neighbor_allgather`` (``mpi_ops.py:396-476``).
    """
    ctx = _ctx.get_context()
    _check_distributed(x, ctx.size)
    if x.ndim < 2:
        raise ValueError("neighbor_allgather needs a per-rank first dimension")
    sched = resolve_schedule(self_weight, src_weights, dst_weights, schedule)
    return _coll.neighbor_allgather(x, sched)


def ragged_neighbor_allgather(
    x: torch.Tensor,
    lengths,
    *,
    self_weight=None,
    src_weights=None,
    dst_weights=None,
    schedule: Optional[CommSchedule] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbor allgather of per-rank slices with different valid first
    dims: ``x`` is ``[n, max_d0, ...]`` with rank r's valid rows in
    ``x[r, :lengths[r]]``.  Returns ``(gathered [n, max_in_degree *
    max_d0, ...], lengths [n, max_in_degree])``: slot k of rank r holds
    the padded slice and valid length of its k-th sorted in-neighbor.
    The length rides in the same buffer as the data (one collective
    chain)."""
    ctx = _ctx.get_context()
    _check_distributed(x, ctx.size)
    if x.ndim < 2:
        raise ValueError("ragged_neighbor_allgather needs a per-rank first "
                         "dimension")
    lengths = torch.as_tensor(lengths, dtype=torch.int32).reshape(
        x.shape[0]).to(x.device)
    sched = resolve_schedule(self_weight, src_weights, dst_weights, schedule)
    return _coll.ragged_neighbor_allgather(x, lengths, sched)


def allreduce(x: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Global (weighted-uniform) allreduce. Reference: ``bf.allreduce``."""
    _check_distributed(x, _ctx.get_context().size)
    return _coll.allreduce(x, average=average)


def allgather(x: torch.Tensor) -> torch.Tensor:
    """All ranks receive the concatenation of all slices: ``[n, n*d0, ...]``."""
    _check_distributed(x, _ctx.get_context().size)
    if x.ndim < 2:
        raise ValueError("allgather needs a per-rank first dimension")
    return _coll.allgather(x)


def ragged_allgather(x: torch.Tensor, lengths
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allgather of per-rank slices with *different* valid first dims:
    ``x`` is ``[n, max_d0, ...]`` with rank r's valid data in ``x[r,
    :lengths[r]]``.  Returns ``(gathered, lengths)``: ``gathered[r]`` is
    ``[n * max_d0, ...]`` (every rank's padded slice, in rank order) and
    ``lengths`` every rank's ``[n]`` lengths, so each rank can slice out
    the valid prefixes."""
    _check_distributed(x, _ctx.get_context().size)
    lengths = torch.as_tensor(lengths, dtype=torch.int32).reshape(
        x.shape[0], 1).to(x.device)
    return allgather(x), allgather(lengths)


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank's slice becomes root's slice. Reference: ``bf.broadcast``."""
    _check_distributed(x, _ctx.get_context().size)
    return _coll.broadcast(x, root_rank)


def pair_gossip(
    x: torch.Tensor,
    partners: Sequence[int],
    *,
    self_weight: float = 0.5,
    pair_weight: float = 0.5,
) -> torch.Tensor:
    """Paired exchange-and-average. Reference: ``bf.pair_gossip``.
    ``partners`` must be an involution; self-paired ranks keep their
    value."""
    _check_distributed(x, _ctx.get_context().size)
    return _coll.pair_gossip(x, partners, self_weight=self_weight,
                             pair_weight=pair_weight)


def hierarchical_neighbor_allreduce(
    x: torch.Tensor,
    *,
    self_weight=None,
    src_machine_weights=None,
    dst_machine_weights=None,
    schedule: Optional[CommSchedule] = None,
    wire: Optional[str] = None,
    concurrent: Optional[bool] = None,
) -> torch.Tensor:
    """Machine-level neighbor averaging (reference: ``mpi_ops.py:848-864``):
    the mean over each machine's local ranks, then gossip over the machine
    topology, the result replicated within each machine.  Machine weights
    resolve as :func:`resolve_schedule` does at machine scope.  ``wire``
    compresses the machine hop only (default: ``set_dcn_wire`` /
    ``BLUEFOG_DCN_WIRE``; ``"off"`` forces full width)."""
    ctx = _ctx.get_context()
    _check_distributed(x, ctx.size)
    sched = resolve_schedule(
        self_weight, src_machine_weights, dst_machine_weights, schedule,
        size=ctx.machine_size, default_schedule=_ctx.machine_schedule)
    return _coll.hierarchical_neighbor_allreduce(x, sched, wire=wire,
                                                 concurrent=concurrent)


def poll(x) -> bool:
    """True if the device work producing ``x`` has completed (reference:
    ``bf.poll``): an event recorded on the current stream, queried.  CPU
    work is done when the call returns, so there it is True."""
    leaves = [t for t in tree_flatten(x)[0]
              if isinstance(t, torch.Tensor) and t.is_cuda]
    if not leaves:
        return True
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaves[0].device))
    return event.query()


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
    """Wait for all pending work on the context's device, and across
    processes for every process to reach the barrier (reference:
    ``bf.barrier``).  The JAX function only drains its host queue: every
    compiled program there is already a global synchronization point.
    Several processes run no such single program, so here the process
    group's ``barrier`` does that part."""
    ctx = _ctx.get_context()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    if ctx.world > 1:
        import torch.distributed as dist
        dist.barrier()
