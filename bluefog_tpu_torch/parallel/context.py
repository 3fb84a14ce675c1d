"""The process context: stacked ranks on one device and their virtual
topology (the single-process part of ``bluefog_tpu/parallel/context.py``).

The JAX context builds a mesh over the devices, one rank each.  Here the
ranks are stacked on dim 0 of every tensor on one device (the layout of
:mod:`bluefog_tpu_torch.ops.collectives`), so ``init`` takes their number
as ``size``.  The topology, its weights and its compiled schedule live in
one process-level context, as in JAX, and the accessors take the rank as
an argument (host code sees every rank).

Not ported yet (ROADMAP queue 1, item 5): the ``torch.distributed``
backend (one process per rank), machine topologies, dynamic topologies
and the ``round_parallel`` / ``dcn_wire`` / ``async_gossip`` knobs.
``init`` refuses a launch with ``WORLD_SIZE`` > 1.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import networkx as nx
import torch

from .. import topology as topo_util
from ..device import resolve_device
from ..schedule import CommSchedule, compile_topology

__all__ = ["BlueFogTorchContext", "init", "shutdown", "is_initialized",
           "get_context", "size", "load_topology", "is_topology_weighted",
           "set_topology", "in_neighbor_ranks", "out_neighbor_ranks",
           "static_schedule"]

_context: Optional["BlueFogTorchContext"] = None


@dataclass
class BlueFogTorchContext:
    size: int                                 # stacked ranks
    device: torch.device
    topology: nx.DiGraph
    topology_weighted: bool = False
    _sched: Optional[CommSchedule] = None

    def static_schedule(self) -> CommSchedule:
        if self._sched is None:
            self._sched = compile_topology(self.topology,
                                           weighted=self.topology_weighted)
        return self._sched


def init(topology_fn: Optional[Callable[[], nx.DiGraph]] = None,
         is_weighted: bool = False, *, size: Optional[int] = None,
         device: Optional[Union[str, torch.device]] = None
         ) -> BlueFogTorchContext:
    """Initialize the context (reference: ``bf.init``).

    Args:
      topology_fn: zero-arg callable returning the virtual topology;
        defaults to ``ExponentialGraph(size)`` like the reference.
      is_weighted: use the topology's mixing weights for neighbor averaging
        instead of the uniform ``1/(in_degree+1)`` default.
      size: the number of ranks stacked on the device (default 1).
      device: where the ranks live; CUDA unless the caller asks for another
        device (a missing card raises).
    """
    global _context
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise ValueError(
            f"WORLD_SIZE={world}: bluefog_tpu_torch stacks every rank on "
            "one device in one process; the torch.distributed backend (one "
            "process per rank) is not ported yet (ROADMAP queue 1, item 5)")
    n = 1 if size is None else int(size)
    if n < 1:
        raise ValueError(f"size must be at least 1, got {n}")
    dev = resolve_device(device)
    topo = topology_fn() if topology_fn is not None \
        else topo_util.ExponentialGraph(n)
    _context = BlueFogTorchContext(n, dev, _check_topology(topo, n),
                                   is_weighted)
    return _context


def _check_topology(topo: nx.DiGraph, size: int) -> nx.DiGraph:
    if topo.number_of_nodes() != size:
        raise ValueError(
            f"topology has {topo.number_of_nodes()} nodes but the mesh has "
            f"{size} devices")
    return topo


def get_context() -> BlueFogTorchContext:
    if _context is None:
        raise RuntimeError(
            "bluefog_tpu is not initialized; call bf.init() first")
    return _context


def shutdown() -> None:
    """Drop the context (reference: ``bf.shutdown``)."""
    global _context
    _context = None


def is_initialized() -> bool:
    return _context is not None


def size() -> int:
    return get_context().size


def load_topology() -> nx.DiGraph:
    return get_context().topology


def is_topology_weighted() -> bool:
    return get_context().topology_weighted


def set_topology(topology: Optional[nx.DiGraph] = None,
                 is_weighted: bool = False) -> bool:
    """Replace the virtual topology (reference: ``basics.py:311-419``);
    ``None`` is ``ExponentialGraph(size)``.  The cached schedule is
    dropped."""
    ctx = get_context()
    if topology is None:
        topology = topo_util.ExponentialGraph(ctx.size)
    ctx.topology = _check_topology(topology, ctx.size)
    ctx.topology_weighted = is_weighted
    ctx._sched = None
    return True


def in_neighbor_ranks(rank: int) -> List[int]:
    """Sorted in-neighbors of ``rank`` in the current topology."""
    return topo_util.GetInNeighbors(get_context().topology, rank)


def out_neighbor_ranks(rank: int) -> List[int]:
    return topo_util.GetOutNeighbors(get_context().topology, rank)


def static_schedule() -> CommSchedule:
    """The current topology compiled to gossip rounds (cached)."""
    return get_context().static_schedule()
