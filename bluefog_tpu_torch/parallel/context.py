"""The process context: stacked ranks on one device and their virtual
topology (the single-process part of ``bluefog_tpu/parallel/context.py``).

The JAX context builds a mesh over the devices, one rank each.  Here the
ranks are stacked on dim 0 of every tensor on one device (the layout of
:mod:`bluefog_tpu_torch.ops.collectives`), so ``init`` takes their number
as ``size``.  The topology, its weights and its compiled schedule live in
one process-level context, as in JAX, and the accessors take the rank as
an argument (host code sees every rank).

The machine level (``nodes_per_machine`` ranks a machine, machine-major
on dim 0) carries the machine topology hierarchical gossip runs over, and
an installed dynamic topology (:func:`set_dynamic_topology`) is the
schedule list the ``communication_type`` factories pick up.

Not ported yet (ROADMAP queue 1, item 5): the ``torch.distributed``
backend (one process per rank), the automatic hierarchy, and the
``round_parallel`` / ``async_gossip`` knobs.  ``init`` refuses a launch
with ``WORLD_SIZE`` > 1.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import networkx as nx
import torch

from .. import topology as topo_util
from ..device import resolve_device
from ..schedule import (CommSchedule, compile_dynamic_schedules,
                        compile_topology)
from ..utils import flight as _flight
from ..utils import metrics as _metrics
from ..utils import tracing as _tracing

__all__ = ["BlueFogTorchContext", "init", "shutdown", "is_initialized",
           "get_context", "size", "load_topology", "is_topology_weighted",
           "set_topology", "in_neighbor_ranks", "out_neighbor_ranks",
           "static_schedule", "local_size", "machine_size",
           "load_machine_topology", "is_machine_topology_weighted",
           "set_machine_topology", "machine_rank", "local_rank",
           "in_neighbor_machine_ranks", "out_neighbor_machine_ranks",
           "machine_schedule", "set_dynamic_topology",
           "clear_dynamic_topology", "dynamic_schedules", "set_dcn_wire",
           "dcn_wire"]

_context: Optional["BlueFogTorchContext"] = None


@dataclass
class BlueFogTorchContext:
    size: int                                 # stacked ranks
    device: torch.device
    topology: nx.DiGraph
    topology_weighted: bool = False
    nodes_per_machine: int = 1
    machine_topology: Optional[nx.DiGraph] = None
    machine_topology_weighted: bool = False
    dynamic_schedules: Optional[List[CommSchedule]] = None
    # process default for the machine hop's wire codec of hierarchical
    # gossip (None = defer to BLUEFOG_DCN_WIRE; "off" forces full width)
    dcn_wire: Optional[str] = None
    _sched: Optional[CommSchedule] = None
    _machine_sched: Optional[CommSchedule] = None

    @property
    def machine_size(self) -> int:
        return self.size // self.nodes_per_machine

    def static_schedule(self) -> CommSchedule:
        if self._sched is None:
            self._sched = compile_topology(self.topology,
                                           weighted=self.topology_weighted)
        return self._sched

    def machine_schedule(self) -> CommSchedule:
        if self.machine_topology is None:
            raise RuntimeError("no machine topology set; call "
                               "bf.set_machine_topology()")
        if self._machine_sched is None:
            self._machine_sched = compile_topology(
                self.machine_topology,
                weighted=self.machine_topology_weighted)
        return self._machine_sched


def init(topology_fn: Optional[Callable[[], nx.DiGraph]] = None,
         is_weighted: bool = False, *, size: Optional[int] = None,
         device: Optional[Union[str, torch.device]] = None,
         nodes_per_machine: Optional[int] = None) -> BlueFogTorchContext:
    """Initialize the context (reference: ``bf.init``).

    Args:
      topology_fn: zero-arg callable returning the virtual topology;
        defaults to ``ExponentialGraph(size)`` like the reference.
      is_weighted: use the topology's mixing weights for neighbor averaging
        instead of the uniform ``1/(in_degree+1)`` default.
      size: the number of ranks stacked on the device (default 1).
      device: where the ranks live; CUDA unless the caller asks for another
        device (a missing card raises).
      nodes_per_machine: ranks a "machine" for hierarchical ops (default
        ``BLUEFOG_NODES_PER_MACHINE``, else every rank on one machine, as
        the JAX context in one process); ``size`` must divide by it.
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
    if nodes_per_machine is None:
        env = os.environ.get("BLUEFOG_NODES_PER_MACHINE", "").strip()
        nodes_per_machine = int(env) if env else n
    if n % nodes_per_machine != 0:
        raise ValueError(f"device count {n} not divisible by "
                         f"nodes_per_machine {nodes_per_machine}")
    dev = resolve_device(device)
    # the registries' exporters, as JAX's init arms them: BLUEFOG_METRICS /
    # BLUEFOG_METRICS_PORT, BLUEFOG_FLIGHT_DIR / BLUEFOG_FLIGHT_EVENTS and
    # BLUEFOG_TRACE
    _metrics.maybe_start_from_env()
    _flight.maybe_enable_from_env()
    _tracing.maybe_enable_from_env()
    _flight.record("lifecycle", name="init", devices=n)
    topo = topology_fn() if topology_fn is not None \
        else topo_util.ExponentialGraph(n)
    _context = BlueFogTorchContext(n, dev, _check_topology(topo, n),
                                   is_weighted,
                                   nodes_per_machine=int(nodes_per_machine))
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


def local_size() -> int:
    return get_context().nodes_per_machine


def machine_size() -> int:
    return get_context().machine_size


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


def load_machine_topology() -> Optional[nx.DiGraph]:
    return get_context().machine_topology


def is_machine_topology_weighted() -> bool:
    return get_context().machine_topology_weighted


def set_machine_topology(topology: nx.DiGraph,
                         is_weighted: bool = False) -> bool:
    """Set the machine-level topology for hierarchical ops (reference:
    ``basics.py:267-309``)."""
    ctx = get_context()
    ctx.machine_topology = _check_topology(topology, ctx.machine_size)
    ctx.machine_topology_weighted = is_weighted
    ctx._machine_sched = None
    return True


def machine_rank(rank: int) -> int:
    """Machine id of ``rank``."""
    return int(rank) // get_context().nodes_per_machine


def local_rank(rank: int) -> int:
    """Rank within its machine."""
    return int(rank) % get_context().nodes_per_machine


def in_neighbor_machine_ranks(machine_rank: int) -> List[int]:
    topo = get_context().machine_topology
    if topo is None:
        raise RuntimeError("no machine topology set")
    return topo_util.GetInNeighbors(topo, machine_rank)


def out_neighbor_machine_ranks(machine_rank: int) -> List[int]:
    topo = get_context().machine_topology
    if topo is None:
        raise RuntimeError("no machine topology set")
    return topo_util.GetOutNeighbors(topo, machine_rank)


def machine_schedule() -> CommSchedule:
    """The machine topology compiled to gossip rounds (cached)."""
    return get_context().machine_schedule()


def set_dynamic_topology(generator_factory, num_steps: Optional[int] = None,
                         uniform: bool = True) -> List[CommSchedule]:
    """Install an iteration-varying topology from a one-peer generator
    family: ``generator_factory(rank)`` yields the reference's ``([send
    ranks], [recv ranks])`` per iteration; its period compiles once into
    a schedule list on the context, which the ``communication_type``
    optimizer factories then pick up.  Returns the schedules."""
    ctx = get_context()
    scheds = compile_dynamic_schedules(generator_factory, ctx.size,
                                       num_steps, uniform)
    ctx.dynamic_schedules = scheds
    return scheds


def clear_dynamic_topology() -> None:
    get_context().dynamic_schedules = None


def dynamic_schedules() -> Optional[List[CommSchedule]]:
    return get_context().dynamic_schedules


def set_dcn_wire(value: Optional[str]) -> None:
    """Set the process default wire codec for the machine hop of
    hierarchical gossip (``"bf16"``/``"int8"``/``"fp8"``, optionally
    ``"@B"``-blocked); ``"off"`` forces full width, ``None`` defers to
    ``BLUEFOG_DCN_WIRE``.  A per-call ``wire=`` always wins."""
    if value is not None and value != "off":
        from ..ops.collectives import _check_wire
        _check_wire(value)
    get_context().dcn_wire = value


def dcn_wire() -> Optional[str]:
    """The context's machine-hop wire default (see :func:`set_dcn_wire`)."""
    return get_context().dcn_wire
