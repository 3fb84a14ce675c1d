"""The process context: the ranks, their virtual topology, and the
process group that carries them (counterpart of
``bluefog_tpu/parallel/context.py``).

The JAX context builds a mesh over the devices, one rank each.  Here the
ranks are stacked on dim 0 of every tensor (the layout of
:mod:`bluefog_tpu_torch.ops.collectives`).  In one process every rank is
a row on the context's device.  Launched as several processes (torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), each process holds a contiguous block of ``rows`` ranks
of the global rank axis, process-major: process ``p`` holds ranks ``p *
rows .. (p + 1) * rows - 1``, the counterpart of each JAX process owning
its local devices of one global mesh.  The process group is NCCL on a
CUDA device (``cuda:LOCAL_RANK``) and gloo only when the caller asks for
the CPU; one rank a process on one card a process is the GPU deployment.
``init(size=n)`` takes the global rank count in either case, and
:func:`size` returns it.

The topology, its weights and its compiled schedule live in one
process-level context, as in JAX, and the accessors take the rank as an
argument (host code sees every rank's tables).  The machine level
(``nodes_per_machine`` ranks a machine, machine-major on dim 0; by
default a process's block when there are several) carries the machine
topology hierarchical gossip runs over, and an installed dynamic
topology (:func:`set_dynamic_topology`) is the schedule list the
``communication_type`` factories pick up.

The active compose carving (:func:`set_compose` / :func:`get_compose`)
is recorded here as in JAX.  :func:`reinit` re-forms the world at a new
rank count (mesh regrowth, under
:func:`bluefog_tpu_torch.resilience.regrow_world`): in the stacked backend
that means more or fewer rows on dim 0, and across processes a new
process group when the process count changes.  JAX's
``parallel/exec_cache.py`` (a pool of compiled XLA executables a world
shape) has no counterpart: the port compiles no program for a world (no
XLA executables, no CUDA graphs, no ``torch.compile``), and its kernels
are built once a process by ``ops/_build.py``, keyed by a source hash.

Not ported (ROADMAP queue 1, item 10): ``apply_plan`` (autotune).
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
           "suspend", "resume", "set_round_parallel", "round_parallel",
           "set_topology", "in_neighbor_ranks", "out_neighbor_ranks",
           "static_schedule", "local_size", "machine_size",
           "load_machine_topology", "is_machine_topology_weighted",
           "set_machine_topology", "machine_rank", "local_rank",
           "in_neighbor_machine_ranks", "out_neighbor_machine_ranks",
           "machine_schedule", "set_dynamic_topology",
           "clear_dynamic_topology", "dynamic_schedules", "set_dcn_wire",
           "dcn_wire", "set_async_gossip", "async_gossip_bound",
           "set_compose", "get_compose", "reinit"]

_context: Optional["BlueFogTorchContext"] = None


@dataclass
class BlueFogTorchContext:
    size: int                                 # global ranks
    device: torch.device
    topology: nx.DiGraph
    topology_weighted: bool = False
    nodes_per_machine: int = 1
    machine_topology: Optional[nx.DiGraph] = None
    machine_topology_weighted: bool = False
    dynamic_schedules: Optional[List[CommSchedule]] = None
    # process default for round-parallel gossip emission (None = defer to
    # BLUEFOG_ROUND_PARALLEL; per-call concurrent= overrides both)
    round_parallel: Optional[bool] = None
    # process default for the machine hop's wire codec of hierarchical
    # gossip (None = defer to BLUEFOG_DCN_WIRE; "off" forces full width)
    dcn_wire: Optional[str] = None
    # process default staleness bound K of async window gossip (None =
    # defer to BLUEFOG_ASYNC, then _DEFAULT_ASYNC_BOUND)
    async_staleness: Optional[int] = None
    # how the machine grouping was derived ("auto" = from the process
    # layout at init; None = manual nodes_per_machine / set_machine_topology)
    hierarchical: Optional[str] = None
    # the processes: this one's index and their count; it holds global
    # ranks process * rows .. (process + 1) * rows - 1
    process: int = 0
    world: int = 1
    owns_group: bool = False                  # init made the process group
    _sched: Optional[CommSchedule] = None
    _machine_sched: Optional[CommSchedule] = None

    @property
    def machine_size(self) -> int:
        return self.size // self.nodes_per_machine

    @property
    def rows(self) -> int:
        """The ranks this process holds (dim 0 of its tensors)."""
        return self.size // self.world

    @property
    def first_rank(self) -> int:
        return self.process * self.rows

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
         nodes_per_machine: Optional[int] = None,
         hierarchical: Optional[str] = None) -> BlueFogTorchContext:
    """Initialize the context (reference: ``bf.init``).

    Args:
      topology_fn: zero-arg callable returning the virtual topology;
        defaults to ``ExponentialGraph(size)`` like the reference.
      is_weighted: use the topology's mixing weights for neighbor averaging
        instead of the uniform ``1/(in_degree+1)`` default.
      size: the global number of ranks (default: one a process).  Each
        of the ``WORLD_SIZE`` processes holds ``size / WORLD_SIZE`` of
        them, stacked on dim 0.
      device: where the ranks live; CUDA unless the caller asks for another
        device (a missing card raises).  Launched as several processes,
        CUDA is ``cuda:LOCAL_RANK`` over NCCL, and the CPU runs gloo.
      nodes_per_machine: ranks a "machine" for hierarchical ops (default
        ``BLUEFOG_NODES_PER_MACHINE``, else a process's ranks when there
        are several processes, else every rank on one machine, as the JAX
        context does with ``jax.local_device_count()``); ``size`` must
        divide by it.
      hierarchical: ``"auto"`` derives the machines from the process
        layout (a machine a process when there are several; else
        ``nodes_per_machine``; else a rank a machine, where hierarchical
        gossip is flat gossip) and installs the weighted
        ``ExponentialTwoGraph`` over them as the machine topology.  CUDA
        has no counterpart of the TPU's ``slice_index``.  ``None`` defers
        to ``BLUEFOG_HIERARCHICAL``; ``"off"`` disables.
    """
    global _context, _active_compose
    _active_compose = None    # a new context invalidates any prior carving
    from ..utils.config import env_flag
    world, process = _process_group_from_env(device)
    n = world if size is None else int(size)
    if n < 1:
        raise ValueError(f"size must be at least 1, got {n}")
    if n % world:
        raise ValueError(f"size {n} is not a whole number of ranks for each "
                         f"of the {world} processes")
    if hierarchical is None:
        hierarchical = "auto" if env_flag("BLUEFOG_HIERARCHICAL",
                                          False) else None
    elif hierarchical in ("off", False):
        hierarchical = None
    elif hierarchical is True:
        hierarchical = "auto"
    if hierarchical not in (None, "auto"):
        raise ValueError(
            f"hierarchical must be 'auto' or 'off', got {hierarchical!r}")
    if nodes_per_machine is None:
        env = os.environ.get("BLUEFOG_NODES_PER_MACHINE", "").strip()
        nodes_per_machine = int(env) if env else None
    if hierarchical == "auto":
        nodes_per_machine = _auto_hierarchy(n // world, world,
                                            nodes_per_machine)
    if nodes_per_machine is None:
        nodes_per_machine = n // world if world > 1 else n
    if n % nodes_per_machine != 0:
        raise ValueError(f"device count {n} not divisible by "
                         f"nodes_per_machine {nodes_per_machine}")
    dev = _process_device(device, world)
    # the registries' exporters, as JAX's init arms them: BLUEFOG_TIMELINE,
    # BLUEFOG_METRICS / BLUEFOG_METRICS_PORT, BLUEFOG_CHAOS,
    # BLUEFOG_FLIGHT_DIR / BLUEFOG_FLIGHT_EVENTS and BLUEFOG_TRACE
    from ..utils import chaos as _chaos
    from ..utils import timeline as _tl
    _tl.maybe_start_from_env()
    _metrics.maybe_start_from_env()
    _chaos.maybe_install_from_env()
    _flight.maybe_enable_from_env()
    _tracing.maybe_enable_from_env()
    from ..utils import fleetview as _fleetview
    _fleetview.maybe_arm_from_env(n, local_ranks=_block(process, n // world)
                                  if world > 1 else None)
    _flight.record("lifecycle", name="init", devices=n)
    topo = topology_fn() if topology_fn is not None \
        else topo_util.ExponentialGraph(n)
    owns = False
    if world > 1 or _launched():
        owns = _init_process_group(dev, world, process)
    _context = BlueFogTorchContext(n, dev, _check_topology(topo, n),
                                   is_weighted,
                                   nodes_per_machine=int(nodes_per_machine),
                                   hierarchical=hierarchical,
                                   process=process, world=world,
                                   owns_group=owns)
    if hierarchical == "auto" and _context.machine_size > 1:
        _context.machine_topology = topo_util.ExponentialTwoGraph(
            _context.machine_size)
        _context.machine_topology_weighted = True
    return _context


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def _block(process: int, rows: int) -> range:
    """The global ranks process ``process`` holds at ``rows`` a process."""
    return range(process * rows, (process + 1) * rows)


def _launched() -> bool:
    """torchrun's variables are set (a launch of one process counts)."""
    return bool(os.environ.get("MASTER_ADDR", "").strip()
                and os.environ.get("WORLD_SIZE", "").strip())


def _process_group_from_env(device) -> "tuple[int, int]":
    """``(world, process)`` from torchrun's variables; ``(1, 0)`` when the
    process was not launched as one of several.  A multi-process launch
    with a variable missing raises: it never falls back to one process."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world < 1:
        raise ValueError(f"WORLD_SIZE must be at least 1, got {world}")
    if world == 1 and not _launched():
        return 1, 0
    missing = [v for v in _LAUNCH_VARS if not os.environ.get(v, "").strip()]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE={world}: a multi-process launch needs torchrun's "
            f"variables {list(_LAUNCH_VARS)}; missing {missing}")
    process = int(os.environ["RANK"])
    if not 0 <= process < world:
        raise ValueError(f"RANK {process} out of range for WORLD_SIZE "
                         f"{world}")
    return world, process


def _process_device(device, world: int) -> torch.device:
    """The context's device: ``cuda:LOCAL_RANK`` for a CUDA launch of
    several processes, else :func:`resolve_device`'s."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and _launched():
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def _init_process_group(dev: torch.device, world: int,
                        process: int) -> bool:
    """Join the process group torchrun describes: NCCL on a CUDA device,
    gloo on the CPU.  An existing group is used as it is.  Returns
    whether this call made the group (:func:`shutdown` then destroys
    it).  A failed init raises; nothing falls back to gloo."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != process:
            raise RuntimeError(
                f"the existing process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process} of {world}")
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA context across processes needs NCCL, "
                           "which this torch build lacks")
    addr = (f"tcp://{os.environ['MASTER_ADDR']}:"
            f"{os.environ['MASTER_PORT']}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=process, **kw)
    return True


def _auto_hierarchy(rows: int, world: int,
                    nodes_per_machine: Optional[int]) -> int:
    """``nodes_per_machine`` of ``hierarchical="auto"``: a process's ranks
    when there are several processes (the boundary the JAX context finds
    by process locality), else an explicit ``nodes_per_machine``, else 1
    (every rank its own machine: hierarchical gossip degenerates to flat
    gossip instead of a silent wrong grouping)."""
    if world > 1:
        if nodes_per_machine is not None and nodes_per_machine != rows:
            raise ValueError(
                f"nodes_per_machine={nodes_per_machine} contradicts the "
                f"process layout ({rows} ranks per process)")
        return rows
    if nodes_per_machine is not None:
        return nodes_per_machine
    return 1


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
    """Drop the context (reference: ``bf.shutdown``), flushing an active
    timeline first as the reference's shutdown drains its writer thread,
    disarming chaos, and destroying the process group :func:`init`
    made."""
    global _context, _active_compose
    _active_compose = None
    from ..utils import chaos as _chaos
    from ..utils import timeline as _tl
    _flight.record("lifecycle", name="shutdown")
    _tl.stop_timeline()
    _chaos.uninstall()
    ctx, _context = _context, None
    if ctx is not None and ctx.owns_group:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def is_initialized() -> bool:
    return _context is not None


# The active composed-parallelism carving (a parallel.compose.Mesh3D), set
# by compose_parallelism() so tools (and reinit) can read the axis split
# without threading it through every call.  Cleared on init/shutdown: a
# carving is only meaningful against the world it divided.
_active_compose = None


def set_compose(m) -> None:
    global _active_compose
    _active_compose = m


def get_compose():
    return _active_compose


def reinit(world_size: int, *,
           topology_fn: Optional[Callable[[], nx.DiGraph]] = None,
           is_weighted: bool = False,
           processes: Optional[int] = None) -> BlueFogTorchContext:
    """Tear down and re-form the world at a new rank count (mesh
    regrowth; JAX ``parallel/context.py::reinit``).

    The primitive behind :func:`bluefog_tpu_torch.resilience.regrow_world`.
    In the stacked backend a world change means more or fewer rows on dim
    0: every rank stays a row on the context's device, and survivors keep
    their rank ids.  ``processes`` (default: the current count) is the
    process count of the new world; each process then holds
    ``world_size / processes`` rows, process-major.  A new count re-forms
    the process group (:func:`_rebootstrap_distributed`): the supervisor
    has already spawned the joiner processes with torchrun's variables.

    Every precondition is checked before anything is torn down, with
    JAX's texts where JAX has the check: the size is at least 1 and a
    multiple of the active carving's slice size; across processes it
    divides over them and keeps a replica inside one process; no named
    window is open (their mailboxes are shaped for the old rank count).
    Then the topology (Exp2 by default) and its schedule are rebuilt, the
    machine level by JAX's rule (``nodes_per_machine == size`` or no
    longer divisible means one machine), the compose carving at
    ``world_size // slice_size`` with the same pp/tp/sp/ep/wire, the
    resilience registry is re-baselined, an armed fleet view is re-armed
    at the new size (JAX leaves a stale view that its probe skips), and a
    ``lifecycle``/``reinit`` flight event is recorded.  Nothing is
    recompiled: the kernels are keyed by their sources, not by a world.

    Returns the new context.
    """
    global _context, _active_compose
    ctx = get_context()
    world_size = int(world_size)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    procs = ctx.world if processes is None else int(processes)
    if procs < 1:
        raise ValueError(f"processes must be at least 1, got {procs}")
    if procs != ctx.world and not _launched():
        raise ValueError(
            f"a world of {procs} processes needs a launched process group "
            "(torchrun's variables); this process runs alone")
    if world_size % procs:
        raise ValueError(f"size {world_size} is not a whole number of ranks "
                         f"for each of the {procs} processes")
    # validate EVERY precondition before anything is torn down: raising
    # past this point would leave a half-torn world
    old_compose = _active_compose
    if old_compose is not None and world_size % old_compose.slice_size:
        raise ValueError(
            f"world size {world_size} is not a multiple of the active "
            f"carving's slice size {old_compose.slice_size} "
            f"(pp={old_compose.pp} tp={old_compose.tp} "
            f"sp={old_compose.sp} ep={old_compose.ep})")
    rows = world_size // procs
    if old_compose is not None and procs > 1 and \
            rows % old_compose.slice_size:
        raise ValueError(
            f"a replica's {old_compose.slice_size} peers (pp x tp x sp x "
            f"ep) would straddle processes of {rows} ranks; a carving "
            "keeps each replica's peers inside one process (ROADMAP queue "
            "1, item 12)")
    from . import windows as _win
    if _win._registry:
        raise ValueError(
            f"named windows {sorted(_win._registry)} hold a mailbox a rank "
            f"for {ctx.size} ranks; free them (win_free) before re-forming "
            f"the world at {world_size}")
    old_n = ctx.size
    if procs != ctx.world:
        _rebootstrap_distributed(procs, ctx.process, ctx.device)

    npm = ctx.nodes_per_machine
    if procs > 1 and npm == ctx.rows:
        npm = rows                   # a machine a process, as init derives
    elif npm == ctx.size or world_size % npm != 0:
        npm = world_size             # single machine (or no longer divisible)
    topo = (topology_fn() if topology_fn is not None
            else topo_util.ExponentialGraph(world_size))
    new_ctx = BlueFogTorchContext(
        world_size, ctx.device, _check_topology(topo, world_size),
        is_weighted, nodes_per_machine=npm,
        round_parallel=ctx.round_parallel, dcn_wire=ctx.dcn_wire,
        async_staleness=ctx.async_staleness, process=ctx.process,
        world=procs, owns_group=ctx.owns_group or procs != ctx.world)
    _context = new_ctx
    _active_compose = None
    if old_compose is not None:
        from . import compose as _compose
        _compose.compose_parallelism(
            world_size // old_compose.slice_size, old_compose.pp,
            old_compose.tp, old_compose.sp, old_compose.ep,
            num_experts=old_compose.num_experts,
            capacity_factor=old_compose.capacity_factor,
            device=old_compose.device, wire=old_compose.wire)
    # the old world's membership registry (and its pristine baseline) is
    # meaningless against the new world: re-baseline from scratch
    from .. import resilience as _rz
    _rz.reset()
    _rearm_fleet(new_ctx)
    _flight.record("lifecycle", name="reinit", devices=world_size,
                   old_devices=old_n)
    return new_ctx


def _rearm_fleet(ctx: BlueFogTorchContext) -> None:
    """An armed fleet view keeps a row a rank: re-arm it (same spec and
    cadence, fresh tables) when the installed world has another size."""
    from ..utils import fleetview as _fleetview
    fv = _fleetview.active()
    if fv is None or (fv.n == ctx.size and tuple(fv.local_ranks) ==
                      tuple(_block(ctx.process, ctx.rows))):
        return
    _fleetview.arm(fv.spec, n=ctx.size, every=fv.every,
                   local_ranks=(_block(ctx.process, ctx.rows)
                                if ctx.world > 1 else None))


#: the file an elastic supervisor publishes each grown process count's
#: ``MASTER_PORT`` in (``run/launcher.py::_publish_port``)
PORT_FILE_ENV = "BLUEFOG_PORT_FILE"


def _next_master_port(processes: int, timeout: float = 60.0) -> str:
    """The port of the process group re-formed at ``processes``: the one
    the supervisor published for that count in ``$BLUEFOG_PORT_FILE``
    (a TCP store is not always re-formed on the port it was just torn
    down from, and a line for another count is never taken), else
    ``MASTER_PORT + 1`` when no file is named."""
    import time as _time
    cur = os.environ.get("MASTER_PORT", "")
    path = os.environ.get(PORT_FILE_ENV, "").strip()
    if not path:
        return str(int(cur) + 1)
    from ..run.launcher import _published_port
    t_end = _time.monotonic() + timeout
    while True:
        port = _published_port(path, processes)
        if port is not None and port != cur:
            return port
        if _time.monotonic() > t_end:
            raise RuntimeError(
                f"no MASTER_PORT for {processes} processes was published "
                f"in {path} within {timeout:g} s")
        _time.sleep(0.05)


def _rebootstrap_distributed(processes: int, process: int,
                             dev: torch.device) -> bool:
    """Tear down and re-form the process group at ``processes``
    processes: ``destroy_process_group``, then a fresh
    ``init_process_group`` at the new ``WORLD_SIZE`` on the next
    published port.  Only a launched process does this; one process
    never dials a store.  Returns whether a group was re-formed."""
    if not _launched():
        return False
    live = int(os.environ.get("WORLD_SIZE") or 1)
    if os.environ.get(PORT_FILE_ENV, "").strip() and 1 < processes < live:
        raise RuntimeError(
            f"cannot re-form the process group from {live} at {processes} "
            "processes: the supervisor publishes a port only for an "
            "elastic join (a grown count), not for a shrink or for a "
            "rollback after a grown group formed")
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    if processes <= 1 and process == 0:
        os.environ["WORLD_SIZE"] = "1"
        return False
    os.environ["MASTER_PORT"] = _next_master_port(processes)
    os.environ["WORLD_SIZE"] = str(int(processes))
    return _init_process_group(dev, int(processes), process)


def _install(ctx: BlueFogTorchContext, compose=None) -> None:
    """Reinstall a previously captured context (the regrow rollback path:
    a failed :func:`reinit` must leave the process on the old world).  A
    process group re-formed at another size is re-formed at the captured
    one."""
    global _context, _active_compose
    if ctx.world > 1 and _launched():
        import torch.distributed as dist
        live = dist.get_world_size() if dist.is_initialized() else None
        if live != ctx.world:
            _rebootstrap_distributed(ctx.world, ctx.process, ctx.device)
    if _launched():
        os.environ["WORLD_SIZE"] = str(ctx.world)
    _context = ctx
    _active_compose = compose
    _rearm_fleet(ctx)


def size() -> int:
    """The global rank count (over every process)."""
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


def suspend() -> None:
    """No-op (reference: ``bf.suspend``, which parks the MPI background
    thread for Jupyter cell boundaries; there is no background thread
    here)."""


def resume() -> None:
    """No-op counterpart of :func:`suspend`."""


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


def set_round_parallel(value: Optional[bool]) -> None:
    """Set the process default for round-parallel gossip emission
    (``concurrent=`` of ``neighbor_allreduce``): ``True`` moves the
    edge-colored rounds as one group (across processes, one message a
    process pair for all of them), ``False`` one round after another,
    ``None`` defers to the ``BLUEFOG_ROUND_PARALLEL`` env flag.  A
    per-call ``concurrent=`` always wins.  The rounds combine in round
    order either way, so the result does not change."""
    get_context().round_parallel = value


def round_parallel() -> Optional[bool]:
    """The context's round-parallel default (see :func:`set_round_parallel`)."""
    return get_context().round_parallel


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


#: Default staleness bound when neither the knob nor BLUEFOG_ASYNC is set:
#: deep enough to absorb a ~5x pace spread on the fleet's slowest rank
#: before the first forced sync-up, shallow enough that a stuck rank is
#: dragged back within a handful of ticks.
_DEFAULT_ASYNC_BOUND = 4


def set_async_gossip(bound: Optional[int]) -> None:
    """Set the process default staleness bound K of
    :func:`bluefog_tpu_torch.optimizers.async_window_gossip`: ``K=0``
    forces synchronous lockstep (every tick active), ``K>0`` lets ranks
    run free until some neighbor contribution is more than K ticks stale,
    and then the whole fleet syncs up on the next tick.  ``None`` defers
    to ``BLUEFOG_ASYNC`` (and its default).  A per-strategy
    ``staleness_bound=`` always wins.  The strategy reads the bound when
    it is built and at each update."""
    if bound is not None and int(bound) < 0:
        raise ValueError(f"staleness bound must be >= 0, got {bound}")
    get_context().async_staleness = None if bound is None else int(bound)


def async_gossip_bound() -> int:
    """The resolved async staleness bound: the context's knob, else the
    ``BLUEFOG_ASYNC`` variable, else ``_DEFAULT_ASYNC_BOUND`` (see
    :func:`set_async_gossip`)."""
    ctx = get_context()
    if ctx.async_staleness is not None:
        return ctx.async_staleness
    env = os.environ.get("BLUEFOG_ASYNC", "").strip()
    if env:
        bound = int(env)
        if bound < 0:
            raise ValueError(
                f"BLUEFOG_ASYNC must be >= 0, got {env!r}")
        return bound
    return _DEFAULT_ASYNC_BOUND
