"""bluefog_tpu_torch: the PyTorch/CUDA port of ``bluefog_tpu``.

The port runs on one NVIDIA H100 and keeps the JAX package's layouts at
its public functions, so each module can be held against its JAX
counterpart on the same inputs.  It imports ``torch`` and ``numpy`` and
never ``jax`` or anything of ``bluefog_tpu``.

Ported so far: dense serving on one card (``serve``), with decode
attention through the hand-written paged flash-decode kernel
(``ops.flash_decode``); decentralized LM training by gossip over
data-parallel ranks stacked on one card (``parallel.compose``,
``optimizers``, ``topology``, ``schedule``), with attention through the
hand-written flash forward and backward kernels
(``ops.flash_attention``); the model zoo (``models``: ResNet, VGG, the
MNIST CNN, the MLP) and the ResNet-50 gossip benchmark
(``tools.bench``); the single-process context and op API below
(``init(size=n)`` stacks n ranks on the device, or, launched by
torchrun, each process's block of them over ``torch.distributed``);
the pipeline schedules (``parallel.pipeline``: GPipe, 1F1B, interleaved,
stage lists); and the strategy layer
of the reference's benchmark (``optimizers``: dynamic and hierarchical
gossip, wire codecs, window mailboxes, push-sum, CHOCO, ZeRO-1,
PowerSGD; ``ops.windows``; ``examples.benchmark``); the optimizer
core's rest (exact diffusion, gradient tracking, push-DIGing, async
window gossip with its staleness knob, ZeRO with gossip, the strategy
registry, the stateful train step, the named windows below, the
consensus probes of ``diagnostics``; ``examples.decentralized_optimization``,
``tools.gossip_bench``, ``tools.strategy_bench``); and the host
runtime's rest (fault injection, ``utils.chaos``; healing, membership
and the rollback guard, ``resilience``; ``checkpoint``; the input
pipeline, ``data``; ``utils.timeline`` and ``utils.watchdog``; the host
C++ helpers, ``_native``; ``examples.mnist``, ``examples.resnet``,
``examples.elastic_restart``); and the launcher, the elastic world and
the fleet view (``run.launcher``, ``bfrun-torch``, with its supervisor,
preemption traces and ``run.interactive``; ``parallel.context.reinit``
and ``resilience.regrow_world``; ``utils.fleetview`` on the consensus
probe; ``tools.regrow_drill``, ``tools.preempt_trace``,
``tools.preempt_bench``, ``tools.fleet_top``); and the autotuner
(``autotune``, ``Plan``, ``load_plan``, ``apply_plan``; its byte counts
from the wire-byte ledger of the port's own collectives,
``utils.wire_bytes``).  The kernels are CUDA C++ under ``csrc/``.
"""
__version__ = "0.1.0"

from .api import (allgather, allreduce, barrier, broadcast, hard_sync,
                  hierarchical_neighbor_allreduce, neighbor_allgather,
                  neighbor_allreduce, pair_gossip, poll, ragged_allgather,
                  ragged_neighbor_allgather, resolve_schedule,
                  shard_distributed, synchronize)
from .device import resolve_device
from .parallel.windows import (
    get_win_stamps, get_win_version, turn_off_win_ops_with_associated_p,
    turn_on_win_ops_with_associated_p, win_accumulate, win_associated_p,
    win_create, win_free, win_get, win_mutex, win_put, win_staleness,
    win_update, win_update_then_collect)
from .parallel.context import (
    clear_dynamic_topology, dcn_wire, dynamic_schedules, get_context,
    in_neighbor_machine_ranks, in_neighbor_ranks, init, is_initialized,
    is_machine_topology_weighted, is_topology_weighted, load_machine_topology,
    load_topology, local_rank, local_size, machine_rank, machine_schedule,
    machine_size, out_neighbor_machine_ranks, out_neighbor_ranks,
    resume, round_parallel, set_async_gossip, async_gossip_bound,
    set_dcn_wire, set_dynamic_topology,
    set_machine_topology, set_round_parallel, set_topology, shutdown, size, static_schedule,
    suspend, apply_plan)
from . import autotune as autotune_lib
from .autotune import autotune, Plan, load_plan

__all__ = ["resolve_device",
           "init", "shutdown", "is_initialized", "get_context", "size",
           "load_topology", "is_topology_weighted", "set_topology",
           "in_neighbor_ranks", "out_neighbor_ranks", "static_schedule",
           "local_size", "machine_size", "local_rank", "machine_rank",
           "load_machine_topology", "is_machine_topology_weighted",
           "set_machine_topology", "in_neighbor_machine_ranks",
           "out_neighbor_machine_ranks", "machine_schedule",
           "set_dynamic_topology", "clear_dynamic_topology",
           "dynamic_schedules", "set_dcn_wire", "dcn_wire",
           "suspend", "resume", "set_round_parallel", "round_parallel",
           "set_async_gossip", "async_gossip_bound",
           "neighbor_allreduce", "hierarchical_neighbor_allreduce",
           "neighbor_allgather", "ragged_neighbor_allgather", "pair_gossip",
           "allreduce", "allgather", "ragged_allgather", "broadcast",
           "barrier", "synchronize", "poll", "hard_sync",
           "resolve_schedule", "shard_distributed",
           "win_create", "win_free", "win_put", "win_accumulate", "win_get",
           "win_update", "win_update_then_collect", "win_mutex",
           "get_win_version", "get_win_stamps", "win_staleness",
           "win_associated_p", "turn_on_win_ops_with_associated_p",
           "turn_off_win_ops_with_associated_p",
           "apply_plan", "autotune", "Plan", "load_plan", "autotune_lib"]
