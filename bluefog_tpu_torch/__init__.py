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
(``init(size=n)`` stacks n ranks on the device); and the strategy layer
of the reference's benchmark (``optimizers``: dynamic and hierarchical
gossip, wire codecs, window mailboxes, push-sum, CHOCO, ZeRO-1,
PowerSGD; ``ops.windows``; ``examples.benchmark``).  The kernels are CUDA
C++ under ``csrc/``.
"""
from .api import (barrier, hard_sync, hierarchical_neighbor_allreduce,
                  neighbor_allreduce, resolve_schedule, shard_distributed,
                  synchronize)
from .device import resolve_device
from .parallel.context import (
    clear_dynamic_topology, dcn_wire, dynamic_schedules, get_context,
    in_neighbor_machine_ranks, in_neighbor_ranks, init, is_initialized,
    is_machine_topology_weighted, is_topology_weighted, load_machine_topology,
    load_topology, local_rank, local_size, machine_rank, machine_schedule,
    machine_size, out_neighbor_machine_ranks, out_neighbor_ranks,
    set_dcn_wire, set_dynamic_topology, set_machine_topology, set_topology,
    shutdown, size, static_schedule)

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
           "neighbor_allreduce", "hierarchical_neighbor_allreduce",
           "barrier", "synchronize", "hard_sync", "resolve_schedule",
           "shard_distributed"]
