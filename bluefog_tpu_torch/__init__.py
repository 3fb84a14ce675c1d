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
(``tools.bench``); and the single-process context and op API below
(``init(size=n)`` stacks n ranks on the device).  The kernels are CUDA
C++ under ``csrc/``.
"""
from .api import (barrier, hard_sync, neighbor_allreduce, resolve_schedule,
                  shard_distributed, synchronize)
from .device import resolve_device
from .parallel.context import (get_context, in_neighbor_ranks, init,
                               is_initialized, is_topology_weighted,
                               load_topology, out_neighbor_ranks,
                               set_topology, shutdown, size, static_schedule)

__all__ = ["resolve_device",
           "init", "shutdown", "is_initialized", "get_context", "size",
           "load_topology", "is_topology_weighted", "set_topology",
           "in_neighbor_ranks", "out_neighbor_ranks", "static_schedule",
           "neighbor_allreduce", "barrier", "synchronize", "hard_sync",
           "resolve_schedule", "shard_distributed"]
