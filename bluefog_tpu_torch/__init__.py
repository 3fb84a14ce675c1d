"""bluefog_tpu_torch: the PyTorch/CUDA port of ``bluefog_tpu``.

The port runs on one NVIDIA H100 and keeps the JAX package's layouts at
its public functions, so each module can be held against its JAX
counterpart on the same inputs.  It imports ``torch`` and ``numpy`` and
never ``jax`` or anything of ``bluefog_tpu``.

Ported so far: dense serving on one card (``serve``), with decode
attention through the hand-written paged flash-decode kernel
(``ops.flash_decode``); and decentralized LM training by gossip over
data-parallel ranks stacked on one card (``parallel.compose``,
``optimizers``, ``topology``, ``schedule``), with attention through the
hand-written flash forward and backward kernels
(``ops.flash_attention``).  The kernels are CUDA C++ under ``csrc/``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
