"""GPipe pipeline over stacked stages (counterpart of ``pipeline_apply``
and ``last_stage_value`` in ``bluefog_tpu/parallel/pipeline.py``).

The JAX function runs one stage per device along a ``stage`` mesh axis:
``num_micro + num_stages - 1`` ticks; at tick ``t`` stage ``s`` computes
microbatch ``t - s`` when that is in range, its output is masked to zero
otherwise, and ``ppermute`` ships it to stage ``s + 1``.  Here the stages
live stacked along dim 0 of every stage parameter, and each tick runs the
stages that have a microbatch at once, in one call of ``stage_fn`` over
that contiguous range of stages.  The masked ticks of the JAX schedule
(the bubble) are skipped: their output and its gradient are exactly zero
there, so skipping them changes no result.  The ship to the next stage is
the shift of the tick's outputs by one along the stage dim.

Autograd through the schedule is the GPipe backward, as ``jax.grad`` is
in the JAX package; ``remat=True`` recomputes each tick's stage forward in
the backward (``torch.utils.checkpoint``), keeping only its inputs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..fusion import tree_flatten, tree_unflatten

__all__ = ["pipeline_apply", "last_stage_value"]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   remat: bool = False) -> torch.Tensor:
    """Run a stage-partitioned network over microbatches.

    Args:
      stage_fn: ``(params, x) -> y`` for a contiguous range of ``k``
        stages at once: every leaf of ``params`` and ``x``/``y`` carry
        those stages on dim 0 (``y[i]`` is stage ``i``'s output for its
        input ``x[i]``).  Activations share one shape and dtype across
        stages (the pipeline contract).
      stage_params: a tree whose leaves stack the ``num_stages`` stages'
        parameters on dim 0.
      microbatches: ``[num_micro, ...]`` inputs; stage 0 reads them.
      remat: recompute each tick's stage forward in the backward.

    Returns:
      ``[num_micro, ...]``: the last stage's outputs, in microbatch order.
      (The JAX function returns them on the last stage's device and zeros
      on the others; :func:`last_stage_value` is that per-stage view.)
    """
    leaves, treedef = tree_flatten(stage_params)
    if not leaves:
        raise ValueError("pipeline_apply needs stage parameters")
    n_stage = leaves[0].shape[0]
    if any(w.shape[0] != n_stage for w in leaves):
        raise ValueError("every stage parameter must stack the same "
                         f"{n_stage} stages on dim 0")
    num_micro = microbatches.shape[0]
    fn = stage_fn
    if remat:
        def fn(p, x):
            return checkpoint(stage_fn, p, x, use_reentrant=False)

    outputs = [None] * num_micro
    prev = None                # the previous tick's outputs, first stage on
    for t in range(num_micro + n_stage - 1):
        # stages lo..hi hold microbatches t - hi .. t - lo at this tick
        lo, hi = max(0, t - num_micro + 1), min(t, n_stage - 1)
        parts = []
        if lo == 0:
            parts.append(microbatches[t][None])   # stage 0 injects mb t
        if hi >= 1:
            # stage s > 0 takes what stage s - 1 sent at the previous
            # tick; that tick's first stage is max(lo, 1) - 1
            parts.append(prev[:hi - max(lo, 1) + 1])
        x = parts[0] if len(parts) == 1 else torch.cat(parts)
        y = fn(tree_unflatten(treedef, [w[lo:hi + 1] for w in leaves]), x)
        if hi == n_stage - 1:
            outputs[t - n_stage + 1] = y[-1]      # the last stage records
        prev = y
    return torch.stack(outputs)


def last_stage_value(x: torch.Tensor) -> torch.Tensor:
    """The last stage's value on every stage: ``x`` stacks the stages on
    dim 0, and every row of the result is ``x[-1]`` (the JAX function's
    mask-and-``psum``).  Its gradient reaches the last stage's row only."""
    return x[-1:].expand_as(x)
