"""Parameter / state sync helpers (the port's own copy of
``bluefog_tpu/utils/utility.py``; reference: ``bluefog/torch/utility.py``).

``broadcast_parameters`` / ``broadcast_optimizer_state`` are the state-sync
primitives used at (re)start; ``allreduce_parameters`` averages.  All work
on distributed trees (``[rows, ...]`` leaves, rank on dim 0) through the op
API, so each leaf is one ``broadcast`` / ``allreduce`` call.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["broadcast_parameters", "allreduce_parameters",
           "broadcast_optimizer_state"]


def _map(tree: Any, op: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``op`` on every tensor leaf of a distributed tree: containers are
    rebuilt, a ``torch.optim.Optimizer``'s per-parameter state is updated
    in place (the port's optimizer state lives there), other leaves pass."""
    if isinstance(tree, torch.Tensor):
        return op(tree) if tree.ndim >= 1 else tree
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, op)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_map(v, op) for v in tree]
    if isinstance(tree, tuple):
        vals = [_map(v, op) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, torch.optim.Optimizer):
        with torch.no_grad():
            for st in tree.state.values():
                for k, v in st.items():
                    if isinstance(v, torch.Tensor) and v.ndim >= 1:
                        v.copy_(op(v))
        return tree
    return tree


def broadcast_parameters(params: Any, root_rank: int = 0) -> Any:
    """Every rank's row becomes root's (reference: ``utility.py:26-56``)."""
    from .. import api
    return _map(params, lambda x: api.broadcast(x, root_rank))


def allreduce_parameters(params: Any) -> Any:
    """Average all ranks' rows (reference: ``utility.py:58-87``)."""
    from .. import api
    return _map(params, lambda x: api.allreduce(x, average=True))


def broadcast_optimizer_state(opt_state: Any, root_rank: int = 0) -> Any:
    """Sync optimizer state from root (reference: ``utility.py:89-216``):
    a broadcast of every tensor leaf, integer leaves included (an exact
    copy, no averaging), the state of a ``torch.optim`` optimizer in
    place."""
    return broadcast_parameters(opt_state, root_rank)
