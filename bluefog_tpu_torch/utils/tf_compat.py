"""Migration helpers for TensorFlow/Keras users (counterpart of
``bluefog_tpu/utils/tf_compat.py``).

Move the *weights* across, then train decentralized with any strategy —
the strategies are tree-generic, so nothing else is TF-specific:

    params = tf_compat.from_keras(model)          # Keras model -> tree
    dist   = bf.optimizers.replicate(params, n)   # stacked ranks
    ...train with any bluefog_tpu_torch strategy...
    tf_compat.to_keras(model, params)             # back into the model

Leaves are torch tensors on an explicit device: ``device`` resolves as
every entry point's does (CUDA unless the caller passes ``"cpu"``).  The
tree keeps Keras's own layouts (conv kernels HWIO, dense kernels ``[in,
out]``, the flax convention the JAX package's trees use), so no axis
shuffling happens; only naming is mapped.  TensorFlow is an optional
dependency and is never imported here: the functions read the Keras
model's or the variables' own methods.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["from_keras", "to_keras", "from_variables", "to_variables",
           "param_count"]


def _insert(tree: Dict[str, Any], path: str, leaf) -> None:
    node = tree
    parts = [p for p in path.split("/") if p]
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    if parts[-1] in node:
        raise ValueError(f"duplicate weight path {path!r}")
    node[parts[-1]] = leaf


def _weight_paths(model):
    """Stable unique ``layer/weight`` paths for a Keras model's weights, in
    ``model.weights`` order (Keras 3 exposes ``.path``; older TF ``.name``
    with a ``:0`` suffix).  The model's own name prefix is stripped — it
    varies per instantiation (``sequential``, ``sequential_1``, …) and
    would make trees from two builds of the same architecture disagree.
    Name your layers for fully stable paths."""
    prefix = getattr(model, "name", "") + "/"
    paths = []
    seen: Dict[str, int] = {}
    for w in model.weights:
        p = getattr(w, "path", None) or w.name.split(":")[0]
        if p.startswith(prefix):
            p = p[len(prefix):]
        # shared-layer reuse can repeat a path; make it unique and stable
        k = seen.get(p, 0)
        seen[p] = k + 1
        paths.append(p if k == 0 else f"{p}__{k}")
    return paths


def _leaf(value, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(np.array(value), device=device)
    return t if dtype is None else t.to(dtype)


def _host(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return np.asarray(node)


def from_keras(model, *, dtype=None, device=None) -> Dict[str, Any]:
    """Keras model -> nested tree of torch tensors on ``device`` keyed by
    weight path (``{"dense": {"kernel": ..., "bias": ...}, ...}``)."""
    dev = resolve_device(device)
    tree: Dict[str, Any] = {}
    for path, value in zip(_weight_paths(model), model.get_weights()):
        _insert(tree, path, _leaf(value, dtype, dev))
    return tree


def to_keras(model, tree: Mapping[str, Any]):
    """Load a tree produced by :func:`from_keras` (possibly trained) back
    into the Keras model; returns the model.  Shapes are checked leaf by
    leaf so a topology mismatch fails with the offending path."""
    flat = []
    for path, current in zip(_weight_paths(model), model.get_weights()):
        node: Any = tree
        for p in [q for q in path.split("/") if q]:
            if not isinstance(node, Mapping) or p not in node:
                raise ValueError(f"pytree is missing weight {path!r}")
            node = node[p]
        arr = _host(node)
        if arr.shape != current.shape:
            raise ValueError(
                f"shape mismatch for {path!r}: model has {current.shape}, "
                f"pytree has {arr.shape}")
        flat.append(arr)
    model.set_weights(flat)
    return model


def from_variables(variables, *, dtype=None, device=None) -> Dict[str, Any]:
    """A flat list of ``tf.Variable`` -> nested tree (names split on
    ``/``, trailing ``:0`` stripped) — the raw-TF counterpart of
    :func:`from_keras` for non-Keras models."""
    dev = resolve_device(device)
    tree: Dict[str, Any] = {}
    for v in variables:
        name = v.name.split(":")[0] if hasattr(v, "name") else str(v)
        _insert(tree, name, _leaf(v, dtype, dev))
    return tree


def to_variables(variables, tree: Mapping[str, Any]):
    """Assign tree leaves back onto ``tf.Variable``s by name,
    shape-checked leaf by leaf (a transposed kernel must fail loudly, not
    load garbled)."""
    for v in variables:
        name = v.name.split(":")[0]
        node: Any = tree
        for p in [q for q in name.split("/") if q]:
            if not isinstance(node, Mapping) or p not in node:
                raise ValueError(f"pytree is missing variable {name!r}")
            node = node[p]
        arr = _host(node)
        if tuple(arr.shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch for {name!r}: variable has "
                f"{tuple(v.shape)}, pytree has {arr.shape}")
        v.assign(arr)
    return variables


def param_count(tree) -> int:
    """Total element count of a tree (sanity check after conversion)."""
    if isinstance(tree, Mapping):
        return sum(param_count(v) for v in tree.values())
    return int(np.prod(tuple(tree.shape)))
