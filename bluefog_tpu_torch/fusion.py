"""Tensor fusion over stacked ranks (counterpart of
``bluefog_tpu/fusion.py``).

A gossip step over a tree of L leaves would otherwise run ``L x rounds``
gathers; fusing the tree into one flat buffer per dtype makes it
``rounds``.  In the JAX package the leaves inside ``shard_map`` carry no
rank axis and fuse into one 1-D buffer.  Here every leaf is ``[n, ...]``
(rank on dim 0), so the leaves fuse into ``[n, total]`` by concatenating
along dim 1 — never by ravelling the rank axis in, which would mix
ranks.  Unfusing returns views into the buffer.

Trees are nested ``dict``/``list``/``tuple`` containers of tensors; dict
keys are visited in sorted order, as ``jax.tree.flatten`` does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

__all__ = ["fuse_tree", "FusedTree", "fused_leaf_op", "tree_flatten",
           "tree_unflatten", "tree_map"]


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef rebuilds the containers."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves += lv
            defs.append((len(lv), d))
        return leaves, ("dict", keys, defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            lv, d = tree_flatten(x)
            leaves += lv
            defs.append((len(lv), d))
        return leaves, (type(tree), None, defs)
    if tree is None:
        return [], ("none", None, None)
    return [tree], ("leaf", None, None)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    kind, keys, defs = treedef
    if kind == "leaf":
        return leaves[0]
    if kind == "none":
        return None
    out, pos = [], 0
    for count, d in defs:
        out.append(tree_unflatten(d, leaves[pos:pos + count]))
        pos += count
    if kind == "dict":
        return dict(zip(keys, out))
    return kind(out)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


class FusedTree:
    """Flat ``[n, total]`` per-dtype buffers + the recipe to rebuild the
    original tree."""

    def __init__(self, buffers: List[torch.Tensor], treedef, groups,
                 shapes):
        self.buffers = buffers          # one [n, total] tensor per dtype
        self._treedef = treedef
        self._groups = groups           # per group: list of leaf indices
        self._shapes = shapes           # per leaf: shape after the rank

    def unfuse(self) -> Any:
        leaves: List[Any] = [None] * len(self._shapes)
        for buf, idxs in zip(self.buffers, self._groups):
            off = 0
            for i in idxs:
                shape = self._shapes[i]
                size = 1
                for s in shape:
                    size *= s
                leaves[i] = buf[:, off:off + size].view(
                    (buf.shape[0],) + tuple(shape))
                off += size
        return tree_unflatten(self._treedef, leaves)


def fuse_tree(tree: Any) -> FusedTree:
    """Fuse a tree of ``[n, ...]`` leaves into one ``[n, total]`` buffer per
    dtype (stable leaf order)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("fuse_tree needs at least one leaf")
    n = leaves[0].shape[0]
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        if leaf.ndim < 1 or leaf.shape[0] != n:
            raise ValueError(f"every leaf must stack the same {n} ranks on "
                             f"dim 0; got a leaf of shape {tuple(leaf.shape)}")
        by_dtype.setdefault(leaf.dtype, []).append(i)
    groups = [idxs for _, idxs in sorted(by_dtype.items(),
                                         key=lambda kv: str(kv[0]))]
    buffers = [torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1)
               for idxs in groups]
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    return FusedTree(buffers, treedef, groups, shapes)


def fused_leaf_op(op: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Callable[[Any], Any]:
    """Lift a shape-preserving per-tensor collective to a whole-tree op:
    fuse, apply ``op`` once per dtype buffer, unfuse."""
    def tree_op(tree: Any) -> Any:
        fused = fuse_tree(tree)
        fused.buffers = [op(buf) for buf in fused.buffers]
        return fused.unfuse()
    return tree_op
