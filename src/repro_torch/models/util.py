"""Layer-stack loop and small helpers over parameter trees.

The reference iterates its stacked layers with ``lax.scan``; PyTorch runs
eagerly, so ``stack_scan`` is a Python loop over the leading (layer) axis.
A tree is a tensor, or a dict, tuple or list of trees (``None`` leaves pass
through).
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def stack_scan(body, x, stacked):
    """``body(x, layer_slice) -> (x, y)`` over the leading axis of
    ``stacked``; returns (x, ys stacked over layers, or None)."""
    n = tree_leaves(stacked)[0].shape[0]
    ys = []
    for i in range(n):
        x, y = body(x, tree_map(lambda a: a[i], stacked))
        ys.append(y)
    if not ys or not tree_leaves(ys[0]):
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *ys)
