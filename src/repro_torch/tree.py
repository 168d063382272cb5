"""Trees of tensors: a tensor, or a dict, tuple or list of trees (``None``
leaves pass through), as parameter, optimizer and train-state trees are.
"""
from __future__ import annotations


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


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    ``tree_leaves(like)`` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unzip(tree, n: int) -> tuple:
    """The ``n`` trees of a tree of dicts and lists whose leaves are
    ``n``-tuples, as ``tree_map`` gives them for a function of ``n``
    results."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    if isinstance(tree, list):
        parts = [tree_unzip(v, n) for v in tree]
        return tuple([p[i] for p in parts] for i in range(n))
    if tree is None:
        return (None,) * n
    if len(tree) != n:
        raise ValueError(f"a leaf of {len(tree)} values, want {n}")
    return tuple(tree)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the tensors of ``tree``; ``path`` is the
    tuple of dict keys and sequence indices from the root to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)
