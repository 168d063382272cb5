"""Weights made from the seed, on the device, one call a leaf.

The shapes and dtypes come from the tree that the program asks for (its
parameter shapes on the ``meta`` device, nothing allocated); the values
are the benchmark's: each leaf drawn from a generator seeded by the run's
seed and the leaf's path, normal with variance 1 / fan-in, norms at one,
biases at zero.  A leaf can therefore be drawn again alone (``leaf``),
as the training check does.  The reference reads the same tensors.
"""
from __future__ import annotations

import math

import torch

from harness.traffic import mix

ONES = {"ln1", "ln2", "final_norm", "kv_norm"}
ZEROS = {"bq", "bk", "bv"}
STACKS = {"blocks", "prefix_blocks"}     # leaves with a leading layer axis


def flatten(tree, prefix=()) -> list:
    """[(path, tensor)] of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def unflatten(pairs) -> dict:
    tree = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def fan_in(path: tuple, shape: tuple) -> int:
    name = path[-1]
    lead = 1 if path[0] in STACKS else 0
    if name in ("emb", "head"):
        return shape[-1]
    if name in ("we1", "we3"):               # (E, D, F)
        return shape[lead + 1]
    if name in ("w2", "we2"):                # (F, D), (E, F, D)
        return shape[-2]
    if name == "wo":                         # (H, hd, D)
        return math.prod(shape[lead:-1])
    return shape[lead]                       # (D, ...), wkv_b's (R, ...)


def leaf(path: tuple, shape, dtype, seed: int, device) -> torch.Tensor:
    if path[-1] in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if path[-1] in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "weights", *path))
    w = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return w.mul_(1.0 / math.sqrt(fan_in(path, tuple(shape))))


def make(shapes, seed: int, device) -> dict:
    """A tree like ``shapes`` (tensors on ``meta``) filled from the seed."""
    return unflatten((p, leaf(p, tuple(t.shape), t.dtype, seed, device))
                     for p, t in flatten(shapes))
