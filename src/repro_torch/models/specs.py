"""Partition-spec rules for params / caches / batches, plus the per-layer
weight gather.

The port of ``repro.models.specs``; the rule tables are the reference's,
letter for letter.  Storage follows them exactly: parameters, optimizer
moments and caches live as ``DTensor``s sharded by these specs (over the
``fsdp`` and the ``tp`` axes alike).  Compute is data-parallel: each rank
runs its rows of the batch with every weight gathered WHOLE, one layer at a
time, by ``gather_fsdp`` at the top of each layer body (the reference's
call sites).  The reference gathers only the ``fsdp`` axes and lets the
SPMD partitioner split the compute over ``tp``; the port gathers every
sharded axis, so ranks along "model" compute the same thing (splitting the
compute over "model" is a later item of the port).
"""
from __future__ import annotations

from repro_torch.models import partition
from repro_torch.tree import tree_map

PARAM_RULES = {
    "emb": ("tp", "fsdp"), "head": ("tp", "fsdp"),
    "wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
    "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp"),
    "bq": ("tp", None), "bk": (None, None), "bv": (None, None),
    "w1": ("fsdp", "tp"), "w3": ("fsdp", "tp"), "w2": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "wkv_a": ("fsdp", None), "kv_norm": (None,), "wkv_b": (None, "tp", None),
    "w_z": ("fsdp", "tp"), "w_x": ("fsdp", "tp"),
    "w_B": ("fsdp", None), "w_C": ("fsdp", None), "w_dt": ("fsdp", None),
    "conv_w": (None, "tp"), "conv_b": ("tp",),
    "ssm_norm": ("tp",), "out_proj": ("tp", "fsdp"),
    "a_q": ("fsdp", None), "a_k": ("fsdp", None), "a_v": ("fsdp", None),
    "a_1": ("fsdp", None), "a_3": ("fsdp", None),
    "b_q": (None, "tp", None), "b_k": (None, "tp", None),
    "b_v": (None, "tp", None), "b_1": (None, "tp"), "b_3": (None, "tp"),
}

CACHE_RULES = {
    "k": ("dp", "cache", None, None), "v": ("dp", "cache", None, None),
    "xk": ("dp", "cache", None, None), "xv": ("dp", "cache", None, None),
    "c": ("dp", "cache", None), "kr": ("dp", "cache", None),
    "ssm": ("dp", "tp", None, None), "ssm_g": ("dp", "tp", None, None),
    "ssm_t": ("dp", "tp", None, None),
    "conv": ("dp", None, "tp"), "conv_g": ("dp", None, "tp"),
    "conv_t": ("dp", None, "tp"),
}

BATCH_RULES = {
    "tokens": lambda nd: ("dp",) + (None,) * (nd - 1),
    "pos": lambda nd: ("dp",),
    "frames": lambda nd: ("dp", None, None),
    "patch_embeds": lambda nd: ("dp", None, None),
}

EXPERT_NAMES = {"we1", "we2", "we3"}


def leaf_name(path) -> str:
    """The last dict key on a tree path (``tree.tree_map_with_path``)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _expert_rule(name: str, shape, moe_ep: bool):
    env = partition.current_env()
    tp_size = env.axes_size(env.resolve("tp")) if env else 1
    E = shape[-3]
    ep_ok = moe_ep and tp_size > 1 and E % tp_size == 0
    if name == "we2":
        return ("ep", None, "fsdp") if ep_ok else (None, "tp", "fsdp")
    return ("ep", "fsdp", None) if ep_ok else (None, "fsdp", "tp")


def rule_for(name: str, shape, moe_ep: bool = True):
    if name in EXPERT_NAMES:
        return _expert_rule(name, shape, moe_ep)
    return PARAM_RULES.get(name)


def trailing_spec(shape, rule) -> partition.PartitionSpec:
    names = (None,) * (len(shape) - len(rule)) + tuple(rule)
    return partition.spec(shape, names)


def gather_fsdp(tree, moe_ep: bool = True):
    """Every ``DTensor`` leaf of ``tree`` gathered whole, as a local tensor
    whose gradient goes back as a partial sum over the axes that split the
    batch, so that the backward pass reduce-scatters it onto the shards
    (``partition.gather_whole``).  The identity outside a plan scope.
    Call it on ONE layer's slice of a stacked tree, so that only that
    layer is whole at a time.  ``moe_ep`` is the reference's signature:
    the port gathers the experts too, whatever their rule."""
    if partition.current_env() is None:
        return tree
    return tree_map(partition.gather_whole, tree)
