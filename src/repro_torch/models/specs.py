"""Partition-spec rules for params / caches / batches, plus the per-layer
weight gather.

The port of ``repro.models.specs``; the rule tables are the reference's,
letter for letter.  Storage follows them exactly: parameters, optimizer
moments and caches live as ``DTensor``s sharded by these specs (over the
``fsdp`` and the ``tp`` axes alike).  ``gather_fsdp``, at the top of each
layer body (the reference's call sites), gathers only the ``fsdp`` axes,
as the reference's does: a leaf split over "model" stays this rank's
shard, and the model code computes on it (its heads, its ``d_ff``
columns, its experts as ``_expert_rule`` places them, its vocabulary),
with the collectives of ``models.partition`` where the reference's SPMD
partitioner puts them.  A Mamba layer's gather is ``gather_mamba``: where
the mixer splits (``ssm.mixer_splits``) its heads' leaves stay the rank's
shard and its conv's are gathered whole (their even split does not fall
on the heads); where it does not, the layer is gathered whole and
computed on every model rank.
"""
from __future__ import annotations

from repro_torch.models import partition, ssm
from repro_torch.tree import tree_map_with_path

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

# Leaves replicated over "model" (by their rule, or by the divisibility
# guard on a "tp" entry) that the model reads inside a region split there:
# their gradients are partial sums over "model" when the region is split.
# Keyed by what splits the region: the attention's heads (KV projections
# and biases that the guard replicates, MLA's latent path, the hybrid
# shared block's LoRA factors ``a_*`` of split weights), the MLP's d_ff
# (its LoRA factors), the Mamba mixer's heads (B, C and dt projected
# whole, the rank's heads of the per-head leaves), and "seq_rows": the
# norms that act on the rank's rows of the sequence (``sp_residual``'s,
# and a Mamba block's and the hybrid's shared block's under
# ``sp_boundary``).
TP_PARTIAL = {
    "heads": frozenset({"wk", "wv", "bk", "bv", "wkv_a", "kv_norm", "a_q",
                        "a_k", "a_v", "b_k", "b_v"}),
    "d_ff": frozenset({"a_1", "a_3"}),
    "mixer": frozenset({"w_B", "w_C", "w_dt", "A_log", "dt_bias", "Dskip"}),
    "seq_rows": frozenset({"ln1", "ln2", "ln"}),
}
# the other leaves replicated over "model": read outside every split region
# (the router before the experts' dispatch, the final norms), so every rank
# has their whole gradient
TP_WHOLE = frozenset({"router", "final_norm", "enc_norm", "lnx"})
# the Mamba conv's leaves: split over "model" evenly, gathered whole for a
# split mixer, their gradient partial there
MIXER_WHOLE = frozenset({"conv_w", "conv_b"})


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


def tp_partial_leaves(cfg, *, seq_rows: bool = False) -> frozenset:
    """The names of ``TP_PARTIAL`` whose regions are split here (the
    attention's when its heads are, the MLP's when its d_ff is, the Mamba
    mixer's when ``ssm.mixer_splits``) and, with ``seq_rows``, the norms
    on the rank's rows: ``gather_fsdp``'s ``partial``."""
    names = set(TP_PARTIAL["seq_rows"]) if seq_rows else set()
    if partition.tp_splits(cfg.num_heads):
        names |= TP_PARTIAL["heads"]
    if partition.tp_splits(cfg.d_ff):
        names |= TP_PARTIAL["d_ff"]
    if cfg.ssm is not None and partition.tp_active() \
            and ssm.mixer_splits(cfg):
        names |= TP_PARTIAL["mixer"]
    return frozenset(names)


def trailing_spec(shape, rule) -> partition.PartitionSpec:
    names = (None,) * (len(shape) - len(rule)) + tuple(rule)
    return partition.spec(shape, names)


def gather_fsdp(tree, moe_ep: bool = True, *, whole: bool = False,
                partial=frozenset()):
    """Every ``DTensor`` leaf of ``tree`` as this rank's local tensor for
    compute: gathered over the ``fsdp`` axes (every axis but "model"), a
    split over "model" kept as this rank's shard; with ``whole``, gathered
    over every axis (``partition.gather_leaf``).  Its gradient goes back
    as a partial sum over the axes that split the batch and, for the leaf
    names in ``partial`` that are replicated over "model", over "model"
    too.  The identity outside a plan scope.  Call it on ONE layer's slice
    of a stacked tree, so that only that layer is whole at a time.
    ``moe_ep`` is the reference's signature: the experts' placements
    already follow ``_expert_rule``."""
    if partition.current_env() is None:
        return tree
    return tree_map_with_path(
        lambda path, t: partition.gather_leaf(
            t, keep_tp=not whole, partial=leaf_name(path) in partial,
            name=leaf_name(path)), tree)


def gather_mamba(lp, cfg, *, seq_rows: bool = False):
    """ONE Mamba layer's weights for compute.  Where the mixer splits
    (``ssm.mixer_splits``): its heads' leaves as this rank's shard over
    "model", the conv's (``MIXER_WHOLE``) gathered whole, their gradient
    and that of the replicated leaves of ``TP_PARTIAL["mixer"]`` partial
    over "model"; else the whole layer on every rank.  With ``seq_rows``
    the block's norm acts on the rank's rows of the sequence, and its
    gradient is partial too.  The identity outside a plan scope."""
    rows = TP_PARTIAL["seq_rows"] if seq_rows else frozenset()
    if partition.current_env() is None:
        return lp
    if not ssm.mixer_splits(cfg):
        return gather_fsdp(lp, whole=True, partial=rows)
    partial = rows | TP_PARTIAL["mixer"] | MIXER_WHOLE
    return {k: partition.gather_leaf(t, keep_tp=k not in MIXER_WHOLE,
                                     partial=k in partial, name=k)
            for k, t in lp.items()}
