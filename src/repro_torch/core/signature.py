"""Query signatures (paper §III-C-3): identity of the cross-engine remainder,
derived from (a) DAG structure, (b) referenced objects, (c) binned constants.

Island boundaries are part of identity: a ``scope`` node (``ops.SCOPE_OP``)
canonicalizes as ``<island>.scope[](<subtree>)``, so a query that pins a
subtree to another island's data model never shares history with its
unscoped sibling — they plan and execute differently (the boundary cast),
so they must not share monitor means or cached plans.

The same information a compiled-step cache key carries — deliberately —
so a tensor-plan layer can reuse this module for plan caching.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any

from repro_torch.core.ops import PolyOp, Ref


def _bin_constant(v: Any) -> str:
    """Bucket constants so near-identical queries share signatures."""
    if isinstance(v, bool):
        return f"b{v}"
    if isinstance(v, int):
        if abs(v) <= 8:
            return f"i{v}"
        return f"i~2^{round(math.log2(abs(v)))}" + ("-" if v < 0 else "")
    if isinstance(v, float):
        if v == 0 or not math.isfinite(v):
            return f"f{v}"
        exp = math.floor(math.log10(abs(v)))
        lead = round(v / 10 ** exp)
        return f"f{lead}e{exp}"
    if isinstance(v, str):
        return f"s{v}"
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_bin_constant(x) for x in v) + ")"
    return f"o{type(v).__name__}"


def _node_str(node, catalog=None) -> str:
    if isinstance(node, Ref):
        shape = ""
        if catalog is not None and node.name in catalog:
            entry = catalog[node.name]
            obj = entry.obj
            if getattr(entry, "streaming", False):
                # streaming tables grow between serves: their shape must not
                # enter the signature, or every append would orphan the plan
                # cache / monitor history the incremental-serve path lives on
                shape = f":{obj.kind}~"
            else:
                data = getattr(obj, "data", None)
                shape = f":{obj.kind}" \
                    f"{tuple(data.shape) if data is not None else ''}"
        return f"${node.name}{shape}"
    attrs = ",".join(f"{k}={_bin_constant(v)}"
                     for k, v in sorted(node.attrs.items()))
    kids = ",".join(_node_str(i, catalog) for i in node.inputs)
    return f"{node.island}.{node.op}[{attrs}]({kids})"


def signature(query: PolyOp, catalog=None) -> str:
    s = _node_str(query, catalog)
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def signature_text(query: PolyOp, catalog=None) -> str:
    """Human-readable canonical form (used in monitor dumps and tests)."""
    return _node_str(query, catalog)
