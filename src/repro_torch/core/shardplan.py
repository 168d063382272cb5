"""Scatter–gather planning over row-range sharded tables.

BigDAWG's middleware is a process-per-engine architecture: it "dispatches
query fragments to independent engine processes and reassembles results".
This module is the reassembly algebra for OUR partitioned path: given a
query whose leaves include row-range sharded registrations
(``register(..., shards=N)`` stores ``A#0 .. A#N-1`` alongside ``A``),
``analyze`` decides whether the query decomposes into N per-shard fragments
plus ONE merge node, and which merge reassembles it:

* ``concat`` — row-preserving ops (select, project, join with a replicated
  right side, matmul/spmm with a replicated right operand, haar, bin_hist,
  scale, add, window_agg): shard i's output rows ARE rows ``lo_i..hi_i`` of
  the full output, so the gather is row concatenation in shard order.
* ``sum``   — decomposable aggregates: ``count`` (per-shard totals add) and
  ``groupby_sum`` (every shard emits the full aligned ``0..num_groups`` key
  range, so group partials add position-wise).
* ``kmerge`` — ``sort``: each shard returns its rows ordered by the sort
  column; the gather is a k-way ordered merge (heap, stable across shards).

The analysis is *conservative*: ops whose semantics are not row-decomposable
(distinct, tfidf — global document frequencies, knn — global neighbors,
transpose) and island boundaries (scope) inside the sharded lineage return
``None``, which sends the query down the ordinary unsharded path.  An op is
also only row-decomposable against the right container semantics — matmul
row-shards a DENSE matrix, spmm a COO row range, join/groupby_sum/sort a
COLUMNAR record table — so the sharded lineage's container kind is tracked
through the tree and checked per op.

A ``concat``-merged fragment is wrapped in ``scope(root island)`` so every
shard delivers the island's data model regardless of which engine each
worker's planner picked — the merge needs kind-uniform parts.  Aggregate
roots already have engine-independent output kinds and go unwrapped.

``run_scatter_gather`` executes the decomposition against any fragment
runner (the in-process form the property tests use); ``core/procpool.py``
fans the same fragments out to worker processes and calls the same
``gather``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import tables
from repro_torch.core.islands import scope
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref

# rowwise ops: {op: (sharded input positions, allowed lineage kinds)} — the
# op keeps "output row i of shard == output row lo+i of the full input" when
# the listed input positions carry the sharded lineage (all other inputs
# must be replicated) and the lineage's container kind is in the allowed set
_ANY = ("dense", "columnar", "coo", "stream")
_ROWWISE: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "select":     ((0,), _ANY),
    "project":    ((0,), ("columnar",)),
    "join":       ((0,), ("columnar",)),
    "matmul":     ((0,), ("dense",)),
    "spmm":       ((0,), ("coo",)),
    "haar":       ((0,), ("dense", "stream")),
    "bin_hist":   ((0,), ("dense",)),
    "scale":      ((0,), ("dense",)),
    "add":        ((0, 1), ("dense",)),
    "window_agg": ((0,), ("stream",)),
}

# aggregate ops (root-only): op -> (merge kind, allowed lineage kinds)
_AGG: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "count":       ("sum", _ANY),
    "groupby_sum": ("sum", ("columnar",)),
    "sort":        ("kmerge", ("columnar",)),
}

# lineage container kind after a rowwise op (given an allowed input kind)
_KIND_OUT = {
    "select": None,          # None: passes the input kind through
    "haar": None,
    "project": "columnar",
    "join": "columnar",
    "matmul": "dense",
    "spmm": "dense",
    "bin_hist": "dense",
    "scale": "dense",
    "add": "dense",
    "window_agg": "dense",
}


def shard_name(name: str, i: int) -> str:
    """Catalog name of shard ``i`` of table ``name``."""
    return f"{name}#{i}"


@dataclass(frozen=True)
class ShardInfo:
    """Registration-time record of one sharded table: shard count, the
    ORIGINAL container kind (row semantics follow the source object even
    when the home engine stores a cast), and the leading-dimension row
    count (alignment check for multi-table co-sharding)."""
    n_shards: int
    kind: str
    rows: int


def nrows_of(obj) -> int:
    """Leading-dimension length of a container (what ``shard_rows`` splits)."""
    if isinstance(obj, tables.ColumnarTable):
        return obj.nrows
    if isinstance(obj, tables.COOMatrix):
        return obj.shape[0]
    data = getattr(obj, "data", None)
    if data is not None and getattr(data, "ndim", 0) >= 1:
        return int(data.shape[0])
    raise TypeError(f"no row dimension on {type(obj).__name__}")


def analyze_catalog(query: PolyOp,
                    infos: Dict[str, "ShardInfo"]) -> Optional[ScatterGather]:
    """``analyze`` against a registry of ``ShardInfo`` records (the form the
    middleware and procpool keep)."""
    if not infos:
        return None
    return analyze(query,
                   {n: i.n_shards for n, i in infos.items()},
                   {n: i.kind for n, i in infos.items()},
                   {n: i.rows for n, i in infos.items()})


class _NotShardable(Exception):
    pass


@dataclass(frozen=True)
class ScatterGather:
    """A validated decomposition: ``fragment(i)`` is the per-shard query
    (sharded refs renamed to their shard-i registrations), ``merge``/
    ``merge_by`` name the gather."""
    query: PolyOp
    n_shards: int
    merge: str                    # concat | sum | kmerge
    merge_by: Optional[str]       # kmerge sort column
    sharded_names: Tuple[str, ...]
    wrap_scope: bool              # concat roots: deliver the island's model

    def fragment(self, i: int) -> PolyOp:
        if not 0 <= i < self.n_shards:
            raise IndexError(f"shard {i} of {self.n_shards}")
        names = set(self.sharded_names)

        def clone(node):
            if isinstance(node, Ref):
                return Ref(shard_name(node.name, i)) if node.name in names \
                    else node
            return PolyOp(op=node.op, island=node.island,
                          inputs=tuple(clone(x) for x in node.inputs),
                          attrs=dict(node.attrs))

        frag = clone(self.query)
        if self.wrap_scope:
            frag = scope(self.query.island, frag)
        return frag


def analyze(query: PolyOp, sharded: Dict[str, int],
            kinds: Dict[str, str],
            rows: Optional[Dict[str, int]] = None
            ) -> Optional[ScatterGather]:
    """Decide whether ``query`` decomposes over its sharded leaves.

    ``sharded`` maps table name -> shard count for every sharded
    registration; ``kinds`` maps table name -> container kind (``"dense"``,
    ``"columnar"``, ...); ``rows`` (optional) maps name -> registered row
    count — required to co-shard TWO different tables in one query (``add``),
    whose row ranges only align when the counts match.  Returns ``None``
    whenever any op on the sharded lineage is not row-decomposable — the
    caller falls back to the unsharded path, so a ``None`` is never wrong,
    only slower.
    """
    names = tuple(sorted({r.name for r in query.refs() if r.name in sharded}))
    if not names:
        return None
    counts = {sharded[n] for n in names}
    if len(counts) != 1:
        return None                       # mixed shard counts cannot align
    n_shards = counts.pop()
    if len(names) > 1:
        # two sharded tables must partition on identical row ranges
        nrows = {rows.get(n) for n in names} if rows else {None}
        if len(nrows) != 1 or None in nrows:
            return None

    def visit(node, is_root):
        # -> (lineage_sharded, lineage_kind)
        if isinstance(node, Ref):
            return node.name in sharded, kinds.get(node.name, "columnar")
        child = [visit(x, False) for x in node.inputs]
        if not any(s for s, _ in child):
            return False, _KIND_OUT.get(node.op) or \
                (child[0][1] if child else "columnar")
        if node.op == SCOPE_OP:
            raise _NotShardable          # boundary inside the sharded lineage
        if node.op in _AGG:
            if not is_root:
                raise _NotShardable      # aggregates only merge at the root
            _, allowed = _AGG[node.op]
            if child[0][1] not in allowed or not child[0][0] \
                    or any(s for s, _ in child[1:]):
                raise _NotShardable
            return True, "dense" if node.op == "count" else "columnar"
        policy = _ROWWISE.get(node.op)
        if policy is None:
            raise _NotShardable          # distinct/tfidf/knn/transpose/...
        positions, allowed = policy
        for pos, (s, k) in enumerate(child):
            if s and pos not in positions:
                raise _NotShardable      # sharded data on a replicated slot
            if pos in positions and not s and any(q for q, _ in child):
                # ops whose sharded slots must shard TOGETHER (add): one
                # sharded + one replicated operand cannot align row ranges
                if len(positions) > 1:
                    raise _NotShardable
        lineage = next(k for s, k in child if s)
        if lineage not in allowed:
            raise _NotShardable
        out = _KIND_OUT.get(node.op)
        return True, lineage if out is None else out

    try:
        root_sharded, _ = visit(query, True)
    except _NotShardable:
        return None
    if not root_sharded:
        return None
    if query.op in _AGG:
        merge, _ = _AGG[query.op]
        merge_by = query.attrs.get("by") if merge == "kmerge" else None
        wrap = False
    else:
        merge, merge_by, wrap = "concat", None, True
    return ScatterGather(query=query, n_shards=n_shards, merge=merge,
                         merge_by=merge_by, sharded_names=names,
                         wrap_scope=wrap)


def gather(sg: ScatterGather, parts):
    """Reassemble per-shard fragment results (numpy-only — safe in a
    master process that never touches the device)."""
    from repro_torch.core.executor import merge_shard_results
    out, _ = merge_shard_results(sg.merge, parts, by=sg.merge_by)
    return out


def run_scatter_gather(sg: ScatterGather,
                       run_fragment: Callable[[int, PolyOp], object]):
    """Sequential reference execution of the decomposition: run every
    fragment through ``run_fragment(shard_index, fragment_query)`` and
    gather.  The procpool fans fragments out to distinct workers instead,
    then calls the same ``gather`` — this form is the correctness oracle
    the property suite compares against."""
    parts = [run_fragment(i, sg.fragment(i)) for i in range(sg.n_shards)]
    return gather(sg, parts)
