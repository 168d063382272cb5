"""Incremental update plans for streaming appends (DBSP-style IVM).

The DBSP framework (SNIPPETS.md §2) treats tables as Z-sets and a query as
a circuit: for LINEAR operators the circuit lifted to change streams is the
operator itself (Q(a + Δa) = Q(a) + Q(Δa)), bilinear operators obey the
chain rule (Δ(a⋈b) = Δa⋈b + a⋈Δb + Δa⋈Δb), and everything else needs
either a folding rule into materialized state or a full recompute.  This
module is that derivation for the PolyOp IR, specialized to the one change
class the STREAM island produces: **rows appended to the end of a table**.

An append is exactly a 2-shard contiguous row-range decomposition —
``[old prefix, appended suffix]`` — so incremental eligibility is the
scatter–gather algebra of ``core/shardplan.py`` re-read vertically: the
``_ROWWISE`` table lists the linear ops (select, project, scale, add,
matmul/spmm/join with replicated right operands, haar, bin_hist,
window_agg) whose output rows for the suffix ARE the suffix of the full
output, and ``_AGG`` lists the decomposable aggregates whose delta
contributions FOLD into the materialized state (count and groupby_sum by
position-wise sum, sort by ordered 2-way merge).  Two append-specific
rules extend the shard algebra:

* ``concat(a, b)`` with the delta on the LAST input collapses to the delta
  subtree itself — concatenation is append composition, the purest linear
  op of the family.
* ``join`` keeps only the Δa⋈b chain-rule term (delta on the LEFT, right
  replicated): the sort-merge join orders output by left row index, so a
  left append IS an output append.  The a⋈Δb and Δa⋈Δb terms interleave
  per-left-row and cannot be patched by concatenation, so a right-side
  delta falls back to recompute — slower, never wrong.

``derive`` returns ``None`` for anything unprovable (scope boundaries in
the delta lineage — casts like dense→columnar explode rows and are not
append-preserving; tfidf — global document frequencies and l2 norms;
distinct, knn, transpose — a row append becomes a column append).  The
caller then recomputes in full and re-materializes: a ``None`` is never
wrong, only slower.  The returned fragment re-binds every changed ref
``name`` to ``delta_name(name)`` — the caller registers the pending
suffix rows under that name in a temporary catalog and executes the
fragment through the ordinary planner/executor path, so health, monitor
and cost-model channels stay live for delta serves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from repro_torch.core import tables
from repro_torch.core.islands import scope
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref
from repro_torch.core.shardplan import _AGG, _KIND_OUT, _ROWWISE

# suffix under which a changed table's pending delta rows are bound in the
# temporary execution catalog ("A" -> "A@delta"); '@' keeps the binding out
# of any namespace a user registration can occupy (register() names flow
# into qlang identifiers, which cannot contain '@')
DELTA_SUFFIX = "@delta"


def delta_name(name: str) -> str:
    """Temporary-catalog name of ``name``'s pending appended rows."""
    return name + DELTA_SUFFIX


@dataclass(frozen=True)
class UpdatePlan:
    """A validated incremental update: run ``fragment`` against the pending
    deltas (changed refs re-bound to their ``delta_name``), then patch the
    materialized view with ``apply_update`` — ``concat`` appends rows,
    ``sum`` folds aggregate contributions position-wise, ``kmerge`` merges
    two sorted runs on ``merge_by``."""
    fragment: PolyOp
    merge: str                    # concat | sum | kmerge
    merge_by: Optional[str]       # kmerge sort column
    changed: Tuple[str, ...]      # refs the fragment re-binds to deltas


class _NotIncremental(Exception):
    pass


def derive(query: PolyOp, changed: Set[str],
           kinds: Dict[str, str]) -> Optional[UpdatePlan]:
    """Derive the incremental update plan for ``query`` after appends to the
    tables in ``changed`` (``kinds`` maps table name -> container kind; row
    semantics follow the SOURCE container, like ``shardplan.analyze``).
    Returns ``None`` when any operator on the delta lineage is not
    provably append-preserving — the caller must then recompute in full."""
    names = tuple(sorted(n for n in changed
                         if any(r.name == n for r in query.refs())))
    if not names:
        return None
    hot = set(names)

    def visit(node, is_root):
        # -> (delta_lineage, lineage_kind, fragment_subtree)
        if isinstance(node, Ref):
            if node.name in hot:
                return True, kinds.get(node.name, "columnar"), \
                    Ref(delta_name(node.name))
            return False, kinds.get(node.name, "columnar"), node
        child = [visit(x, False) for x in node.inputs]
        if not any(s for s, _, _ in child):
            # untouched subtree: reused verbatim inside the fragment (it
            # recomputes against the replicated full tables, exactly like a
            # replicated operand in a scatter-gather fragment)
            return False, _KIND_OUT.get(node.op) or \
                (child[0][1] if child else "columnar"), node
        if node.op == SCOPE_OP:
            # an island boundary casts the payload; casts are not
            # append-preserving (dense->columnar explodes rows)
            raise _NotIncremental
        if node.op == "concat":
            # concat(a, b): appending rows to the LAST input appends the
            # same rows to the output, so the update fragment is just the
            # delta of that input.  A delta on any earlier input would land
            # mid-output — not patchable by concatenation
            if any(s for s, _, _ in child[:-1]) or not child[-1][0]:
                raise _NotIncremental
            _, k, sub = child[-1]
            return True, k, sub
        if node.op in _AGG:
            if not is_root:
                raise _NotIncremental    # aggregates only fold at the root
            _, allowed = _AGG[node.op]
            if child[0][1] not in allowed or not child[0][0] \
                    or any(s for s, _, _ in child[1:]):
                raise _NotIncremental
            frag = PolyOp(op=node.op, island=node.island,
                          inputs=tuple(sub for _, _, sub in child),
                          attrs=dict(node.attrs))
            return True, "dense" if node.op == "count" else "columnar", frag
        policy = _ROWWISE.get(node.op)
        if policy is None:
            raise _NotIncremental        # distinct/tfidf/knn/transpose/...
        positions, allowed = policy
        for pos, (s, _, _) in enumerate(child):
            if s and pos not in positions:
                raise _NotIncremental    # delta on a replicated slot (e.g.
                #                          the right side of a join/matmul)
            if pos in positions and not s and len(positions) > 1:
                # ops whose hot slots must change TOGETHER (add): one grown
                # and one unchanged operand cannot align row ranges
                raise _NotIncremental
        lineage = next(k for s, k, _ in child if s)
        if lineage not in allowed:
            raise _NotIncremental
        frag = PolyOp(op=node.op, island=node.island,
                      inputs=tuple(sub for _, _, sub in child),
                      attrs=dict(node.attrs))
        out = _KIND_OUT.get(node.op)
        return True, lineage if out is None else out, frag

    try:
        root_delta, _, frag = visit(query, True)
    except _NotIncremental:
        return None
    if not root_delta:
        return None
    if query.op in _AGG:
        merge, _ = _AGG[query.op]
        merge_by = query.attrs.get("by") if merge == "kmerge" else None
    else:
        # row-wise root: wrap the fragment in scope(root island) so the
        # delta result arrives in the island's data model no matter which
        # engine the fragment's own plan picked — the patch concatenates it
        # onto the view, which is ALSO delivered in that model
        merge, merge_by = "concat", None
        frag = scope(query.island, frag)
    return UpdatePlan(fragment=frag, merge=merge, merge_by=merge_by,
                      changed=names)


def apply_update(up: UpdatePlan, view_value, delta_value):
    """Patch a materialized view with one delta-fragment result.  The merge
    primitives are the scatter-gather ones (``core/tables.py``): the view is
    shard 0 (the old prefix's result), the delta result is shard 1."""
    if up.merge == "concat":
        return tables.concat_shards([view_value, delta_value])
    if up.merge == "sum":
        return tables.sum_shards([view_value, delta_value])
    if up.merge == "kmerge":
        return tables.kmerge_shards([view_value, delta_value],
                                    by=up.merge_by)
    raise ValueError(f"unknown merge {up.merge!r}")
