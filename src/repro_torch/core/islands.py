"""Islands — the user-facing scope abstraction (paper §III-B).

Each island = (data model, operator set, member engines).  Users build
queries by calling island operators; the island tag on each node is its
*scope*, which tells the planner which shims (engine lowerings) are legal.
Degenerate islands expose a single engine's full op set (semantic
completeness at the price of location transparency).

Cross-island queries are expressed with ``scope(island, subtree)`` (paper
§III: the SCOPE marker says which island's semantics govern a subtree, the
CAST moves data across the boundary): the returned boundary node delivers
``subtree``'s result in ``island``'s data model.  The planner prices the
boundary cast with the calibrated per-pair bandwidths and the executor runs
it through the migrator — see ``ops.SCOPE_OP``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Set, Tuple, Union

from repro_torch.core.engines import ENGINES
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref

# the data model a query scoped to an island is delivered in (paper §III-B:
# each island presents one data model regardless of which member engine ran
# the fragment).  Degenerate islands resolve through ``island_kind``.
ISLAND_KIND = {"array": "dense", "relational": "columnar", "text": "coo",
               "stream": "stream"}


def _as_input(x):
    if isinstance(x, (PolyOp, Ref)):
        return x
    if isinstance(x, str):
        return Ref(x)
    raise TypeError(f"query inputs must be PolyOp/Ref/str, got {type(x)}")


class Island:
    def __init__(self, name: str, ops: Dict[str, Sequence[str]]):
        self.name = name
        self.ops = {op: tuple(engines) for op, engines in ops.items()}

    def candidates(self, op: str) -> Sequence[str]:
        return self.ops[op]

    def _no_such_op(self, op: str) -> str:
        avail = ", ".join(sorted(self.__dict__.get("ops", {})))
        return (f"island {self.name!r} has no operator {op!r}; "
                f"available operators: {avail}")

    def _build(self, op: str, *inputs, **attrs) -> PolyOp:
        if op not in self.ops:
            raise ValueError(self._no_such_op(op))
        return PolyOp(op=op, island=self.name,
                      inputs=tuple(_as_input(i) for i in inputs), attrs=attrs)

    def scope(self, subtree) -> PolyOp:
        """``scope(self.name, subtree)`` — deliver a (possibly foreign-island)
        subtree in this island's data model."""
        return scope(self, subtree)

    def __getattr__(self, op):
        if op.startswith("_"):
            raise AttributeError(op)
        if op not in self.__dict__.get("ops", {}):
            # list the vocabulary: the error is how users discover what an
            # island can do, so hiding the op set behind a bare name is cruel
            raise AttributeError(self._no_such_op(op))
        return lambda *inputs, **attrs: self._build(op, *inputs, **attrs)


# ---------------------------------------------------------------------------
# standard islands (engine lists are ordered by *a-priori* preference; the
# monitor's measured history overrides this ordering in production phase)
# ---------------------------------------------------------------------------

array = Island("array", {
    "matmul": ["dense_array", "columnar"],
    "haar": ["dense_array", "columnar", "stream"],
    "count": ["dense_array", "columnar", "kv_sparse"],
    "distinct": ["dense_array", "columnar", "kv_sparse"],
    "select": ["dense_array", "columnar"],
    "bin_hist": ["dense_array", "columnar"],
    "tfidf": ["dense_array", "columnar", "kv_sparse"],
    "knn": ["dense_array", "columnar", "kv_sparse"],
    "add": ["dense_array"],
    "scale": ["dense_array"],
    "transpose": ["dense_array"],
    "concat": ["dense_array"],
})

relational = Island("relational", {
    "select": ["columnar"],
    "project": ["columnar"],
    "count": ["columnar", "dense_array", "kv_sparse"],
    "distinct": ["columnar", "dense_array", "kv_sparse"],
    "groupby_sum": ["columnar"],
    "sort": ["columnar"],
    "join": ["columnar"],
    "matmul": ["columnar", "dense_array"],
    "haar": ["columnar", "dense_array"],
    "bin_hist": ["columnar", "dense_array"],
    "tfidf": ["columnar", "dense_array", "kv_sparse"],
    "knn": ["columnar", "dense_array", "kv_sparse"],
})

text = Island("text", {
    "tfidf": ["kv_sparse"],
    "spmm": ["kv_sparse"],
    "knn": ["kv_sparse"],
    "count": ["kv_sparse"],
    "distinct": ["kv_sparse"],
    "degree": ["kv_sparse"],
})

stream = Island("stream", {
    "window_agg": ["stream"],
    "haar": ["stream"],
    "to_array": ["stream"],
    "ingest": ["stream"],
})


def degenerate(engine_name: str) -> Island:
    """Full power of one engine, zero location transparency (paper §III-B)."""
    eng = ENGINES[engine_name]
    return Island(f"degenerate:{engine_name}",
                  {op: [engine_name] for op in eng.ops})


ISLANDS: Dict[str, Island] = {
    "array": array, "relational": relational, "text": text, "stream": stream,
}
for _e in ENGINES:
    ISLANDS[f"degenerate:{_e}"] = degenerate(_e)


def island_of(node: PolyOp) -> Island:
    return ISLANDS[node.island]


# ---------------------------------------------------------------------------
# island boundaries (paper §III: SCOPE marks the governing island, CAST moves
# the data) — the cross-island half of the IR
# ---------------------------------------------------------------------------

def island_kind(island_name: str) -> str:
    """The data model an island delivers results in (degenerate islands
    deliver their engine's native kind)."""
    if island_name in ISLAND_KIND:
        return ISLAND_KIND[island_name]
    if island_name.startswith("degenerate:"):
        return ENGINES[island_name.split(":", 1)[1]].kind
    raise ValueError(f"unknown island {island_name!r}; available: "
                     f"{', '.join(sorted(ISLANDS))}")


def scope_candidates(island_name: str) -> Tuple[str, ...]:
    """Engines a boundary node may materialize on: the target island's
    data-model-native members (a degenerate island's single engine).  The
    planner restricts scope nodes to these, so the DP's cast edge into the
    boundary IS the inter-island cast."""
    if island_name.startswith("degenerate:"):
        return (island_name.split(":", 1)[1],)
    kind = island_kind(island_name)
    return tuple(e.name for e in ENGINES.values() if e.kind == kind)


def scope(island: Union[Island, str], subtree) -> PolyOp:
    """Explicit island boundary: deliver ``subtree``'s result in ``island``'s
    data model (paper §III's SCOPE/CAST seam).

    The returned node is the identity on logical content; the planner prices
    the boundary cast from the subtree's engine kind to the island's model
    (multi-hop routed over the calibrated bandwidths, charged per hop) and
    the executor performs it through the migrator.  ``island`` may be an
    ``Island`` or its name (``"array"``, ``"degenerate:dense_array"``, ...).
    """
    name = island.name if isinstance(island, Island) else str(island)
    if name not in ISLANDS:
        raise ValueError(f"unknown island {name!r}; available: "
                         f"{', '.join(sorted(ISLANDS))}")
    return PolyOp(op=SCOPE_OP, island=name, inputs=(_as_input(subtree),))
