"""Query planner (paper §III-C-1): collapse the PolyOp DAG into *containers*
(maximal runs executable on one engine) plus the cross-engine *remainder*,
then run a k-best dynamic program over the cast edges with a calibrated cost
model (predicted op seconds + predicted cast seconds from estimated container
sizes).

The DP considers the FULL container-assignment space — unlike the seed's
``itertools.product`` prefix, which was biased toward the first node's
candidates and truncated anything past 16 combos.  Containers are formed
*losslessly* (nodes merge only when their candidate engine sets are equal), so
every hybrid plan a node-granularity product could express at container
boundaries survives; splitting an equal-candidate run across engines is the
one shape dropped, and it always pays an extra cast for zero coverage gain.
The monitor still re-orders the survivors with measured history in production
phase (paper §III-C-3).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import (CostModel, container_elems,
                                  container_kind_nbytes,
                                  kind_nbytes_from_logical)
from repro_torch.core.errors import PlanInfeasible
from repro_torch.core.islands import ISLANDS, scope_candidates
from repro_torch.core.engines import ENGINES
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref

# the empty engine mask (planning with every engine available)
NO_MASK: FrozenSet[str] = frozenset()

_DEFAULT_COST_MODEL: Optional[CostModel] = None


def default_cost_model() -> CostModel:
    """Process-wide fallback model (uncalibrated defaults) for callers that
    plan outside a BigDAWG instance."""
    global _DEFAULT_COST_MODEL
    if _DEFAULT_COST_MODEL is None:
        _DEFAULT_COST_MODEL = CostModel()
    return _DEFAULT_COST_MODEL


@dataclass(frozen=True)
class Plan:
    """Engine assignment per op node, keyed by *post-order position* — stable
    across structurally-identical query rebuilds (unlike object identity), so
    monitor-stored plan keys apply to re-issued queries (paper §III-C-3)."""
    assignment: Tuple[Tuple[int, str], ...]

    @property
    def key(self) -> str:
        return "|".join(f"{u}:{e}" for u, e in self.assignment)

    def engine_map(self, query: PolyOp) -> Dict[int, str]:
        """node uid -> engine, for this specific query instance."""
        amap = dict(self.assignment)
        return {n.uid: amap[i] for i, n in enumerate(query.nodes())}

    def describe(self, query: PolyOp) -> str:
        amap = dict(self.assignment)
        return " ".join(f"{n.op}@{amap[i]}"
                        for i, n in enumerate(query.nodes()))


def node_candidates(node: PolyOp,
                    mask: FrozenSet[str] = NO_MASK) -> Sequence[str]:
    """Engines that can run ``node``, minus any in ``mask`` (tripped
    breakers / a degrade mask — see ``core.health``).  Raises
    ``PlanInfeasible`` when the mask eats the whole candidate set: no
    engine assignment containing this node can exist."""
    if node.op == SCOPE_OP:
        # an island boundary materializes on the target island's model-native
        # engines only — the DP's cast edge into this node is therefore the
        # inter-island cast, priced like any other edge (multi-hop routed,
        # sized per hop) by cast_seconds
        cands = scope_candidates(node.island)
    else:
        cands = ISLANDS[node.island].candidates(node.op)
    if not mask:
        return cands
    alive = [e for e in cands if e not in mask]
    if not alive:
        raise PlanInfeasible(node.op, node.island, masked=tuple(cands))
    return alive


@dataclass
class ContainerInfo:
    nodes: List[PolyOp] = field(default_factory=list)
    candidates: Tuple[str, ...] = ()


def find_containers(query: PolyOp) -> List[ContainerInfo]:
    """Greedy bottom-up grouping: merge a node into its child's container when
    they share a candidate engine; otherwise start a new container (a cast
    edge — part of the remainder).  Used for remainder analysis; the planner's
    DP uses the lossless ``plan_containers`` grouping instead."""
    containers: List[ContainerInfo] = []
    owner: Dict[int, int] = {}            # node uid -> container index

    for node in query.nodes():            # post-order
        cands = tuple(node_candidates(node))
        merged = False
        for inp in node.inputs:
            if isinstance(inp, PolyOp):
                ci = owner[inp.uid]
                shared = tuple(e for e in containers[ci].candidates
                               if e in cands)
                if shared and not merged:
                    containers[ci].nodes.append(node)
                    containers[ci].candidates = shared
                    owner[node.uid] = ci
                    merged = True
        if not merged:
            containers.append(ContainerInfo([node], cands))
            owner[node.uid] = len(containers) - 1
    return containers


# ---------------------------------------------------------------------------
# size estimation — predicted output bytes per node, from catalog shapes
# ---------------------------------------------------------------------------

_SCALAR_OPS = {"count", "distinct"}


def _ref_size(ref: Ref, catalog) -> Tuple[float, Optional[Tuple[int, ...]]]:
    """(logical bytes, shape) of a catalog object.  LOGICAL: 4 bytes per
    container_elems unit, the same unit op rates are observed in — a columnar
    home's 3x physical triples blow-up must not inflate predicted op work
    (cast costs use physical nbytes separately)."""
    if catalog is not None and ref.name in catalog:
        obj = catalog[ref.name].obj
        data = getattr(obj, "data", None)
        shape = tuple(data.shape) if data is not None else \
            tuple(getattr(obj, "shape", ()) or ()) or None
        return 4.0 * container_elems(obj), shape
    return 4096.0, None                   # unknown object: assume a small page


def estimate_sizes_shapes(query: PolyOp, catalog=None,
                          measured: Optional[Dict[int, float]] = None,
                          measured_shapes: Optional[Dict[int, Tuple[int, ...]]]
                          = None
                          ) -> Tuple[Dict[int, float],
                                     Dict[int, Optional[Tuple[int, ...]]]]:
    """(uid -> predicted output bytes, uid -> predicted output shape),
    propagated bottom-up with per-op rules (shape-aware where the catalog
    gives real shapes).

    ``measured`` — actual logical output bytes per post-order position, from
    ``Monitor.measured_sizes`` — overrides the bytes rule for any node it
    covers; downstream propagation then builds on the observed value.  This
    is the size-feedback half of the §III-C monitor loop: ops whose output is
    data-dependent (select, join, distinct) get real sizes on re-plans.

    ``measured_shapes`` — actual dense-equivalent output shapes per
    post-order position, from ``Monitor.measured_shapes`` — overrides the
    propagated shape the same way, so downstream shape-driven rules (matmul,
    transpose, bin_hist) build on observed geometry, not just observed
    bytes."""
    nbytes: Dict[int, float] = {}
    shapes: Dict[int, Optional[Tuple[int, ...]]] = {}

    for pos, node in enumerate(query.nodes()):   # post-order: inputs done
        ins: List[Tuple[float, Optional[Tuple[int, ...]]]] = []
        for inp in node.inputs:
            if isinstance(inp, Ref):
                ins.append(_ref_size(inp, catalog))
            else:
                ins.append((nbytes[inp.uid], shapes.get(inp.uid)))
        in_bytes = [b for b, _ in ins] or [4096.0]
        out_b, out_s = max(in_bytes), (ins[0][1] if ins else None)

        op = node.op
        if op in _SCALAR_OPS:
            out_b, out_s = 8.0, ()
        elif op == "matmul" and len(ins) == 2:
            s1, s2 = ins[0][1], ins[1][1]
            if s1 and s2 and len(s1) == 2 and len(s2) == 2:
                out_s = (s1[0], s2[1])
                out_b = 4.0 * s1[0] * s2[1]
        elif op in ("spmm",) and len(ins) == 2:
            out_b, out_s = ins[1][0], ins[1][1]
        elif op == "transpose":
            if out_s and len(out_s) == 2:
                out_s = (out_s[1], out_s[0])
        elif op == "knn":
            out_b, out_s = 4.0 * node.attrs.get("k", 8), None
        elif op == "window_agg":
            s = ins[0][1]
            out_b = 4.0 * s[0] if s else in_bytes[0] / 16.0
            out_s = (s[0],) if s else None
        elif op == "bin_hist":
            s = ins[0][1]
            width = node.attrs.get("nbins", 16) * (node.attrs.get("levels", 1) + 1)
            if s:
                out_s = (s[0], width)
                out_b = 4.0 * s[0] * width
        elif op == "project":
            out_b = in_bytes[0] * 0.5
        elif op == "concat":
            out_b = float(sum(in_bytes))
            s1, s2 = (ins[0][1], ins[1][1]) if len(ins) == 2 else (None, None)
            out_s = (s1[0] + s2[0],) + tuple(s1[1:]) \
                if s1 and s2 and len(s1) == len(s2) and s1[1:] == s2[1:] \
                else None
        # select/haar/tfidf/scale/add/join/groupby_sum/ingest/to_array:
        # output ~ input size (the max-input default).  scope (island
        # boundary) is the identity on logical content — the single-input
        # default already passes bytes and shape through unchanged.

        if measured is not None and pos in measured:
            out_b = measured[pos]        # observation beats any bytes rule
        if measured_shapes is not None and pos in measured_shapes:
            out_s = tuple(measured_shapes[pos])   # ... and any shape rule
        nbytes[node.uid] = max(out_b, 4.0)
        shapes[node.uid] = out_s
    return nbytes, shapes


def estimate_sizes(query: PolyOp, catalog=None,
                   measured: Optional[Dict[int, float]] = None,
                   measured_shapes: Optional[Dict[int, Tuple[int, ...]]] = None
                   ) -> Dict[int, float]:
    """uid -> predicted output bytes (see ``estimate_sizes_shapes``, which
    also returns the propagated shapes the cast-edge sizing uses)."""
    return estimate_sizes_shapes(query, catalog, measured, measured_shapes)[0]


def _edge_kind_nbytes(logical_bytes: float,
                      shape: Optional[Tuple[int, ...]]) -> Dict[str, float]:
    """Per-kind physical bytes of a node-output payload crossing a cast edge
    (the planner-side analogue of ``container_kind_nbytes`` for objects that
    do not exist yet)."""
    return kind_nbytes_from_logical(logical_bytes, shape)


def _work_elems(node: PolyOp, sizes: Dict[int, float], catalog) -> float:
    """INPUT elements an op must touch, in float32 units — the same unit the
    executor and calibration observe rates in (elems of the args, before the
    op runs), so predicted seconds = elems / learned_rate is dimensionally
    honest."""
    total = 0.0
    for inp in node.inputs:
        if isinstance(inp, Ref):
            total += _ref_size(inp, catalog)[0]
        else:
            total += sizes[inp.uid]
    return total / 4.0


# ---------------------------------------------------------------------------
# lossless planning containers + cast-edge DP
# ---------------------------------------------------------------------------

@dataclass
class PlanContainer:
    """A maximal run of nodes with *identical* candidate sets (lossless:
    container-level assignment spans the same plan space as node-level at
    every cast boundary)."""
    positions: List[int]                       # post-order indices
    nodes: List[PolyOp]
    candidates: Tuple[str, ...]
    children: List[Tuple[int, float, Optional[Tuple[int, ...]]]] = \
        field(default_factory=list)
    # (child container index, predicted bytes over that cast edge, predicted
    #  dense-equivalent shape of the crossing payload — sizes the cast's
    #  per-format hops)


def plan_containers(query: PolyOp, catalog=None,
                    sizes: Optional[Dict[int, float]] = None,
                    shapes: Optional[Dict[int, Optional[Tuple[int, ...]]]]
                    = None,
                    mask: FrozenSet[str] = NO_MASK) -> List[PlanContainer]:
    """Containers over the query's TREE UNFOLDING: ownership is tracked per
    post-order *occurrence*, not per node uid, so shared subtrees (which the
    executor and ``plan_cost`` both account once per occurrence) contract to
    a tree of containers — no cycles, no double-visited children.  The owner
    of position ``p`` is the container whose ``positions`` include ``p``."""
    if sizes is None:
        sizes, shapes = estimate_sizes_shapes(query, catalog)
    shapes = shapes or {}
    containers: List[PlanContainer] = []
    owner_by_pos: Dict[int, int] = {}
    counter = itertools.count()

    def visit(node: PolyOp) -> int:
        child_pos = [(visit(i), i) for i in node.inputs
                     if isinstance(i, PolyOp)]
        pos = next(counter)                    # == post-order walk position
        cands = tuple(node_candidates(node, mask))
        ci_own = None
        edges: List[Tuple[int, float, Optional[Tuple[int, ...]]]] = []
        for p, inp in child_pos:
            ci = owner_by_pos[p]
            if ci_own is None and containers[ci].candidates == cands:
                containers[ci].positions.append(pos)
                containers[ci].nodes.append(node)
                ci_own = ci
            else:
                edges.append((ci, sizes[inp.uid], shapes.get(inp.uid)))
        if ci_own is None:
            containers.append(PlanContainer([pos], [node], cands))
            ci_own = len(containers) - 1
        owner_by_pos[pos] = ci_own
        containers[ci_own].children.extend(
            (d, b, s) for d, b, s in edges if d != ci_own)
        return pos

    visit(query)
    return containers


def _intra_cost(c: PlanContainer, engine: str, sizes, catalog,
                cm: CostModel) -> float:
    """Op seconds for the container's nodes on `engine`, plus casts pulling
    catalog refs homed on a different data model."""
    kind = ENGINES[engine].kind
    cost = 0.0
    for node in c.nodes:
        cost += cm.op_seconds(engine, node.op, _work_elems(node, sizes, catalog))
        for inp in node.inputs:
            if isinstance(inp, Ref) and catalog is not None \
                    and inp.name in catalog:
                entry = catalog[inp.name]
                src_kind = ENGINES[entry.engine].kind
                cost += cm.cast_seconds(src_kind, kind, entry.obj.nbytes,
                                        container_kind_nbytes(entry.obj))
    return cost


def dp_plans(query: PolyOp, catalog=None, max_plans: int = 16,
             cost_model: Optional[CostModel] = None,
             measured_sizes: Optional[Dict[int, float]] = None,
             measured_shapes: Optional[Dict[int, Tuple[int, ...]]] = None,
             mask: FrozenSet[str] = NO_MASK) -> List[Tuple[float, Plan]]:
    """Exact k-best DP over the container tree: for every container and engine
    choice, combine the k cheapest child subplans through the cast edge cost.
    Covers the full container-assignment product (no truncation bias).

    Cast edges are costed by ``CostModel.cast_seconds``, which routes
    multi-hop over the calibrated cast graph — a coo->dense->columnar detour
    beats a direct pair measured slow — with every hop sized from its
    intermediate format.  ``measured_sizes`` / ``measured_shapes`` (from
    ``Monitor.measured_sizes`` / ``measured_shapes``) replace rule-derived
    estimates with actual intermediate sizes and shapes wherever the
    signature has execution history.

    ``mask`` excludes engines from every candidate set (failover
    re-planning around tripped circuit breakers); a mask that leaves some
    op with no engine raises ``PlanInfeasible``."""
    cm = cost_model or default_cost_model()
    sizes, shapes = estimate_sizes_shapes(query, catalog,
                                          measured=measured_sizes,
                                          measured_shapes=measured_shapes)
    containers = plan_containers(query, catalog, sizes=sizes, shapes=shapes,
                                 mask=mask)
    k = max(1, max_plans)

    pos_owner: Dict[int, int] = {}
    for ci, c in enumerate(containers):
        for p in c.positions:
            pos_owner[p] = ci
    n_pos = len(query.nodes())
    root_ci = pos_owner[n_pos - 1]

    # merging a node into an *earlier* child's container can leave edges to
    # higher-indexed containers, so process the container tree bottom-up
    # explicitly rather than by list index
    order: List[int] = []
    seen_ci = set()

    def _order(ci: int):
        if ci in seen_ci:
            return
        seen_ci.add(ci)
        for di, _, _ in containers[ci].children:
            _order(di)
        order.append(ci)

    _order(root_ci)

    # kbest[ci] = sorted [(cost, {container_idx: engine})], child-closed
    kbest: Dict[int, List[Tuple[float, Dict[int, str]]]] = {}
    for ci in order:                           # children precede parents
        c = containers[ci]
        options: List[Tuple[float, Dict[int, str]]] = []
        for e in c.candidates:
            kind = ENGINES[e].kind
            combos = [(_intra_cost(c, e, sizes, catalog, cm), {ci: e})]
            for (di, edge_bytes, edge_shape) in c.children:
                edge_kn = _edge_kind_nbytes(edge_bytes, edge_shape)
                merged: List[Tuple[float, Dict[int, str]]] = []
                for cc, asg in combos:
                    for cd, asg_d in kbest[di]:
                        f = asg_d[di]
                        cast = cm.cast_seconds(ENGINES[f].kind, kind,
                                               edge_bytes, edge_kn)
                        merged.append((cc + cd + cast, {**asg, **asg_d}))
                merged.sort(key=lambda t: t[0])
                combos = merged[:k]
            options.extend(combos)
        # keep the top-k PER ENGINE (not a global cut): a parent's cast term
        # depends on this container's engine, so truncating away every plan
        # that ends on some engine could hide the global optimum behind an
        # expensive cast.  Per-engine fronts make the root's k-front exact.
        options.sort(key=lambda t: t[0])
        kbest[ci] = options

    # Execution collapses all occurrences of a shared node to ONE engine
    # (Plan.engine_map is uid-keyed, last occurrence wins), so on DAGs with
    # shared subtrees the per-occurrence DP is a candidate generator: collapse
    # each assignment to uid-consistent engines and re-cost under the executed
    # semantics.  For trees this whole step is the identity.
    nodes = query.nodes()
    has_shared = len({n.uid for n in nodes}) != len(nodes)
    out: List[Tuple[float, Plan]] = []
    seen = set()
    for cost, asg in kbest[root_ci]:
        plan = Plan(tuple((p, asg[pos_owner[p]]) for p in range(n_pos)))
        if has_shared:
            amap = plan.engine_map(query)
            plan = Plan(tuple((p, amap[nodes[p].uid]) for p in range(n_pos)))
            cost = plan_cost(query, plan, catalog, cm, sizes=sizes,
                             shapes=shapes)
        if plan.key not in seen:
            seen.add(plan.key)
            out.append((cost, plan))
    out.sort(key=lambda t: t[0])
    return out[:k]


def exhaustive_plans(query: PolyOp, catalog=None,
                     cost_model: Optional[CostModel] = None,
                     measured_sizes: Optional[Dict[int, float]] = None,
                     measured_shapes: Optional[Dict[int, Tuple[int, ...]]]
                     = None,
                     mask: FrozenSet[str] = NO_MASK
                     ) -> List[Tuple[float, Plan]]:
    """Brute-force reference over the container assignment product, costed
    with the same model — the DP must agree with this on small DAGs (masked
    or not)."""
    cm = cost_model or default_cost_model()
    sizes, shapes = estimate_sizes_shapes(query, catalog,
                                          measured=measured_sizes,
                                          measured_shapes=measured_shapes)
    containers = plan_containers(query, catalog, sizes=sizes, shapes=shapes,
                                 mask=mask)
    pos_owner = {p: ci for ci, c in enumerate(containers) for p in c.positions}
    nodes = query.nodes()
    out, seen = [], set()
    for combo in itertools.product(*(c.candidates for c in containers)):
        plan = Plan(tuple((p, combo[pos_owner[p]])
                          for p in range(len(nodes))))
        amap = plan.engine_map(query)            # collapse shared nodes, as
        plan = Plan(tuple((p, amap[nodes[p].uid])  # execution will
                          for p in range(len(nodes))))
        if plan.key in seen:
            continue
        seen.add(plan.key)
        out.append((plan_cost(query, plan, catalog, cm, sizes=sizes,
                              shapes=shapes), plan))
    out.sort(key=lambda t: t[0])
    return out


def plan_cost(query: PolyOp, plan: Plan, catalog=None,
              cost_model: Optional[CostModel] = None,
              sizes: Optional[Dict[int, float]] = None,
              shapes: Optional[Dict[int, Optional[Tuple[int, ...]]]] = None
              ) -> float:
    """Predicted seconds for an arbitrary assignment: per-node op seconds plus
    cast seconds on every model-crossing edge (node-node and ref-node), each
    cast's hops sized from the format the payload is in at that hop.
    ``sizes``/``shapes`` (from ``estimate_sizes_shapes``) are
    plan-independent — pass them in when costing many plans of one query."""
    cm = cost_model or default_cost_model()
    if sizes is None:
        sizes, shapes = estimate_sizes_shapes(query, catalog)
    shapes = shapes or {}
    amap = plan.engine_map(query)
    cost = 0.0
    for node in query.nodes():
        eng = ENGINES[amap[node.uid]]
        cost += cm.op_seconds(eng.name, node.op,
                              _work_elems(node, sizes, catalog))
        for inp in node.inputs:
            if isinstance(inp, PolyOp):
                src = ENGINES[amap[inp.uid]]
                cost += cm.cast_seconds(
                    src.kind, eng.kind, sizes[inp.uid],
                    _edge_kind_nbytes(sizes[inp.uid], shapes.get(inp.uid)))
            elif catalog is not None and inp.name in catalog:
                entry = catalog[inp.name]
                src_kind = ENGINES[entry.engine].kind
                cost += cm.cast_seconds(src_kind, eng.kind, entry.obj.nbytes,
                                        container_kind_nbytes(entry.obj))
    return cost


def enumerate_plans(query: PolyOp, catalog=None, max_plans: int = 16,
                    cost_model: Optional[CostModel] = None,
                    measured_sizes: Optional[Dict[int, float]] = None,
                    measured_shapes: Optional[Dict[int, Tuple[int, ...]]]
                    = None) -> List[Plan]:
    """Top-``max_plans`` candidate plans by predicted cost, from the k-best
    container DP (full assignment space, cheapest first)."""
    return [p for _, p in dp_plans(query, catalog, max_plans, cost_model,
                                   measured_sizes=measured_sizes,
                                   measured_shapes=measured_shapes)]


# ---------------------------------------------------------------------------
# scatter–gather pricing (partitioned execution over row-range shards)
# ---------------------------------------------------------------------------

# master-side merge throughput (numpy concat / sum / heap merge) and the
# per-fragment pickle+pipe round-trip floor — both deliberately coarse: the
# decision they gate (scatter vs single worker) only needs the right order
# of magnitude, and the procpool can override per deployment
MERGE_BYTES_PER_S = 2e9
IPC_OVERHEAD_S = 2e-3


@dataclass
class ScatterGatherPrice:
    """Predicted seconds for both execution shapes of one sharded query —
    what ``procpool`` compares to choose scatter–gather vs a single worker."""
    sharded_s: float
    unsharded_s: float
    fragment_s: float        # one fragment on one worker
    merge_s: float           # master-side gather
    ipc_s: float             # total dispatch round-trip overhead

    @property
    def worthwhile(self) -> bool:
        return self.sharded_s < self.unsharded_s


def price_scatter_gather(query: PolyOp, fragment: PolyOp, catalog=None,
                         n_shards: int = 1, workers: int = 1,
                         cost_model: Optional[CostModel] = None,
                         measured_sizes: Optional[Dict[int, float]] = None,
                         measured_shapes: Optional[Dict[int, Tuple[int, ...]]]
                         = None,
                         ipc_overhead_s: float = IPC_OVERHEAD_S,
                         merge_bytes_per_s: float = MERGE_BYTES_PER_S
                         ) -> ScatterGatherPrice:
    """Price the scatter–gather plan shape against the unsharded best plan.

    The fragment's cost comes from the same k-best DP, run against the
    per-shard catalog entries (``A#i`` is ~1/N the rows of ``A``, so the DP's
    size rules price the smaller operands naturally).  Fragments run on
    distinct workers, so wall-clock fragment time is one fragment per round
    of ``workers`` concurrent shards; the gather adds the merged payload over
    the master's merge throughput, and each dispatched fragment pays one IPC
    round-trip."""
    cm = cost_model or default_cost_model()
    unsharded = dp_plans(query, catalog, max_plans=1, cost_model=cm,
                         measured_sizes=measured_sizes,
                         measured_shapes=measured_shapes)[0][0]
    fragment_s = dp_plans(fragment, catalog, max_plans=1,
                          cost_model=cm)[0][0]
    sizes, _ = estimate_sizes_shapes(query, catalog, measured=measured_sizes,
                                     measured_shapes=measured_shapes)
    root_bytes = sizes[query.nodes()[-1].uid]
    rounds = math.ceil(n_shards / max(1, workers))
    merge_s = root_bytes / max(merge_bytes_per_s, 1.0)
    ipc_s = n_shards * ipc_overhead_s
    sharded = rounds * fragment_s + merge_s + ipc_s
    return ScatterGatherPrice(sharded_s=sharded, unsharded_s=unsharded,
                              fragment_s=fragment_s, merge_s=merge_s,
                              ipc_s=ipc_s)


@dataclass(frozen=True)
class IncrementalPrice:
    """Predicted seconds for both ways of serving a streaming signature
    after an append — what the middleware's IVM gate compares.  ``delta_s``
    is the update fragment against the pending delta rows, ``patch_s`` the
    view patch (concat/sum/kmerge over the materialized bytes), ``full_s``
    the cached plan's full recompute baseline (the plan-cache entry's
    prediction, which the replan loop keeps synced to measured serves)."""
    delta_s: float
    patch_s: float
    full_s: float

    @property
    def worthwhile(self) -> bool:
        return self.delta_s + self.patch_s < self.full_s


def price_incremental(fragment: PolyOp, catalog=None,
                      cost_model: Optional[CostModel] = None,
                      view_bytes: float = 0.0, full_s: float = 0.0,
                      merge_bytes_per_s: float = MERGE_BYTES_PER_S,
                      mask: FrozenSet[str] = NO_MASK
                      ) -> Tuple[IncrementalPrice, Plan]:
    """Price the incremental update path for one append and return the
    fragment's plan alongside.  The fragment is costed by the same k=1 DP
    every other cheap re-plan uses, against the TEMPORARY catalog whose
    ``@delta`` entries hold the pending suffix rows — the calibrated size
    rules price the small operands naturally, so a tiny delta prices tiny
    and a delta that dominates the base prices accordingly.  The patch is
    the materialized view plus the delta result through the master-side
    merge throughput (same coarse constant the scatter-gather gate uses:
    the decision only needs the right order of magnitude).

    ``mask`` restricts the fragment's engines: the middleware passes
    everything OUTSIDE the incumbent full plan's engine set, so the delta
    runs only through engine/cast paths the full serve already validated —
    delta operands are tiny, and unconstrained the DP happily flips to a
    cast-heavy placement the incumbent never exercised."""
    cm = cost_model or default_cost_model()
    ranked = dp_plans(fragment, catalog, max_plans=1, cost_model=cm,
                      mask=mask)
    delta_s, fplan = ranked[0]
    sizes, _ = estimate_sizes_shapes(fragment, catalog)
    delta_out = sizes[fragment.nodes()[-1].uid]
    patch_s = (float(view_bytes) + delta_out) / max(merge_bytes_per_s, 1.0)
    return IncrementalPrice(delta_s=delta_s, patch_s=patch_s,
                            full_s=float(full_s)), fplan


def estimate_casts(query: PolyOp, plan: Plan, catalog=None,
                   cost_model: Optional[CostModel] = None) -> float:
    """Planner-side cast cost: predicted seconds of cast traffic a plan
    implies (model-crossing edges only, sized from the catalog)."""
    cm = cost_model or default_cost_model()
    sizes, shapes = estimate_sizes_shapes(query, catalog)
    amap = plan.engine_map(query)
    cost = 0.0
    for node in query.nodes():
        eng = ENGINES[amap[node.uid]]
        for inp in node.inputs:
            if isinstance(inp, PolyOp):
                src = ENGINES[amap[inp.uid]]
                cost += cm.cast_seconds(
                    src.kind, eng.kind, sizes[inp.uid],
                    _edge_kind_nbytes(sizes[inp.uid], shapes.get(inp.uid)))
            elif catalog is not None and inp.name in catalog:
                entry = catalog[inp.name]
                src_kind = ENGINES[entry.engine].kind
                cost += cm.cast_seconds(src_kind, eng.kind, entry.obj.nbytes,
                                        container_kind_nbytes(entry.obj))
    return cost
