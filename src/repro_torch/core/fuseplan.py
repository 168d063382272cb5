"""Plan-level fusion: run a cached plan's intra-engine chains as single
callables — on the card, one captured CUDA graph over the hand kernels per
segment and input shapes (the port of ``repro.core.fuseplan``).

The executor dispatches cached plans node-by-node: every op pays a host
round trip (argument gather, engine shim call, kernel launches) even when
the whole chain is pure device math.  This module closes it for the
dense/array family:

  segmentation  ``fuse_plan(query, plan)`` walks the post-order under the
      plan's engine assignment and groups maximal same-engine chains of
      *fusable* ops — ``matmul``, ``add``, ``scale``, ``transpose``,
      ``select``, ``haar``, ``tfidf``, ``knn``, ``count`` on the
      ``dense_array`` engine — into ``FusedSegment``s.  A segment never
      crosses an engine boundary and never absorbs an island-boundary
      (``scope``) node.  Segments, keys and weights are the reference's,
      copied unchanged: the same query and plan give the same segments.

  lowering  each member op is a torch function over raw tensors that
      mirrors ``engines._da_*`` (``haar``/``knn`` through ``kernels.ops``, so
      the hand kernels serve them on the card).  The valid-count is
      threaded as a DEVICE int tensor: a select narrows it with
      ``torch.sum(m)``, ``count`` reads it.  Nothing inside a segment reads
      a value back to the host (the eager ``_da_select`` does, and a graph
      cannot).

  capture  on a CUDA device, the first run of a segment at given external
      shapes and dtypes (its *stamp*) runs the lowered function once
      eagerly — the warm-up builds the kernel library, the cuBLAS handle
      and the allocator blocks, and its launches are real — then captures
      it as one ``torch.cuda.CUDAGraph`` on a side stream, under a
      process-wide lock, with ``capture_error_mode="thread_local"`` (other
      serving threads keep running), and replays it.  Every later run at
      the stamp is a replay.  External data, fills and valid-counts live in
      STATIC device buffers written before each replay (a Python scalar
      handed to a captured op would be baked into the graph); a replay
      overwrites the graph's output tensors, so the result is cloned before
      it reaches a container.  Replays of one graph are serialized by its
      lock, and each waits on the event the previous one recorded, so a
      replay on another stream cannot overwrite buffers still being read.
      The launch counters count a wrapper's calls; a replay calls none, so
      a capture records the counts it made (``kernels.counters``), takes
      them back out, and credits them on every replay.  On the CPU the
      same lowered function runs eagerly as one call.

  fallback  fusion must never change results or turn a servable query into
      an error.  Any failure of the fused call — capture or replay — marks
      the segment key *broken* in a process-wide registry (``mark_broken``)
      and the executor re-runs the members node-by-node in the same host
      task; later serves see the sticky mark and skip the fused attempt.
      ``ExecutionResult.fusion_fallbacks`` counts transitions.

Queries with shared subtrees (one uid at several post-order positions) are
not fused — segmentation is position-keyed so a ``FusedPlan`` survives query
rebuilds, and sharing would break the one-position-per-uid mapping.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import CostModel
from repro_torch.core.ops import SCOPE_OP, PolyOp, Ref
from repro_torch.core.planner import Plan, _work_elems, estimate_sizes_shapes
from repro_torch.core.tables import DenseTensor, to_device
from repro_torch.kernels import counters

# the dense/array fusable family: every op here is pure tensor math over
# DenseTensor.data in engines.py.  ``count`` consumes valid_count METADATA
# rather than data, so the lowering threads a per-member valid-count value
# (a device tensor) through the segment (external counts enter from static
# buffers, a select's mask sum updates it, count reads it) — see
# ``_build_callable``.
# (distinct/bin_hist are still excluded; bin_hist is fusable in principle
# and a natural follow-on)
FUSABLE_OPS = frozenset({"matmul", "add", "scale", "transpose", "select",
                         "haar", "tfidf", "knn", "count"})

# engines whose fusable ops capture (dense/array family first —
# triple-format engines are numpy-eager in places and cannot be captured)
FUSABLE_ENGINES = frozenset({"dense_array"})

# a single-node "chain" gains nothing from fusion (one dispatch either way)
# and would pay a capture per attrs variant — segments need >= 2 members
MIN_SEGMENT_NODES = 2

# -- process-wide segment-callable cache + sticky fallback registry ---------
_COMPILED: Dict[str, Callable] = {}
_BROKEN: Dict[str, str] = {}        # segment key -> failure description
_WARM: set = set()                  # (key, ext shapes/dtypes) runs completed
_GRAPHS: Dict[tuple, "_Captured"] = {}   # CUDA stamp -> captured graph
_REGISTRY_LOCK = threading.Lock()
# one capture at a time, process-wide (captures are rare: one per stamp)
_CAPTURE_LOCK = threading.Lock()


def reset_cache() -> None:
    """Drop all segment callables, captured graphs AND sticky fallback
    marks (tests; a long-lived process never needs this — the captured
    graphs are the point)."""
    with _REGISTRY_LOCK:
        _COMPILED.clear()
        _BROKEN.clear()
        _WARM.clear()
        _GRAPHS.clear()


def is_broken(key: str) -> bool:
    with _REGISTRY_LOCK:
        return key in _BROKEN


def mark_broken(key: str, reason: str) -> None:
    """Sticky per-signature fallback: once a segment key failed to
    capture/run fused, no later serve retries it."""
    with _REGISTRY_LOCK:
        _BROKEN.setdefault(key, reason)
        _COMPILED.pop(key, None)
        for stamp in [s for s in _GRAPHS if s[0] == key]:
            del _GRAPHS[stamp]


def broken_keys() -> Dict[str, str]:
    with _REGISTRY_LOCK:
        return dict(_BROKEN)


@dataclass(frozen=True)
class FusedSegment:
    """One maximal fusable chain of a plan, keyed by post-order position so
    it survives query rebuilds (uids do not).

    ``input_specs[j]`` describes member j's arguments: ``("mem", i)`` is the
    i-th member's output (stays on device inside the segment); ``("ext", s)``
    is the s-th external input.  ``ext_sources[s]`` locates it at execute
    time: ``("ref", name)`` from the catalog, ``("pos", p)`` from the value
    another unit produced at post-order position p."""
    engine: str
    positions: Tuple[int, ...]           # members, dependency (post) order
    ops: Tuple[str, ...]
    attrs_list: Tuple[Tuple[Tuple[str, Any], ...], ...]   # sorted attr items
    input_specs: Tuple[Tuple[Tuple[str, int], ...], ...]
    ext_sources: Tuple[Tuple[str, Any], ...]
    weights: Tuple[float, ...]           # pro-rata time attribution, sums to 1
    key: str                             # structural signature (cache key)

    @property
    def root_pos(self) -> int:
        return self.positions[-1]


@dataclass
class FusedPlan:
    """The fusion pass's output for one (query shape, plan): the segments
    plus the exact structural fingerprint of the query it was built from.
    Signatures bin constant attrs, so two queries can share a signature yet
    differ in exact attr values — the segment callables close over the
    build query's attrs, and the middleware compares ``fingerprint`` before
    reusing a cached FusedPlan (mismatch -> rebuild, not wrong answers)."""
    plan_key: str
    fingerprint: str
    segments: Tuple[FusedSegment, ...] = ()
    # optional runtime.fault.FusionFaultInjector: its on_fuse(key) hook
    # fires just before every fused invocation (the capture-failure seam)
    injector: Any = None

    @property
    def n_fused_nodes(self) -> int:
        return sum(len(s.positions) for s in self.segments)


def query_fingerprint(query: PolyOp) -> str:
    """Exact structural identity of a query instance: islands, ops, EXACT
    attr values, and input wiring — everything a segment callable closes
    over.  Cheaper than ``signature()`` (no hashing, no catalog) and
    stricter (signatures bin constants; this must not)."""
    parts: List[str] = []
    pos_of: Dict[int, int] = {}
    for pos, node in enumerate(query.nodes()):
        pos_of[node.uid] = pos
        ins = ",".join(f"r:{i.name}" if isinstance(i, Ref)
                       else f"n:{pos_of[i.uid]}" for i in node.inputs)
        attrs = ",".join(f"{k}={node.attrs[k]!r}"
                         for k in sorted(node.attrs))
        parts.append(f"{node.island}.{node.op}[{attrs}]({ins})")
    return ";".join(parts)


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def fuse_plan(query: PolyOp, plan: Plan, catalog=None,
              cost_model: Optional[CostModel] = None,
              injector: Any = None,
              min_nodes: int = MIN_SEGMENT_NODES) -> FusedPlan:
    """Segment ``plan``'s post-order into maximal same-engine fusable
    chains.  Always returns a FusedPlan (possibly with no segments — the
    middleware caches it either way so unfusable shapes are analyzed
    once); never raises on an unfusable query."""
    nodes = query.nodes()
    fp = query_fingerprint(query)
    empty = FusedPlan(plan.key, fp, (), injector)
    if len(plan.assignment) != len(nodes):
        return empty
    uids = [n.uid for n in nodes]
    if len(set(uids)) != len(uids):
        # shared subtree: a uid at several positions breaks the positional
        # keying (and a member could gain consumers outside its segment)
        return empty
    pos_of = {uid: pos for pos, uid in enumerate(uids)}
    amap = dict(plan.assignment)         # position -> engine

    def fusable(pos: int, node: PolyOp) -> bool:
        return (node.op != SCOPE_OP and node.op in FUSABLE_OPS
                and amap[pos] in FUSABLE_ENGINES)

    # greedy bottom-up: a fusable node absorbs each fusable same-engine
    # input chain (post-order means input chains are complete when their
    # single consumer — this is a tree — arrives)
    seg_of: Dict[int, int] = {}          # position -> segment id
    members: Dict[int, List[int]] = {}   # segment id -> positions
    next_id = 0
    for pos, node in enumerate(nodes):
        if not fusable(pos, node):
            continue
        sid = next_id
        next_id += 1
        mine = [pos]
        for inp in node.inputs:
            if not isinstance(inp, PolyOp):
                continue
            ip = pos_of[inp.uid]
            isid = seg_of.get(ip)
            if isid is not None and amap[ip] == amap[pos]:
                mine = members.pop(isid) + mine
        members[sid] = mine
        for p in mine:
            seg_of[p] = sid

    segments: List[FusedSegment] = []
    for mine in members.values():
        if len(mine) < min_nodes:
            continue
        mine = sorted(mine)              # ascending post-order = topo order
        segments.append(_build_segment(nodes, pos_of, amap, mine,
                                       query, catalog, cost_model))
    segments.sort(key=lambda s: s.root_pos)
    return FusedPlan(plan.key, fp, tuple(segments), injector)


def _build_segment(nodes, pos_of, amap, mine: List[int], query: PolyOp,
                   catalog, cost_model) -> FusedSegment:
    midx = {p: j for j, p in enumerate(mine)}
    ext_sources: List[Tuple[str, Any]] = []
    ext_slot: Dict[Tuple[str, Any], int] = {}
    specs: List[Tuple[Tuple[str, int], ...]] = []
    for p in mine:
        spec: List[Tuple[str, int]] = []
        for inp in nodes[p].inputs:
            if isinstance(inp, PolyOp) and pos_of[inp.uid] in midx:
                spec.append(("mem", midx[pos_of[inp.uid]]))
                continue
            src = ("ref", inp.name) if isinstance(inp, Ref) \
                else ("pos", pos_of[inp.uid])
            slot = ext_slot.get(src)
            if slot is None:
                slot = ext_slot[src] = len(ext_sources)
                ext_sources.append(src)
            spec.append(("ext", slot))
        specs.append(tuple(spec))
    attrs_list = tuple(tuple(sorted(nodes[p].attrs.items())) for p in mine)
    ops = tuple(nodes[p].op for p in mine)
    engine = amap[mine[0]]
    key = _segment_key(engine, ops, attrs_list, specs, len(ext_sources))
    weights = _segment_weights(query, catalog, cost_model, nodes, mine,
                               engine)
    return FusedSegment(engine, tuple(mine), ops, attrs_list, tuple(specs),
                        tuple(ext_sources), weights, key)


def _segment_key(engine, ops, attrs_list, specs, n_ext) -> str:
    """Structural signature: everything the segment callable's behavior
    depends on (engine, member ops, EXACT attrs, wiring, ext arity) and
    nothing it does not (shapes/dtypes — one CUDA graph is captured per
    shapes/dtypes beneath this key, so structurally-identical segments
    across different queries share one callable)."""
    mem = ";".join(
        f"{op}[{','.join(f'{k}={v!r}' for k, v in attrs)}]"
        f"({','.join(f'{kind}{i}' for kind, i in spec)})"
        for op, attrs, spec in zip(ops, attrs_list, specs))
    return f"{engine}:{n_ext}:{mem}"


def _segment_weights(query, catalog, cost_model, nodes, mine,
                     engine) -> Tuple[float, ...]:
    """Pro-rata attribution weights: the executor splits a fused segment's
    measured seconds across member nodes by *predicted* cost, so
    ``per_node_seconds`` keeps feeding the monitor, drift re-planning and
    the per-engine straggler detectors exactly as unfused serves do."""
    if cost_model is None:
        return tuple([1.0 / len(mine)] * len(mine))
    try:
        sizes, _ = estimate_sizes_shapes(query, catalog)
        pred = [max(cost_model.op_seconds(
                    engine, nodes[p].op,
                    _work_elems(nodes[p], sizes, catalog)), 1e-12)
                for p in mine]
    except Exception:                     # never let sizing sink the fuse
        return tuple([1.0 / len(mine)] * len(mine))
    total = sum(pred)
    return tuple(w / total for w in pred)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def _lower(op: str, attrs: Dict[str, Any], args, fills, vcs,
           want_aux: bool):
    """One member op as a function of tensors — the mirror of
    ``engines._da_*`` (same math, minus the container wrappers).  ``fills``
    aligns with ``args``: the fill each argument's container carries, a 0-d
    device tensor for an external, the constant 0.0 for a member's output
    (engine outputs carry the default fill).  ``vcs`` also aligns with
    ``args``: each argument's valid-count as a 0-d int64 device tensor, or
    ``None`` meaning *full* (resolve with the static ``numel``).  Returns
    ``(out, vc_out, aux)``: ``vc_out`` is the member's output valid-count
    under the same convention (only select narrows it), and ``aux`` is the
    select mask sum when ``want_aux`` (a root select's container must carry
    the eager engine's ``valid_count``).  Reads nothing back to the host."""
    if op == "matmul":
        return torch.matmul(args[0], args[1]), None, None
    if op == "add":
        return args[0] + args[1], None, None
    if op == "scale":
        return args[0] * attrs["factor"], None, None
    if op == "transpose":
        x = args[0]
        return x.permute(*reversed(range(x.ndim))), None, None
    if op == "select":
        lo = attrs.get("lo", -np.inf)
        hi = attrs.get("hi", np.inf)
        m = (args[0] >= lo) & (args[0] <= hi)
        out = torch.where(m, args[0], fills[0])
        vc = torch.sum(m)
        return out, vc, (vc if want_aux else None)
    if op == "count":
        # the eager op is an O(1) metadata lookup; here the metadata is the
        # threaded valid-count (a device tensor for a select upstream or an
        # external, the static size otherwise)
        if vcs[0] is None:
            return torch.full((), args[0].numel(), dtype=torch.int32,
                              device=args[0].device), None, None
        return vcs[0].to(torch.int32), None, None
    if op == "haar":
        from repro_torch.kernels import ops as kops
        return kops.haar(args[0], attrs["levels"]), None, None
    if op == "tfidf":
        from repro_torch.core.engines import tfidf_dense
        return tfidf_dense(args[0]), None, None
    if op == "knn":
        from repro_torch.kernels import ops as kops
        tr, te = args[0], torch.atleast_2d(args[1])
        if tr.dtype != te.dtype or tr.dtype not in (torch.float32,
                                                    torch.bfloat16):
            tr, te = tr.to(torch.float32), te.to(torch.float32)
        idx, _score = kops.knn(tr, te, attrs["k"])
        return idx, None, None
    raise ValueError(f"op {op!r} is not fusable")


def _build_callable(seg: FusedSegment) -> Callable:
    """The segment as one function ``fn(ext, fills, vcs) -> (root, aux)``
    over tensors: ``ext`` the external inputs' data, ``fills`` their fills
    and ``vcs`` their valid-counts, both as 0-d device tensors (static
    buffers under a CUDA graph, so a changed fill or count needs no new
    capture).  Intermediates never leave the device; member-to-member
    fills are the constant 0.0 (engine outputs carry the default fill), and
    the loop threads a per-member valid-count beside the data (select
    narrows it, count reads it)."""
    ops, attrs_list, specs = seg.ops, seg.attrs_list, seg.input_specs
    last = len(ops) - 1

    def fn(ext, fills, vcs):
        mem: List[Any] = []
        mem_vc: List[Any] = []
        aux = None
        for j, (op, attrs, spec) in enumerate(zip(ops, attrs_list, specs)):
            args, afills, avcs = [], [], []
            for kind, i in spec:
                if kind == "ext":
                    args.append(ext[i])
                    afills.append(fills[i])
                    avcs.append(vcs[i])
                else:
                    args.append(mem[i])
                    afills.append(0.0)
                    avcs.append(mem_vc[i])
            out, vc_out, a = _lower(op, dict(attrs), args, afills, avcs,
                                    want_aux=j == last)
            mem.append(out)
            mem_vc.append(vc_out)
            if j == last:
                aux = a
        return mem[-1], aux

    return fn


def compiled_segment(seg: FusedSegment) -> Callable:
    """The process-wide segment callable for a segment key (built once;
    CUDA graphs are captured per shapes/dtypes beneath it)."""
    with _REGISTRY_LOCK:
        fn = _COMPILED.get(seg.key)
        if fn is None:
            fn = _COMPILED[seg.key] = _build_callable(seg)
        return fn


# ---------------------------------------------------------------------------
# CUDA graph capture and replay
# ---------------------------------------------------------------------------

def _fill_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a fill buffer takes so that ``torch.where`` promotes as it
    does with the eager op's Python-float fill: the data's own floating
    dtype, else the default float dtype."""
    return t.dtype if t.is_floating_point() else torch.get_default_dtype()


class _Captured:
    """One segment's CUDA graph at one stamp: the static input buffers it
    reads (external data, fills, valid-counts), the output tensors each
    replay overwrites, and the launch counts its capture recorded."""

    def __init__(self, graph, ext, fills, vcs, outs, deltas):
        self.graph = graph
        self.ext, self.fills, self.vcs = ext, fills, vcs
        self.outs = outs                  # (root, aux or None)
        self.deltas = deltas
        self._lock = threading.Lock()
        self._done = None                 # event after the last copy-out

    def run(self, ext, fills, vcs):
        """Write the inputs into the static buffers, replay, and return
        copies of the outputs (a later replay overwrites the graph's own).
        Serialized per graph; the replay waits, on the caller's stream, for
        the previous caller's copy-out to finish."""
        cuda = self.outs[0].device.type == "cuda"
        with self._lock:
            stream = torch.cuda.current_stream(self.outs[0].device) \
                if cuda else None
            if self._done is not None:
                stream.wait_event(self._done)
            for buf, t in zip(self.ext, ext):
                buf.copy_(t)
            for buf, v in zip(self.fills, fills):
                buf.fill_(v)
            for buf, v in zip(self.vcs, vcs):
                buf.fill_(v)
            self.graph.replay()
            counters.credit(self.deltas)
            outs = tuple(None if o is None else o.clone() for o in self.outs)
            if cuda:
                self._done = self._done or torch.cuda.Event()
                self._done.record(stream)
        return outs


def _capture(fn: Callable, ext, fills, vcs, device) -> _Captured:
    """Warm ``fn`` up eagerly on static copies of its inputs, then capture
    it as one CUDA graph on a side stream.  Called under _CAPTURE_LOCK."""
    s_ext = tuple(t.contiguous().clone() for t in ext)
    s_fills = tuple(torch.full((), f, dtype=_fill_dtype(t), device=device)
                    for f, t in zip(fills, ext))
    s_vcs = tuple(torch.full((), v, dtype=torch.int64, device=device)
                  for v in vcs)
    side = torch.cuda.Stream(device)
    caller = torch.cuda.current_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        # kernel library, cuBLAS handle and allocator blocks are made here,
        # outside the capture; these launches are real and keep their counts
        fn(s_ext, s_fills, s_vcs)
    caller.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with counters.recording() as deltas:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            outs = fn(s_ext, s_fills, s_vcs)
    counters.credit(deltas, -1)           # a capture launches nothing
    return _Captured(graph, s_ext, s_fills, s_vcs, outs, deltas)


def _graph_for(seg: FusedSegment, fn: Callable, stamp, ext, fills, vcs,
               device) -> _Captured:
    with _REGISTRY_LOCK:
        cap = _GRAPHS.get(stamp)
    if cap is not None:
        return cap
    with _CAPTURE_LOCK:
        with _REGISTRY_LOCK:
            cap = _GRAPHS.get(stamp)
        if cap is None:
            cap = _capture(fn, ext, fills, vcs, device)
            with _REGISTRY_LOCK:
                if seg.key not in _BROKEN:
                    _GRAPHS[stamp] = cap
    return cap


def run_fused_segment(seg: FusedSegment, ext_objs,
                      device) -> Tuple[DenseTensor, bool]:
    """Run the segment on already-migrated external inputs (containers of
    the engine's kind): a CUDA graph replay on a CUDA ``device`` (captured
    on the first run at these shapes), one eager call on the CPU.  Raises
    whatever capture or run raises — the executor owns the fallback.
    Returns ``(out, cold)``: ``cold`` is True when this (key, ext
    shapes/dtypes) had never completed a run, i.e. the call paid the
    warm-up and capture — the middleware treats such a serve as a warm-up
    and keeps its wall time out of the plan's measured mean."""
    device = torch.device(device)
    fn = compiled_segment(seg)
    ext = tuple(to_device(o.data, device) for o in ext_objs)
    fills = tuple(float(getattr(o, "fill", 0.0)) for o in ext_objs)
    # DenseTensor resolves the "full" sentinel at construction, so this is
    # always a real count
    vcs = tuple(int(getattr(o, "valid_count", o.data.numel()))
                for o in ext_objs)
    stamp = (seg.key, str(device),
             tuple((tuple(a.shape), str(a.dtype)) for a in ext))
    with _REGISTRY_LOCK:
        cold = stamp not in _WARM
    if device.type == "cuda":
        cap = _graph_for(seg, fn, stamp, ext, fills, vcs, device)
        out, aux = cap.run(ext, fills, vcs)
    else:
        out, aux = fn(ext,
                      tuple(torch.full((), f, dtype=_fill_dtype(t))
                            for f, t in zip(fills, ext)),
                      tuple(torch.full((), v, dtype=torch.int64)
                            for v in vcs))
    with _REGISTRY_LOCK:
        _WARM.add(stamp)
    if aux is not None:
        # root select: adopt the mask sum as valid_count — the same
        # (blocking) int() the eager engine op performs
        return DenseTensor(out, valid_count=int(aux)), cold
    return DenseTensor(out), cold
