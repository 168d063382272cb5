"""Plan-level fusion in the port (``repro_torch.core.fuseplan``) against the
reference's (``repro.core.fuseplan``) on the CPU, with the same numpy data
in both packages.

``fuse_plan`` must give the reference's segments and keys for the same query
and plan; a fused serve must equal the port's unfused serve and the
reference's fused serve (values within ``tests/test_kernels.py``'s 1e-5,
integer outputs, shapes and ``valid_count`` equal); segments never cross an
engine or a scope; a failing fused call falls back sticky and counted; the
first fused serve at a stamp is a warm-up, not a measurement.  The CUDA
graph path's static buffers, output copies and launch-count credit are
checked here with a stand-in for the graph (``_ReplayOnCPU``); the graph
itself is checked on the card by ``tests/test_torch_cuda.py``.
"""
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import fuseplan as rfp
from repro.runtime.fault import FusionFaultInjector as RFusionFaultInjector
from repro_torch.core import fuseplan as tfp
from repro_torch.kernels import counters, ops
from repro_torch.kernels.knn import knn_scores_cuda
from repro_torch.runtime import FusionFaultInjector, QueryServer

N, W = 8, 16          # base shape; transpose flips it to (16, 8)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_fusion_registry():
    """One intra-op torch thread (the suite runs beside timing-based tests
    of the reference), and both packages' fusion registries emptied: the
    broken-key marks are sticky by design."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rfp.reset_cache()
    tfp.reset_cache()
    yield
    rfp.reset_cache()
    tfp.reset_cache()
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(7)
    shapes = {"Xd": ((N, W), "dense_array"), "Xc": ((N, W), "columnar"),
              "Xs": ((N, W), "kv_sparse"), "W16": ((16, 16), "dense_array"),
              "W8": ((8, 8), "dense_array"), "B816": ((8, 16), "dense_array"),
              "B168": ((16, 8), "dense_array"),
              "Q16": ((4, 16), "dense_array"), "Q8": ((4, 8), "dense_array")}
    return {name: (rng.normal(size=shape).astype(np.float32), engine)
            for name, (shape, engine) in shapes.items()}


def _port(**kw):
    bd = T.BigDAWG(train_plans=2, train_repeats=1, device="cpu", **kw)
    for name, (a, engine) in _data().items():
        bd.register(name, T.DenseTensor(torch.from_numpy(a)), engine)
    return bd


def _ref(**kw):
    bd = R.BigDAWG(train_plans=2, train_repeats=1, **kw)
    for name, (a, engine) in _data().items():
        bd.register(name, R.DenseTensor(jnp.asarray(a)), engine)
    return bd


def _chain(seed: int):
    """One fusable chain as the reference's property test draws them: the
    input's home data model plus 1-5 ops, each shape-legal at its point,
    knn and count only last."""
    rng = np.random.default_rng(seed)
    n_ops = int(rng.integers(1, 6))
    src = str(rng.choice(["Xd", "Xc", "Xs"]))
    shape = (N, W)
    ops_ = []
    for i in range(n_ops):
        choices = ["select", "scale", "tfidf", "add", "matmul", "transpose",
                   "haar"] + (["knn", "count"] if i == n_ops - 1 else [])
        op = str(rng.choice(choices))
        if op == "select":
            ops_.append(("select", {"lo": float(rng.choice([-0.5, 0.0,
                                                            0.5]))}))
        elif op == "scale":
            ops_.append(("scale", {"factor": float(rng.choice([0.5, 2.0]))}))
        elif op == "tfidf":
            ops_.append(("tfidf", {}))
        elif op == "haar":
            ops_.append(("haar", {"levels": int(rng.choice([1, 2]))}))
        elif op == "transpose":
            ops_.append(("transpose", {}))
            shape = shape[::-1]
        elif op == "add":
            ops_.append(("add", {"other": "B816" if shape == (N, W)
                                 else "B168"}))
        elif op == "matmul":
            ops_.append(("matmul", {"other": "W16" if shape[1] == 16
                                    else "W8"}))
        elif op == "knn":
            ops_.append(("knn", {"other": "Q16" if shape[1] == 16 else "Q8",
                                 "k": 3}))
        else:
            ops_.append(("count", {}))
    return src, tuple(ops_)


def _build(pkg, src, ops_):
    node = pkg.Ref(src)
    for op, a in ops_:
        if "other" in a:
            attrs = {k: v for k, v in a.items() if k != "other"}
            node = pkg.array._build(op, node, pkg.Ref(a["other"]), **attrs)
        else:
            node = pkg.array._build(op, node, **a)
    return node


def _dense_plan(pkg, query):
    return pkg.Plan(tuple((i, "dense_array")
                          for i in range(len(query.nodes()))))


def _same_segments(rf, tf):
    assert tf.plan_key == rf.plan_key
    assert tf.fingerprint == rf.fingerprint
    assert len(tf.segments) == len(rf.segments)
    for r, t in zip(rf.segments, tf.segments):
        assert (t.engine, t.positions, t.ops, t.attrs_list, t.input_specs,
                t.ext_sources, t.key) == \
            (r.engine, r.positions, r.ops, r.attrs_list, r.input_specs,
             r.ext_sources, r.key)
        np.testing.assert_allclose(t.weights, r.weights, rtol=1e-9)


def _values(res):
    return np.asarray(res.value.data), res.value.valid_count


_SHARED = {}


def _shared():
    """One middleware of each package for the chain battery."""
    if not _SHARED:
        _SHARED["ref"], _SHARED["port"] = _ref(), _port()
    return _SHARED["ref"], _SHARED["port"]


@pytest.mark.parametrize("seed", range(24))
def test_fused_equals_unfused_and_the_reference(seed):
    src, ops_ = _chain(seed)
    rb, tb = _shared()
    rq, tq = _build(R, src, ops_), _build(T, src, ops_)
    rplan, tplan = _dense_plan(R, rq), _dense_plan(T, tq)
    rfused = rfp.fuse_plan(rq, rplan, rb.catalog, cost_model=rb.cost_model)
    tfused = tfp.fuse_plan(tq, tplan, tb.catalog, cost_model=tb.cost_model)
    _same_segments(rfused, tfused)
    base = T.execute_plan(tq, tplan, tb.catalog, concurrent=True,
                          device="cpu")
    got = T.execute_plan(tq, tplan, tb.catalog, concurrent=True,
                         fused=tfused, device="cpu")
    ref = R.execute_plan(rq, rplan, rb.catalog, concurrent=True,
                         fused=rfused)
    assert got.fusion_fallbacks == 0, tfp.broken_keys()
    assert ref.fusion_fallbacks == 0, rfp.broken_keys()
    assert got.fused_segments == ref.fused_segments
    if len(ops_) >= tfp.MIN_SEGMENT_NODES:
        assert got.fused_segments, (src, ops_)
    else:
        assert not got.fused_segments
    g, gvc = _values(got)
    for other, ovc in (_values(base), _values(ref)):
        assert g.shape == other.shape and gvc == ovc
        assert g.dtype == other.dtype
        np.testing.assert_allclose(g.astype(np.float32),
                                   other.astype(np.float32), **TOL)
    nodes = tq.nodes()
    for seg in got.fused_segments:
        for pos in seg:
            assert got.per_node_seconds[nodes[pos].uid] >= 0.0


def _count_queries(pkg):
    a, Ref = pkg.array, pkg.Ref
    return [a.count(a.select(Ref("Xd"), lo=0.0, hi=0.7)),
            a.count(a.scale(Ref("Xpad"), factor=2.0)),
            a.scale(a.count(a.select(Ref("Xd"), lo=-0.3)), factor=0.5),
            a.count(a.select(a.matmul(Ref("Xd"), Ref("W16")), lo=0.0)),
            a.count(a.transpose(a.transpose(Ref("Xpad"))))]


@pytest.mark.parametrize("which", range(5))
def test_fused_count_reads_threaded_valid_count(which):
    """``count`` fuses by reading the valid-count threaded through the
    segment as a device tensor: a padded external's count (29) enters from
    its buffer, a select's mask sum replaces it — equal to the eager engine
    and to the reference, mid-chain as at the root."""
    padded = np.random.default_rng(11).normal(size=(N, W)).astype(np.float32)
    rb, tb = _ref(), _port()
    rb.register("Xpad", R.DenseTensor(jnp.asarray(padded), valid_count=29),
                "dense_array")
    tb.register("Xpad", T.DenseTensor(torch.from_numpy(padded),
                                      valid_count=29), "dense_array")
    rq, tq = _count_queries(R)[which], _count_queries(T)[which]
    rplan, tplan = _dense_plan(R, rq), _dense_plan(T, tq)
    tfused = tfp.fuse_plan(tq, tplan, tb.catalog, cost_model=tb.cost_model)
    rfused = rfp.fuse_plan(rq, rplan, rb.catalog, cost_model=rb.cost_model)
    _same_segments(rfused, tfused)
    assert any("count" in s.ops for s in tfused.segments)
    base = T.execute_plan(tq, tplan, tb.catalog, concurrent=True,
                          device="cpu")
    got = T.execute_plan(tq, tplan, tb.catalog, concurrent=True,
                         fused=tfused, device="cpu")
    ref = R.execute_plan(rq, rplan, rb.catalog, concurrent=True,
                         fused=rfused)
    assert got.fusion_fallbacks == 0 and got.fused_segments
    for other in (base, ref):
        np.testing.assert_array_equal(np.asarray(got.value.data),
                                      np.asarray(other.value.data))
        assert got.value.valid_count == other.value.valid_count
        assert np.asarray(got.value.data).dtype == \
            np.asarray(other.value.data).dtype


def _boundary_query(pkg):
    left = pkg.relational.select(pkg.Ref("Xc"), lo=0.0)
    mid = pkg.scope(pkg.array, pkg.relational.matmul(left, pkg.Ref("W16")))
    return pkg.array.scale(pkg.array.haar(mid, levels=2), factor=2.0)


@pytest.mark.parametrize("seed", range(8))
def test_segments_never_cross_engine_or_scope_boundaries(seed):
    rb, tb = _shared()
    rq, tq = _boundary_query(R), _boundary_query(T)
    nodes = tq.nodes()
    rng = np.random.default_rng(seed)
    assignment = tuple(
        (pos, "dense_array" if node.op == T.SCOPE_OP
         else str(rng.choice(["dense_array", "columnar"])))
        for pos, node in enumerate(nodes))
    fused = tfp.fuse_plan(tq, T.Plan(assignment), tb.catalog)
    _same_segments(rfp.fuse_plan(rq, R.Plan(assignment), rb.catalog), fused)
    amap = dict(assignment)
    pos_of = {n.uid: p for p, n in enumerate(nodes)}
    seen = set()
    for seg in fused.segments:
        assert len(seg.positions) >= tfp.MIN_SEGMENT_NODES
        assert seg.engine in tfp.FUSABLE_ENGINES
        for pos in seg.positions:
            assert pos not in seen
            seen.add(pos)
            assert nodes[pos].op != T.SCOPE_OP
            assert nodes[pos].op in tfp.FUSABLE_OPS
            assert amap[pos] == seg.engine
        member = set(seg.positions)
        for pos in seg.positions[:-1]:
            consumer = next(p for p, n in enumerate(nodes)
                            if any(isinstance(i, T.PolyOp)
                                   and pos_of[i.uid] == pos
                                   for i in n.inputs))
            assert consumer in member


def test_shared_subtree_is_never_fused_and_fingerprints_keep_constants():
    _, tb = _shared()
    shared = T.array.haar(T.Ref("Xd"), levels=2)
    query = T.array.add(shared, shared)
    assert tfp.fuse_plan(query, _dense_plan(T, query),
                         tb.catalog).segments == ()
    q1 = T.array.scale(T.array.haar(T.Ref("Xd"), levels=2), factor=2.0)
    q2 = T.array.scale(T.array.haar(T.Ref("Xd"), levels=2), factor=0.5)
    assert tfp.query_fingerprint(q1) != tfp.query_fingerprint(q2)


def _analytic(pkg, levels=2, nbins=4, k=3):
    a = pkg.array
    return a.knn(a.tfidf(a.bin_hist(a.haar(pkg.Ref("waves"), levels=levels),
                                    nbins=nbins, levels=levels)),
                 pkg.Ref("test_hist"), k=k)


def test_analytic_fuses_tfidf_into_knn_as_the_reference_does():
    """The production plan of the analytic (all dense_array): bin_hist is
    not fusable and haar is a one-node chain, so the one segment is
    tfidf -> knn, with the same key and weights in both packages."""
    rng = np.random.default_rng(3)
    waves = rng.normal(size=(24, 64)).astype(np.float32)
    hist = rng.poisson(2.0, size=(4, 12)).astype(np.float32)
    tb, rb = _port(), _ref()
    tb.register("waves", T.DenseTensor(torch.from_numpy(waves)),
                "dense_array")
    tb.register("test_hist", T.DenseTensor(torch.from_numpy(hist)),
                "dense_array")
    rb.register("waves", R.DenseTensor(jnp.asarray(waves)), "dense_array")
    rb.register("test_hist", R.DenseTensor(jnp.asarray(hist)), "dense_array")
    tq, rq = _analytic(T), _analytic(R)
    tfused = tfp.fuse_plan(tq, _dense_plan(T, tq), tb.catalog,
                           cost_model=tb.cost_model)
    _same_segments(rfp.fuse_plan(rq, _dense_plan(R, rq), rb.catalog,
                                 cost_model=rb.cost_model), tfused)
    assert [s.ops for s in tfused.segments] == [("tfidf", "knn")]
    got = T.execute_plan(tq, _dense_plan(T, tq), tb.catalog,
                         concurrent=True, fused=tfused, device="cpu")
    ref = R.execute_plan(rq, _dense_plan(R, rq), rb.catalog,
                         concurrent=True, fused=rfp.fuse_plan(
                             rq, _dense_plan(R, rq), rb.catalog))
    assert got.fused_segments == ((2, 3),)
    np.testing.assert_array_equal(got.value.data.numpy(),
                                  np.asarray(ref.value.data))
    assert got.value.data.dtype == torch.int32


# ---------------------------------------------------------------------------
# middleware surface: the fuse knob, fallback, warm-up accounting, health
# ---------------------------------------------------------------------------

def _pipeline_query():
    """dense_array-only ops: every plan is the all-dense one."""
    x = T.array.transpose(T.array.transpose(T.Ref("Xd")))
    return T.array.scale(T.array.add(x, T.Ref("B816")), factor=2.0)


def test_fusion_is_on_by_default_and_the_knob_turns_it_off():
    assert T.BigDAWG(device="cpu").fuse is True
    bd_on, bd_off = _port(), _port(fuse=False)
    q = _pipeline_query()
    t_on = bd_on.execute(q, mode="training")
    bd_off.execute(q, mode="training")
    assert t_on.fused_segments == ()            # training always unfused
    p_on = bd_on.execute(q, mode="production")
    p_off = bd_off.execute(q, mode="production")
    assert p_on.fused_segments and not p_off.fused_segments
    np.testing.assert_allclose(p_on.result.data.numpy(),
                               p_off.result.data.numpy(), **TOL)
    np.testing.assert_allclose(t_on.result.data.numpy(),
                               p_on.result.data.numpy(), **TOL)
    assert bd_on.fused_serves == 1 and bd_on.fusion_segments >= 1
    assert bd_off.fused_serves == 0


def test_fusion_fallback_is_sticky_and_counted():
    inj = FusionFaultInjector()
    srv = QueryServer(_port(fusion_injector=inj))
    q = _pipeline_query()
    srv.submit(q)                               # training
    r1 = srv.submit(q)
    assert r1.fused_segments and r1.fusion_fallbacks == 0
    inj.arm(1)
    r2 = srv.submit(q)
    assert r2.fusion_fallbacks == 1 and r2.fused_segments == ()
    np.testing.assert_allclose(r2.result.data.numpy(),
                               r1.result.data.numpy(), **TOL)
    assert len(inj.fired) == 1 and tfp.is_broken(inj.fired[0])
    assert inj.fired[0] in tfp.broken_keys()
    r3 = srv.submit(q)                          # sticky: no retry
    assert r3.fusion_fallbacks == 0 and r3.fused_segments == ()
    np.testing.assert_allclose(r3.result.data.numpy(),
                               r1.result.data.numpy(), **TOL)
    assert len(inj.fired) == 1
    assert srv.stats["fusion_fallbacks"] == 1
    assert srv.stats["fused_serves"] == 1
    # the reference's injector does the same to the reference
    rinj = RFusionFaultInjector()
    rinj.arm(1)
    with pytest.raises(Exception, match="injected"):
        rinj.on_fuse("k")
    inj.arm(1)
    with pytest.raises(Exception, match="injected"):
        inj.on_fuse("k")


def test_cold_fused_serve_is_a_warmup_not_a_measurement():
    bd = _port()
    q = _pipeline_query()
    rep_t = bd.execute(q, mode="training")
    n_before = bd.monitor.known_plans(rep_t.sig)[rep_t.plan_key].n
    cold = bd.execute(q, mode="production")
    assert cold.fused_segments and not cold.replanned
    assert bd.replans == 0
    assert bd.monitor.known_plans(rep_t.sig)[rep_t.plan_key].n == n_before
    warm = bd.execute(q, mode="production")
    assert warm.fused_segments
    assert bd.monitor.known_plans(rep_t.sig)[rep_t.plan_key].n == \
        n_before + 1


def test_fused_serves_keep_op_rates_and_feed_health():
    health = T.EngineHealth()
    bd = _port(health=health)
    q = _pipeline_query()
    bd.execute(q, mode="training")
    probe = [("dense_array", op, 4096.0)
             for op in ("transpose", "add", "scale")]
    before = [bd.cost_model.op_seconds(*p) for p in probe]
    for _ in range(3):
        rep = bd.execute(q, mode="production")
        assert rep.fused_segments and rep.status == "ok"
        assert set(rep.per_node_seconds) == set(range(len(q.nodes())))
    assert [bd.cost_model.op_seconds(*p) for p in probe] == before
    det = health._stragglers.get("dense_array")
    assert det is not None and det.n > 0


# ---------------------------------------------------------------------------
# the graph path's buffers and counts, with a stand-in for the CUDA graph
# ---------------------------------------------------------------------------

class _ReplayOnCPU:
    """Stands in for a captured CUDA graph: its outputs are made once, and
    ``replay`` recomputes the function from the static buffers into them in
    place, as a graph replay overwrites its output tensors."""

    def __init__(self, fn, ext, fills, vcs):
        self.fn, self.args = fn, (ext, fills, vcs)
        self.outs = fn(*self.args)

    def replay(self):
        for out, new in zip(self.outs, self.fn(*self.args)):
            if out is not None:
                out.copy_(new)


def _captured(seg, ext, fills, vcs, deltas):
    fn = tfp.compiled_segment(seg)
    s_ext = tuple(t.clone() for t in ext)
    s_fills = tuple(torch.full((), f) for f in fills)
    s_vcs = tuple(torch.full((), v, dtype=torch.int64) for v in vcs)
    graph = _ReplayOnCPU(fn, s_ext, s_fills, s_vcs)
    return tfp._Captured(graph, s_ext, s_fills, s_vcs, graph.outs, deltas)


def _segment(query):
    _, tb = _shared()
    (seg,) = tfp.fuse_plan(query, _dense_plan(T, query), tb.catalog).segments
    return seg


def test_static_buffers_see_a_changed_fill_and_count_between_replays():
    """A fill or a valid-count is written into its static buffer before each
    replay, never baked in: a change between two replays is seen, and an
    earlier result is a copy that a later replay does not overwrite."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(N, W))
                         .astype(np.float32))
    sel = _segment(T.array.scale(T.array.select(T.Ref("Xd"), lo=0.0),
                                 factor=2.0))
    cap = _captured(sel, (x,), (0.0,), (x.numel(),), {})
    first, _ = cap.run((x,), (0.0,), (x.numel(),))
    second, _ = cap.run((x,), (-7.0,), (x.numel(),))
    mask = x.numpy() >= 0.0
    np.testing.assert_array_equal(first.numpy(),
                                  np.where(mask, x.numpy(), 0.0) * 2.0)
    np.testing.assert_array_equal(second.numpy(),
                                  np.where(mask, x.numpy(), -7.0) * 2.0)
    assert first.data_ptr() != cap.outs[0].data_ptr()
    # count reads the external's count from its buffer (a count after an
    # engine op would read that op's full output instead)
    cnt = _segment(T.array.scale(T.array.count(T.Ref("Xd")), factor=0.5))
    cap = _captured(cnt, (x,), (0.0,), (29,), {})
    a, _ = cap.run((x,), (0.0,), (29,))
    b, _ = cap.run((x,), (0.0,), (13,))
    assert (float(a), float(b)) == (14.5, 6.5)
    # new external data is copied in as well
    c, _ = _captured(sel, (x,), (0.0,), (x.numel(),), {}).run(
        (-x,), (0.0,), (x.numel(),))
    np.testing.assert_array_equal(
        c.numpy(), np.where(-x.numpy() >= 0.0, -x.numpy(), 0.0) * 2.0)


def test_replays_credit_the_launches_their_capture_recorded():
    """A replay calls no wrapper, so the counts a capture recorded are
    credited again on each replay (here stubbed: two kNN launches)."""
    x = torch.ones((N, W))
    seg = _segment(T.array.scale(T.array.select(T.Ref("Xd"), lo=0.0),
                                 factor=2.0))
    deltas = {(knn_scores_cuda, "launches"): 2,
              (knn_scores_cuda, "launches_tiled"): 2}
    cap = _captured(seg, (x,), (0.0,), (x.numel(),), deltas)
    ops.reset_launches()
    for _ in range(3):
        cap.run((x,), (0.0,), (x.numel(),))
    got = ops.launches()
    ops.reset_launches()
    assert got["knn_scores"] == 6 and got["knn_scores_tiled"] == 6
    assert got["knn_scores_gemv"] == 0


def test_recording_gathers_this_threads_counts_and_credit_takes_them_out():
    ops.reset_launches()
    with counters.recording() as deltas:
        counters.count(knn_scores_cuda, "launches", "launches_gemv")
        counters.count(knn_scores_cuda, "launches", "launches_gemv")
    counters.credit(deltas, -1)
    assert deltas == {(knn_scores_cuda, "launches"): 2,
                      (knn_scores_cuda, "launches_gemv"): 2}
    assert ops.launches()["knn_scores"] == 0


def _hammer(work, n_threads=16):
    """Run ``work(i)`` on ``n_threads`` threads (more than the cores) with
    a short switch interval, so that an unguarded read-modify-write would
    lose updates; every thread must finish within 60 s."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_launch_counters_are_thread_safe():
    ops.reset_launches()
    seen = []

    def work(i):
        with counters.recording() as deltas:
            for _ in range(2000):
                counters.count(knn_scores_cuda, "launches", "launches_tiled")
        seen.append(deltas[knn_scores_cuda, "launches"])

    _hammer(work)
    got = ops.launches()
    ops.reset_launches()
    assert got["knn_scores"] == got["knn_scores_tiled"] == 32000
    assert seen == [2000] * 16          # each thread records only its own


def test_threads_running_one_captured_segment_get_their_own_results():
    """Replays of one graph share its static buffers: a replay that let
    another thread's inputs in between its copy-in and its copy-out would
    return the other thread's result."""
    seg = _segment(T.array.scale(T.array.select(T.Ref("Xd"), lo=0.0),
                                 factor=2.0))
    xs = [torch.full((N, W), float(i)) for i in range(16)]
    cap = _captured(seg, (xs[0],), (0.0,), (N * W,), {})
    bad = []

    def work(i):
        for _ in range(50):
            out, _ = cap.run((xs[i],), (0.0,), (N * W,))
            if not torch.equal(out, xs[i] * 2.0):
                bad.append(i)

    _hammer(work)
    assert bad == []
