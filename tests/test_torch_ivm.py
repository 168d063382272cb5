"""Streaming appends and materialized views in the port
(``repro_torch.core.deltaplan`` and the middleware's IVM path) on the CPU,
held against the reference package on the same numpy inputs.

``deltaplan.derive`` must give the reference's update fragments; after the
same appends, a delta serve must equal the port's full recompute and the
reference's value (within ``tests/test_kernels.py``'s 1e-5, shapes, kinds
and ``valid_count`` equal), family by family and as a property over random
sizes; the rest twin the reference's IVM cases (a view served verbatim, a
re-registration that drops it, shape-free streaming signatures, the pricing
gate, validation, persistence across a restart, the persistence cap) and
the incremental gather against the batch merge.
"""
import os

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from repro.proptest import given, settings, strategies as st

import repro.core as R
import repro_torch.core as T
from repro.core import deltaplan as rdp
from repro.core import tables as rtab
from repro_torch.core import deltaplan as tdp
from repro_torch.core import middleware as tmw
from repro_torch.core import tables
from repro_torch.core.ioutil import load_json
from repro_torch.core.procpool import IncrementalGather
from repro_torch.core.qlang import bigdawg as qparse

_BASE_ROWS = (8, 12, 16)
_DELTA_ROWS = (2, 4)
_COLS = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread: the suite runs beside timing-based tests
    of the reference, and idle OpenMP threads add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# numpy-leafed containers of the reference's kinds: both packages register
# the same arrays (the port's containers take numpy leaves too)
def _dense(pkg, rng, rows):
    return pkg.DenseTensor(rng.normal(size=(rows, _COLS)).astype(np.float32))


def _col(pkg, rng, rows):
    return pkg.ColumnarTable({
        "key": rng.integers(0, 6, rows).astype(np.int32),
        "value": rng.normal(size=rows).astype(np.float32)})


def _stream(pkg, rng, rows, t0=0.0):
    return pkg.StreamBuffer(rng.normal(size=(rows, _COLS)).astype(np.float32),
                            t0=t0)


def _port_bd(incremental, state=None, **kw):
    kw.setdefault("train_plans", 1)
    kw.setdefault("train_repeats", 1)
    return T.BigDAWG(monitor=T.Monitor(state, shared=bool(state)),
                     incremental=incremental, device="cpu", **kw)


def _ref_bd(incremental, **kw):
    kw.setdefault("train_plans", 1)
    kw.setdefault("train_repeats", 1)
    return R.BigDAWG(monitor=R.Monitor(None), incremental=incremental, **kw)


# (tag, kind, query builder over a package, provably incremental) — the
# reference's FAMILIES, built in either package
FAMILIES = [
    ("dense_scale", "dense",
     lambda p: p.array.scale(p.Ref("S"), factor=2.0), True),
    ("dense_select", "dense",
     lambda p: p.array.select(p.Ref("S"), lo=-0.5, hi=0.5), True),
    ("dense_matmul_left", "dense",
     lambda p: p.array.matmul(p.Ref("S"), p.Ref("W")), True),
    ("dense_add_self", "dense",
     lambda p: p.array.add(p.Ref("S"), p.Ref("S")), True),
    ("dense_haar", "dense",
     lambda p: p.array.haar(p.Ref("S"), levels=1), True),
    ("dense_count_of_select", "dense",
     lambda p: p.array.count(p.array.select(p.Ref("S"), lo=0.0)), True),
    ("dense_concat_last", "dense",
     lambda p: p.array.concat(p.Ref("A0"), p.Ref("S")), True),
    ("dense_transpose", "dense",
     lambda p: p.array.transpose(p.Ref("S")), False),
    ("dense_tfidf", "dense",
     lambda p: p.array.tfidf(p.Ref("S")), False),
    ("dense_concat_first", "dense",
     lambda p: p.array.concat(p.Ref("S"), p.Ref("A0")), False),
    ("col_select", "columnar",
     lambda p: p.relational.select(p.Ref("S"), column="value", lo=0.0), True),
    ("col_project", "columnar",
     lambda p: p.relational.project(p.Ref("S"), columns=["value"]), True),
    ("col_count", "columnar",
     lambda p: p.relational.count(p.Ref("S")), True),
    ("col_sort", "columnar",
     lambda p: p.relational.sort(p.Ref("S"), by="value"), True),
    ("col_groupby_sum", "columnar",
     lambda p: p.relational.groupby_sum(p.Ref("S"), key="key", value="value",
                                        num_groups=6), True),
    ("col_join_left", "columnar",
     lambda p: p.relational.join(p.Ref("S"), p.Ref("R"),
                                 left_on="key", right_on="key"), True),
    ("col_join_right", "columnar",
     lambda p: p.relational.join(p.Ref("R"), p.Ref("S"),
                                 left_on="key", right_on="key"), False),
    ("col_distinct", "columnar",
     lambda p: p.relational.distinct(p.Ref("S"), column="value"), False),
    ("stream_haar", "stream",
     lambda p: p.stream.haar(p.Ref("S"), levels=1), True),
]
_ENGINE_OF = {"dense": "dense_array", "columnar": "columnar",
              "stream": "stream"}
_MAKER_OF = {"dense": _dense, "columnar": _col, "stream": _stream}


def _register_statics(pkg, bd, rng):
    bd.register("W", pkg.DenseTensor(
        rng.normal(size=(_COLS, 3)).astype(np.float32)), "dense_array")
    bd.register("A0", _dense(pkg, rng, 6), "dense_array")
    bd.register("R", pkg.ColumnarTable({
        "key": np.arange(6, dtype=np.int32),
        "rval": rng.normal(size=6).astype(np.float32)}), "columnar")


def _host(obj):
    """A numpy-leafed copy of either package's container."""
    if isinstance(obj, (rtab.DenseTensor, rtab.ColumnarTable,
                        rtab.COOMatrix, rtab.StreamBuffer)):
        return rtab.host_copy(obj)
    return tables.host_copy(obj)


def _assert_equal(a, b, exact=False):
    """Same kind, shapes, dtypes and metadata; values equal (``exact``) or
    within TOL.  Takes containers of either package."""
    a, b = _host(a), _host(b)
    assert a.kind == b.kind
    tol = dict(rtol=0, atol=0) if exact else TOL
    if a.kind in ("dense", "stream"):
        assert a.data.shape == b.data.shape
        assert a.data.dtype == b.data.dtype
        np.testing.assert_allclose(np.asarray(a.data, np.float64),
                                   np.asarray(b.data, np.float64), **tol)
        if a.kind == "dense":
            assert a.valid_count == b.valid_count
        else:
            assert a.t0 == b.t0
    elif a.kind == "columnar":
        assert set(a.columns) == set(b.columns)
        av, bv = np.asarray(a.valid), np.asarray(b.valid)
        assert np.array_equal(av, bv)
        for c in a.columns:
            assert a.columns[c].dtype == b.columns[c].dtype, c
            np.testing.assert_allclose(
                np.asarray(a.columns[c], np.float64)[av],
                np.asarray(b.columns[c], np.float64)[bv], **tol)
    else:
        raise AssertionError(f"unexpected container kind {a.kind}")


def _tree(node):
    """A package-independent structural form of a query or fragment."""
    if not hasattr(node, "op"):
        return ("ref", node.name)
    return (node.op, node.island, tuple(sorted(
        (k, repr(v)) for k, v in node.attrs.items())),
        tuple(_tree(x) for x in node.inputs))


# ---------------------------------------------------------------------------
# deltaplan.derive: the reference's update fragments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fi", range(len(FAMILIES)),
                         ids=[f[0] for f in FAMILIES])
def test_derive_gives_the_reference_fragments(fi):
    tag, kind, build, provable = FAMILIES[fi]
    kinds = {"S": kind, "W": "dense", "A0": "dense", "R": "columnar"}
    got = tdp.derive(build(T), {"S"}, kinds)
    want = rdp.derive(build(R), {"S"}, kinds)
    assert (got is None) == (want is None) == (not provable), tag
    if got is not None:
        assert _tree(got.fragment) == _tree(want.fragment)
        assert (got.merge, got.merge_by, got.changed) == \
            (want.merge, want.merge_by, want.changed)
        assert got.changed == ("S",)
        assert any(r.name == tdp.delta_name("S") for r in got.fragment.refs())


# ---------------------------------------------------------------------------
# delta serve == full recompute == the reference, after the same appends
# ---------------------------------------------------------------------------

def _delta_case(fi, nb, nd, seed, appends=2):
    """Serve a family's query, append ``appends`` times, and hold every warm
    serve (patched when provable, recomputed otherwise) against the port's
    full recompute and the reference's, both on the grown table."""
    tag, kind, build, provable = FAMILIES[fi]
    rng = np.random.default_rng(seed)
    engine = _ENGINE_OF[kind]
    blocks = [_MAKER_OF[kind](T, rng, nb)] + \
        [_MAKER_OF[kind](T, rng, nd) for _ in range(appends)]

    bd = _port_bd("force")
    _register_statics(T, bd, np.random.default_rng(7))
    bd.register("S", blocks[0], engine, streaming=True)
    q = build(T)
    bd.execute(q, mode="training")             # materializes the view
    grown = blocks[0]
    for n, delta in enumerate(blocks[1:], start=1):
        assert bd.append("S", delta) == n
        grown = tables.append_rows(grown, delta)
        rep = bd.execute(q, mode="production")
        assert rep.incremental == provable, (tag, rep.incremental)
        assert (bd.ivm_serves, bd.ivm_fallbacks) == \
            ((n, 0) if provable else (0, n)), tag

        full = _port_bd(False)
        _register_statics(T, full, np.random.default_rng(7))
        full.register("S", grown, engine, streaming=True)
        frep = full.execute(q, mode="training")
        assert frep.incremental is False
        _assert_equal(rep.result, frep.result)

        ref = _ref_bd(False)
        _register_statics(R, ref, np.random.default_rng(7))
        ref.register("S", rtab.host_copy(_as_ref(grown)), engine,
                     streaming=True)
        _assert_equal(rep.result, ref.execute(build(R),
                                              mode="training").result)


def _as_ref(obj):
    """The reference's container of a numpy-leafed port container."""
    obj = tables.host_copy(obj)
    if obj.kind == "dense":
        return rtab.DenseTensor(obj.data, obj.valid_count, obj.fill)
    if obj.kind == "stream":
        return rtab.StreamBuffer(obj.data, obj.t0)
    return rtab.ColumnarTable(dict(obj.columns), valid=obj.valid)


@pytest.mark.parametrize("fi", range(len(FAMILIES)),
                         ids=[f[0] for f in FAMILIES])
def test_delta_serve_equals_full_and_reference(fi):
    _delta_case(fi, 12, 4, seed=fi)


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=0, max_value=len(FAMILIES) - 1),
       st.sampled_from(_BASE_ROWS), st.sampled_from(_DELTA_ROWS),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_delta_serve_property(fi, nb, nd, seed):
    _delta_case(fi, nb, nd, seed, appends=1)


# ---------------------------------------------------------------------------
# the reference's IVM cases, on the port
# ---------------------------------------------------------------------------

def test_unchanged_view_serves_verbatim():
    rng = np.random.default_rng(3)
    bd = _port_bd("force")
    bd.register("S", _dense(T, rng, 12), "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=3.0)
    r0 = bd.execute(q, mode="training")
    r1 = bd.execute(q, mode="production")   # no appends: view verbatim
    assert r1.incremental and r1.cache_hit
    _assert_equal(r0.result, r1.result, exact=True)
    assert bd.ivm_serves == 1


def test_reregister_bumps_epoch_and_drops_view():
    rng = np.random.default_rng(4)
    bd = _port_bd("force")
    bd.register("S", _dense(T, rng, 12), "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=2.0)
    bd.execute(q, mode="training")
    fresh = _dense(T, rng, 12)
    bd.register("S", fresh, "dense_array", streaming=True)
    rep = bd.execute(q, mode="production")
    assert rep.incremental is False
    np.testing.assert_allclose(tables.host_copy(rep.result).data,
                               fresh.data * 2.0, rtol=1e-5)


def test_stream_qlang_block_compiles_to_same_signature():
    rng = np.random.default_rng(5)
    bd = _port_bd("force")
    bd.register("S", _stream(T, rng, 12), "stream", streaming=True)
    q_prog = T.stream.haar(T.Ref("S"), levels=1)
    q_text = qparse("BIGDAWG(STREAM(haar(S, levels=1)))")
    assert T.signature(q_text, bd.catalog) == T.signature(q_prog, bd.catalog)
    bd.execute(q_text, mode="training")
    bd.append("S", _stream(T, rng, 4, t0=12.0))
    rep = bd.execute(q_text, mode="production")
    assert rep.incremental
    oracle = _port_bd(False)
    oracle.register("S", bd.catalog["S"].obj, "stream", streaming=True)
    _assert_equal(rep.result, oracle.execute(q_prog, mode="training").result)


def test_streaming_signature_is_shape_free_and_the_reference_s():
    rng = np.random.default_rng(6)
    bd = _port_bd(True)
    base = _dense(T, rng, 8)
    bd.register("S", base, "dense_array", streaming=True)
    ref = _ref_bd(True)
    ref.register("S", _as_ref(base), "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=2.0)
    before = T.signature(q, bd.catalog)
    assert before == R.signature(R.array.scale(R.Ref("S"), factor=2.0),
                                 ref.catalog)
    bd.append("S", _dense(T, rng, 4))
    assert T.signature(q, bd.catalog) == before


def test_gate_recomputes_when_delta_dominates_and_force_overrides():
    rng = np.random.default_rng(8)

    def serve_after_big_append(mode):
        bd = _port_bd(mode)
        bd.register("S", _dense(T, rng, 8), "dense_array", streaming=True)
        q = T.array.matmul(T.Ref("S"), T.Ref("W"))
        bd.register("W", T.DenseTensor(
            rng.normal(size=(_COLS, 3)).astype(np.float32)), "dense_array")
        bd.execute(q, mode="training")
        bd.append("S", _dense(T, rng, 512))     # delta >> base: patching
        rep = bd.execute(q, mode="production")  # can't beat recomputing
        return bd, rep

    bd, rep = serve_after_big_append(True)
    assert rep.incremental is False and bd.ivm_fallbacks == 1
    bd, rep = serve_after_big_append("force")
    assert rep.incremental is True and bd.ivm_serves == 1


def test_incremental_off_never_materializes():
    rng = np.random.default_rng(9)
    bd = _port_bd(False)
    bd.register("S", _dense(T, rng, 12), "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=2.0)
    bd.execute(q, mode="training")
    bd.append("S", _dense(T, rng, 2))
    rep = bd.execute(q, mode="production")
    assert rep.incremental is False
    assert bd.ivm_serves == 0 and bd.ivm_fallbacks == 0
    assert bd.plan_cache[rep.sig].view is None


def test_streaming_registration_validation():
    rng = np.random.default_rng(10)
    bd = _port_bd(True)
    with pytest.raises(ValueError):      # casts are not append-preserving
        bd.register("S", _dense(T, rng, 8), "columnar", streaming=True)
    with pytest.raises(ValueError):      # sharding + appends don't compose
        bd.register("S", _dense(T, rng, 8), "dense_array", shards=2,
                    streaming=True)
    with pytest.raises(TypeError):       # 0-d: no row dimension to grow
        bd.register("Z", T.DenseTensor(np.float32(3.0)), "dense_array",
                    streaming=True)
    bd.register("P", _dense(T, rng, 8), "dense_array")        # not streaming
    with pytest.raises(ValueError):
        bd.append("P", _dense(T, rng, 2))
    with pytest.raises(KeyError):
        bd.append("missing", _dense(T, rng, 2))
    bd.register("S", _dense(T, rng, 8), "dense_array", streaming=True)
    with pytest.raises((TypeError, ValueError)):           # kind mismatch
        bd.append("S", _col(T, rng, 2))
    # streaming tables stay on the host; the rest are homed on the device
    assert isinstance(bd.catalog["S"].obj.data, np.ndarray)
    assert isinstance(bd.catalog["P"].obj.data, torch.Tensor)


def test_views_persist_and_patch_after_restart(tmp_path):
    state = str(tmp_path / "mon.json")
    rng = np.random.default_rng(11)
    base, delta = _dense(T, rng, 12), _dense(T, rng, 4)

    bd1 = _port_bd("force", state=state)
    bd1.register("S", base, "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=2.0)
    bd1.execute(q, mode="training")
    bd1.persist()
    assert os.path.exists(tmw.default_view_cache_path(state))

    # "restarted process": same state paths, data re-registered already
    # grown (the deployment contract: registrations replay current tables)
    bd2 = _port_bd("force", state=state)
    bd2.register("S", base, "dense_array", streaming=True)
    bd2.append("S", delta)
    rep = bd2.execute(q, mode="production")
    assert rep.incremental, "restored view did not patch"
    full = tables.append_rows(base, delta)
    np.testing.assert_allclose(tables.host_copy(rep.result).data,
                               full.data * 2.0, rtol=1e-5)


def test_view_save_skips_masked_and_oversized(tmp_path, monkeypatch):
    state = str(tmp_path / "mon.json")
    rng = np.random.default_rng(12)
    bd = _port_bd("force", state=state)
    bd.register("S", _dense(T, rng, 12), "dense_array", streaming=True)
    q = T.array.scale(T.Ref("S"), factor=2.0)
    rep = bd.execute(q, mode="training")
    # graft a masked entry carrying a view: it must never hit the file
    entry = bd.plan_cache[rep.sig]
    bad = tmw.masked_sig(rep.sig, frozenset({"kv_sparse"}))
    bd.plan_cache[bad] = entry
    bd.save_views()
    blob = load_json(tmw.default_view_cache_path(state))
    assert list(blob["entries"]) == [rep.sig]
    # oversized views stay memory-only
    monkeypatch.setattr(tmw, "VIEW_PERSIST_MAX_BYTES", 1)
    bd.save_views(merge=False)
    assert load_json(tmw.default_view_cache_path(state))["entries"] == {}


# ---------------------------------------------------------------------------
# the incremental gather folds frames in any arrival order
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.sampled_from(["concat", "sum", "kmerge"]),
       st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_incremental_gather_matches_batch_merge(merge, n, seed):
    rng = np.random.default_rng(seed)
    if merge == "concat":
        parts = [_dense(T, rng, int(rng.integers(1, 5))) for _ in range(n)]
        oracle = tables.concat_shards(parts)
    elif merge == "sum":
        parts = [T.ColumnarTable({"key": np.arange(4, dtype=np.int32),
                                  "sum": rng.normal(size=4)})
                 for _ in range(n)]
        oracle = tables.sum_shards(parts)
    else:
        parts = [T.ColumnarTable({
            "key": np.sort(rng.integers(0, 40, 5)).astype(np.int32),
            "value": rng.normal(size=5).astype(np.float32)})
            for _ in range(n)]
        oracle = tables.kmerge_shards(parts, "key")
    order = rng.permutation(n)
    g = IncrementalGather(merge, n, by="key" if merge == "kmerge" else None)
    for i in order:
        g.add(int(i), parts[i])
    out = g.result()
    if merge == "kmerge":
        for c in ("key", "value"):
            np.testing.assert_array_equal(out.columns[c], oracle.columns[c])
    else:
        _assert_equal(out, oracle, exact=merge == "concat")
    assert g.folds == n - 1


def test_incremental_gather_guards():
    with pytest.raises(ValueError):
        IncrementalGather("median", 2)
    g = IncrementalGather("concat", 3)
    g.add(2, _dense(T, np.random.default_rng(0), 2))   # out of order: pending
    with pytest.raises(RuntimeError):
        g.result()
