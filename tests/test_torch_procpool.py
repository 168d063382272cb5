"""The port's process pool (``repro_torch.core.procpool``), row-range
sharded scatter–gather (``core.shardplan``) and the shared persistence
files the workers converge through, on the CPU, held against the reference
package on the same numpy inputs.

Merge primitives, scatter pricing and ``analyze`` must match the
reference's; sharded ≡ unsharded ≡ the reference on ``run_scatter_gather``
(family by family and as a property); the monitor and plan-cache files keep
every writer's signatures under real multi-process contention.  The pool
runs its workers with ``device="cpu"`` (each spawned worker imports torch;
one module-scoped 2-worker pool serves most tests, and kill, restart and
start-failure spawn their own).  Port-specific: nothing that crosses a pipe
carries a ``torch.Tensor``; a worker without a card (``device=None`` here)
fails the first call with a clean ``EngineDown`` after at most one
respawn; a pool master in a fresh process loads neither JAX nor the
reference; ``WorkerKillInjector`` fires as the reference's does.
"""
import dataclasses
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from repro.proptest import given, settings, strategies as st

import _torch_pool
import repro.core as R
import repro_torch.core as T
from repro.core import planner as rplanner
from repro.core import shardplan as rsp
from repro.core import tables as rtab
from repro.runtime import fault as rfault
from repro_torch.core import shardplan as tsp
from repro_torch.core import tables as tt
from repro_torch.core.errors import EngineDown
from repro_torch.core.ioutil import load_json
from repro_torch.core.middleware import MASK_SEP, masked_sig
from repro_torch.core.planner import price_scatter_gather
from repro_torch.core.procpool import (ProcPool, _monitor_hammer,
                                       _plan_cache_hammer, worker_channel)
from repro_torch.runtime import QueryServer, WorkerKillInjector

TOL = dict(rtol=1e-5, atol=1e-5)
_NROWS = (5, 8, 12, 16, 24)
_NCOLS = (2, 3, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op torch thread here, and ``OMP_NUM_THREADS=1`` for the
    workers this test spawns: idle OpenMP threads add noise to the timings
    of the reference's tests running beside these."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(obj):
    """A numpy-leafed copy of either package's container."""
    if isinstance(obj, (rtab.DenseTensor, rtab.ColumnarTable,
                        rtab.COOMatrix, rtab.StreamBuffer)):
        return rtab.host_copy(obj)
    return tt.host_copy(obj)


def _assert_equal(a, b, tol=TOL):
    """Same kind, shapes and metadata; values within ``tol`` (valid rows
    of a columnar table only).  Takes containers of either package."""
    a, b = _host(a), _host(b)
    assert a.kind == b.kind
    if a.kind == "dense":
        assert np.shape(a.data) == np.shape(b.data)
        np.testing.assert_allclose(np.asarray(a.data, np.float64),
                                   np.asarray(b.data, np.float64), **tol)
        assert a.valid_count == b.valid_count
    elif a.kind == "columnar":
        assert set(a.columns) == set(b.columns)
        av, bv = np.asarray(a.valid), np.asarray(b.valid)
        assert np.array_equal(av, bv)
        for c in a.columns:
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
# merge primitives (numpy-only master-side algebra)
# ---------------------------------------------------------------------------

def test_shard_bounds_cover_and_spread():
    assert tt.shard_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert tt.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    with pytest.raises(ValueError):
        tt.shard_bounds(10, 0)


def test_shard_concat_roundtrip_all_kinds():
    rng = np.random.RandomState(0)
    objs = [T.DenseTensor(torch.from_numpy(rng.rand(11, 3))),
            T.ColumnarTable({"key": torch.arange(11),
                             "value": torch.from_numpy(rng.rand(11))},
                            valid=torch.arange(11) % 3 != 0),
            T.COOMatrix(torch.tensor([0, 3, 7, 10]), torch.tensor([1, 0, 2, 1]),
                        torch.tensor([1.0, 2.0, 3.0, 4.0]), (11, 3)),
            T.StreamBuffer(torch.from_numpy(rng.rand(11, 4)), t0=5)]
    for obj in objs:
        parts = tt.shard_rows(obj, 3)
        # the parts and their merge are numpy: the master never holds a
        # tensor
        assert all(isinstance(leaf, np.ndarray) for p in parts
                   for leaf in tt.leaves(p))
        back = tt.concat_shards(parts)
        want = tt.host_copy(obj)
        for got_leaf, want_leaf in zip(tt.leaves(back), tt.leaves(want)):
            assert isinstance(got_leaf, np.ndarray)
            np.testing.assert_array_equal(got_leaf, want_leaf)
        if obj.kind == "dense":
            assert back.valid_count == obj.valid_count
        elif obj.kind == "coo":
            assert back.shape == obj.shape
        elif obj.kind == "stream":
            assert back.t0 == obj.t0


def test_shard_rows_rejects_padded_dense_and_0d():
    with pytest.raises(ValueError):
        tt.shard_rows(T.DenseTensor(np.ones((6, 2)), valid_count=7), 2)
    with pytest.raises(ValueError):
        tt.shard_rows(T.DenseTensor(np.float64(3.0)), 2)


def test_kmerge_is_a_stable_ordered_merge():
    a = T.ColumnarTable({"k": np.array([1.0, 3.0, 9.0]),
                         "tag": np.array([10, 11, 12])})
    b = T.ColumnarTable({"k": np.array([2.0, 3.0, 10.0]),
                         "tag": np.array([20, 21, 22])},
                        valid=np.array([True, True, False]))
    out = tt.kmerge_shards([a, b], by="k")
    assert np.allclose(out.columns["k"], [1.0, 2.0, 3.0, 3.0, 9.0])
    # the tied k=3.0 keeps shard order: shard 0's row first (stable)
    assert list(out.columns["tag"]) == [10, 20, 11, 21, 12]


def test_sum_merge_requires_aligned_keys():
    a = T.ColumnarTable({"key": np.arange(3), "sum": np.ones(3)})
    b = T.ColumnarTable({"key": np.arange(1, 4), "sum": np.ones(3)})
    with pytest.raises(ValueError):
        tt.sum_shards([a, b])


def test_host_copy_turns_tensor_metadata_into_python_values():
    """A fused select's valid-count can be a 0-d tensor; ``host_copy``
    (what every pool reply goes through) must not pass it on."""
    d = T.DenseTensor(torch.ones(3, 2), valid_count=torch.tensor(4),
                      fill=torch.tensor(0.5))
    h = tt.host_copy(d)
    assert isinstance(h.data, np.ndarray)
    assert type(h.valid_count) is int and h.valid_count == 4
    assert type(h.fill) is float and h.fill == 0.5
    s = tt.host_copy(T.StreamBuffer(torch.ones(2, 2), t0=torch.tensor(3)))
    assert type(s.t0) is int and s.t0 == 3
    c = tt.host_copy(T.COOMatrix(torch.tensor([0]), torch.tensor([1]),
                                 torch.tensor([2.0]),
                                 (torch.tensor(2), 3)))
    assert c.shape == (2, 3) and all(type(n) is int for n in c.shape)
    assert isinstance(tt.host_copy(torch.zeros(2)), np.ndarray)


# ---------------------------------------------------------------------------
# scatter–gather pricing and analysis, against the reference
# ---------------------------------------------------------------------------

def _small_data():
    rng = np.random.RandomState(7)
    return {"A": ({"key": rng.randint(0, 5, 24), "value": rng.rand(24)},
                  "columnar", 2),
            "M": (rng.rand(24, 3), "dense_array", 2),
            "W": (rng.rand(3, 4), "dense_array", None)}


def _small_catalog(pkg, **kw):
    if pkg is T:
        kw["device"] = "cpu"
    bd = pkg.BigDAWG(train_plans=1, train_repeats=1, **kw)
    for name, (a, engine, shards) in _small_data().items():
        obj = pkg.ColumnarTable(dict(a)) if isinstance(a, dict) \
            else pkg.DenseTensor(a)
        bd.register(name, obj, engine, shards=shards)
    return bd


def test_price_scatter_gather_shape_scaling_and_reference():
    bd, ref = _small_catalog(T), _small_catalog(R)
    q, rq = T.array.matmul("M", "W"), R.array.matmul("M", "W")
    sg = tsp.analyze_catalog(q, bd.sharded)
    rsg = rsp.analyze_catalog(rq, ref.sharded)
    assert sg is not None
    p1 = price_scatter_gather(q, sg.fragment(0), catalog=bd.catalog,
                              n_shards=2, workers=1)
    p4 = price_scatter_gather(q, sg.fragment(0), catalog=bd.catalog,
                              n_shards=2, workers=4)
    assert p1.unsharded_s > 0 and p1.fragment_s > 0
    # more workers -> fewer sequential rounds -> never slower
    assert p4.sharded_s <= p1.sharded_s
    assert p1.worthwhile == (p1.sharded_s < p1.unsharded_s)
    r1 = rplanner.price_scatter_gather(rq, rsg.fragment(0),
                                       catalog=ref.catalog, n_shards=2,
                                       workers=1)
    for field in ("unsharded_s", "fragment_s", "sharded_s"):
        assert getattr(p1, field) == pytest.approx(getattr(r1, field),
                                                   rel=1e-9), field
    assert p1.worthwhile == r1.worthwhile


def test_analyze_rejects_what_the_reference_rejects():
    bd, ref = _small_catalog(T), _small_catalog(R)
    for build in (
            lambda p: p.relational.distinct("A"),
            lambda p: p.relational.join("A2", "A", left_on="key",
                                        right_on="key"),
            lambda p: p.array.count(p.scope("array", p.relational.select(
                "A", column="value", lo=0.0))),
            lambda p: p.relational.sort(p.relational.sort("A", by="value"),
                                        by="key"),
            lambda p: p.array.count("W")):
        assert tsp.analyze_catalog(build(T), bd.sharded) is None
        assert rsp.analyze_catalog(build(R), ref.sharded) is None


_ANALYZE_CASES = [
    (lambda p: p.array.matmul("M", "W"), "concat", True),
    (lambda p: p.array.count("M"), "sum", False),
    (lambda p: p.relational.sort("A", by="value"), "kmerge", False),
    (lambda p: p.relational.groupby_sum("A", key="key", value="value",
                                        num_groups=5), "sum", False),
]


@pytest.mark.parametrize("case", range(len(_ANALYZE_CASES)),
                         ids=["matmul", "count", "sort", "groupby"])
def test_analyze_matches_the_reference(case):
    build, merge, wrapped = _ANALYZE_CASES[case]
    bd, ref = _small_catalog(T), _small_catalog(R)
    sg = tsp.analyze_catalog(build(T), bd.sharded)
    rsg = rsp.analyze_catalog(build(R), ref.sharded)
    assert sg is not None and rsg is not None
    assert (sg.merge, sg.merge_by, sg.wrap_scope, sg.n_shards) == \
        (rsg.merge, rsg.merge_by, rsg.wrap_scope, rsg.n_shards)
    assert sg.merge == merge and sg.wrap_scope == wrapped
    for i in range(sg.n_shards):
        frag, rfrag = sg.fragment(i), rsg.fragment(i)
        assert _tree(frag) == _tree(rfrag)
        assert any(r.name.endswith(f"#{i}") for r in frag.refs())
        assert T.signature(frag, bd.catalog) == \
            R.signature(rfrag, ref.catalog)


# ---------------------------------------------------------------------------
# sharded scatter–gather == unsharded == the reference
# ---------------------------------------------------------------------------

_FAMILIES = ("matmul", "count", "scale", "add", "sort", "groupby",
             "join", "select_sort", "project")


def _scatter_catalog(pkg, family, n, k, shards, seed):
    rng = np.random.RandomState(seed)
    kw = {"device": "cpu"} if pkg is T else {}
    bd = pkg.BigDAWG(train_plans=1, train_repeats=1, **kw)
    if family in ("matmul", "count", "scale", "add"):
        bd.register("M", pkg.DenseTensor(rng.rand(n, k)), "dense_array",
                    shards=shards)
        if family == "matmul":
            bd.register("W", pkg.DenseTensor(rng.rand(k, 3)), "dense_array")
            q = pkg.array.matmul("M", "W")
        elif family == "count":
            q = pkg.array.count("M")
        elif family == "scale":
            q = pkg.array.scale("M", factor=2.5)
        else:
            bd.register("M2", pkg.DenseTensor(rng.rand(n, k)), "dense_array",
                        shards=shards)
            q = pkg.array.add("M", "M2")
    else:
        bd.register("A", pkg.ColumnarTable(
            {"key": rng.randint(0, 4, n).astype(np.int32),
             "value": rng.rand(n)}), "columnar", shards=shards)
        if family == "sort":
            q = pkg.relational.sort("A", by="value")
        elif family == "groupby":
            q = pkg.relational.groupby_sum("A", key="key", value="value",
                                           num_groups=4)
        elif family == "join":
            bd.register("B", pkg.ColumnarTable(
                {"key": np.arange(4, dtype=np.int32), "w": rng.rand(4)}),
                "columnar")
            q = pkg.relational.join("A", "B", left_on="key", right_on="key")
        elif family == "select_sort":
            q = pkg.relational.sort(
                pkg.relational.select("A", column="value", lo=0.3),
                by="value")
        else:
            q = pkg.relational.project("A", columns=["value"])
    return bd, q


def _run_scatter_case(family, n, k, shards, seed):
    bd, q = _scatter_catalog(T, family, n, k, shards, seed)
    sg = tsp.analyze_catalog(q, bd.sharded)
    assert sg is not None and sg.n_shards == shards
    full = bd.execute(q, mode="training").result
    merged = tsp.run_scatter_gather(
        sg, lambda i, frag: bd.execute(frag, mode="training").result)
    ref, rq = _scatter_catalog(R, family, n, k, shards, seed)
    want = ref.execute(rq, mode="training").result
    if family == "count":
        assert int(np.asarray(tt.host_copy(merged).data)) == \
            int(np.asarray(tt.host_copy(full).data)) == \
            int(np.asarray(want.data))
    elif family == "groupby":
        for got in (merged, full):
            got = tt.host_copy(got)
            np.testing.assert_array_equal(got.columns["key"],
                                          np.asarray(want.columns["key"]))
            np.testing.assert_allclose(got.columns["sum"],
                                       np.asarray(want.columns["sum"]), **TOL)
    else:
        _assert_equal(full, merged)
        _assert_equal(merged, want)


@pytest.mark.parametrize("family", _FAMILIES)
def test_scatter_gather_equals_unsharded_and_reference(family):
    _run_scatter_case(family, 12, 3, 3, seed=len(family))


@settings(max_examples=15, deadline=None)
@given(st.sampled_from(_FAMILIES), st.sampled_from(_NROWS),
       st.sampled_from(_NCOLS), st.integers(1, 4),
       st.integers(0, 2 ** 31 - 1))
def test_scatter_gather_property(family, n, k, shards, seed):
    _run_scatter_case(family, n, k, shards, seed)


# ---------------------------------------------------------------------------
# monitor / plan-cache shared persistence
# ---------------------------------------------------------------------------

def test_monitor_merge_save_preserves_other_writers(tmp_path):
    path = str(tmp_path / "monitor.json")
    usage = {"cpu": 0.1, "mem_frac": 0.1}
    m1 = T.Monitor(path, shared=True)
    m1.record("sig-one", "0:columnar", 0.01, usage=usage)
    m1.save()
    m2 = T.Monitor(path, shared=True)
    m2.record("sig-two", "0:dense_array", 0.02, usage=usage)
    m2.save()                    # must carry sig-one through
    # m1 polls: adopts m2's signature (non-local) without losing its own
    assert m1.reload_if_changed() is True
    assert "sig-two" in m1.db and "sig-one" in m1.db
    m1.record("sig-one", "0:columnar", 0.03, usage=usage)
    m1.save()                    # must carry sig-two through
    fresh = T.Monitor(path)
    assert set(fresh.db) == {"sig-one", "sig-two"}
    assert fresh.db["sig-one"]["0:columnar"].n == 2
    # the reference reads the same file the same way
    assert set(R.Monitor(path).db) == {"sig-one", "sig-two"}


def test_plan_cache_merge_save_preserves_other_writers(tmp_path):
    state = str(tmp_path / "monitor.json")
    rng = np.random.RandomState(3)
    A = T.ColumnarTable({"key": rng.randint(0, 3, 12), "value": rng.rand(12)})
    M = T.DenseTensor(rng.rand(12, 2))
    W = T.DenseTensor(rng.rand(2, 2))

    def bd(shared=True):
        return T.BigDAWG(monitor=T.Monitor(state, shared=shared),
                         train_plans=1, train_repeats=1, device="cpu")

    bd1 = bd()
    bd1.register("A", A, "columnar")
    bd1.execute(T.relational.sort("A", by="value"), mode="training")
    bd1.monitor.save()
    bd1.save_plan_cache()

    bd2 = bd()
    bd2.register("M", M, "dense_array")
    bd2.register("W", W, "dense_array")
    bd2.execute(T.array.matmul("M", "W"), mode="training")
    bd2.monitor.save()
    bd2.save_plan_cache()        # bd1's signature must survive

    bd3 = bd(shared=False)
    assert len(bd3.plan_cache) == 2
    assert all(cp.restored for cp in bd3.plan_cache.values())
    # bd1 adopts bd2's entry on poll without losing its own
    assert bd1.reload_shared() is True
    assert len(bd1.plan_cache) == 2


def _spawn_all(target, args_of, n_procs):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(i))
             for i in range(n_procs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0


def test_multiprocess_persistence_contention(tmp_path):
    """N real processes hammer one monitor DB through atomic merge-saves and
    versioned reloads: every private signature survives, the contended one
    resolves last-writer-wins, and the final file parses clean."""
    path = str(tmp_path / "contended.json")
    n_procs, rounds = 3, 6
    _spawn_all(_monitor_hammer,
               lambda i: (path, f"private-{i}", "shared-sig", rounds, i),
               n_procs)
    final = T.Monitor(path)      # auto-loads; a torn file would raise here
    for i in range(n_procs):
        sig = f"private-{i}"
        assert sig in final.db, f"dropped private signature {sig}"
        assert 1 <= final.db[sig][f"0:plan{i}"].n <= rounds
        assert set(final.db[sig]) == {f"0:plan{i}"}
    winners = set(final.db["shared-sig"])
    assert winners and winners <= {f"0:writer{i}" for i in range(n_procs)}


def test_masked_entries_never_resurrect_under_contention(tmp_path):
    """Real processes hammer one shared plan-cache file while a
    ``@!``-masked entry keeps being injected underneath: every private
    signature survives, the masked one is never adopted or re-persisted."""
    state = str(tmp_path / "contended.json")
    bad = masked_sig("deg-sig", frozenset({"kv_sparse"}))
    n_procs, rounds = 3, 6
    _spawn_all(_plan_cache_hammer,
               lambda i: (state, f"private-{i}", bad, rounds, i), n_procs)
    bd = T.BigDAWG(monitor=T.Monitor(state, shared=True), device="cpu")
    assert not any(MASK_SEP in sig for sig in bd.plan_cache)
    for i in range(n_procs):
        assert f"private-{i}" in bd.plan_cache
    bd.save_plan_cache()
    blob = load_json(bd.plan_cache_path)
    assert not any(MASK_SEP in sig for sig in blob["entries"])
    assert all(f"private-{i}" in blob["entries"] for i in range(n_procs))


# ---------------------------------------------------------------------------
# the pool itself (module-scoped: spawn cost paid once)
# ---------------------------------------------------------------------------

def _pool_data():
    rng = np.random.RandomState(11)
    return {"A": ({"key": rng.randint(0, 5, 40).astype(np.int32),
                   "value": rng.rand(40)}, "columnar", 2),
            "M": (rng.rand(40, 3), "dense_array", 2),
            "W": (rng.rand(3, 4), "dense_array", None)}


def _register_all(target, pkg=T):
    for name, (a, engine, shards) in _pool_data().items():
        obj = pkg.ColumnarTable(dict(a)) if isinstance(a, dict) \
            else pkg.DenseTensor(a)
        target.register(name, obj, engine, shards=shards)


@pytest.fixture(scope="module")
def pool_state(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mpstate") / "monitor.json")


@pytest.fixture(scope="module")
def pool(pool_state):
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        p = ProcPool(2, state_path=pool_state, train_plans=2,
                     scatter="always", request_timeout_s=120.0,
                     device="cpu", worker_init=_torch_pool.pin_adaptive)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    _register_all(p)
    yield p
    p.close()


_POOL_QUERIES = [
    ("count", lambda p: p.array.count("M")),
    ("matmul", lambda p: p.array.matmul("M", "W")),
    ("sort", lambda p: p.relational.sort("A", by="value")),
    ("groupby", lambda p: p.relational.groupby_sum(
        "A", key="key", value="value", num_groups=5)),
]


def test_pool_scatter_matches_oracle_and_reference(pool):
    oracle = T.BigDAWG(train_plans=2, device="cpu")
    _register_all(oracle)
    ref = R.BigDAWG(train_plans=2)
    _register_all(ref, R)
    for name, build in _POOL_QUERIES:
        rep = pool.execute(build(T), mode="training")
        assert rep.shards == 2, name
        want = oracle.execute(build(T), mode="training").result
        rwant = ref.execute(build(R), mode="training").result
        for other in (want, rwant):
            got, exp = _host(rep.result), _host(other)
            if exp.kind == "dense":
                np.testing.assert_allclose(got.data, exp.data, **TOL,
                                           err_msg=name)
            else:
                for c in exp.columns:
                    np.testing.assert_allclose(got.columns[c],
                                               np.asarray(exp.columns[c]),
                                               **TOL, err_msg=f"{name} {c}")
    assert pool.scatter_serves >= len(_POOL_QUERIES)


def test_pool_serves_warm_after_training(pool):
    pool.execute(T.array.matmul("M", "W"), mode="training")
    rep = pool.execute(T.array.matmul("M", "W"))
    assert rep.mode == "production"
    assert rep.shards == 2
    assert rep.cache_hit


def test_pool_report_leaves_are_numpy(pool):
    """Every leaf of a pool ``Report`` is a numpy array or a plain Python
    value — the result of a fused serve whose root select carries the
    valid-count included."""
    q = T.array.select(T.array.scale("W", factor=2.0), column="value",
                       lo=1.0)
    pool.execute(q, mode="training")
    reps = [pool.execute(q) for _ in range(2)]     # both workers serve
    seen = []

    def walk(x, path):
        assert not isinstance(x, torch.Tensor), path
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(k, f"{path}[key]")
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple, set, frozenset)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif isinstance(x, np.ndarray):
            seen.append(path)
        else:
            assert x is None or isinstance(
                x, (str, bool, int, float, np.generic)), (path, type(x))

    for rep in reps:
        assert rep.mode == "production"
        assert rep.fused_segments, rep.plan_key
        walk(rep, "rep")
        assert type(rep.result.valid_count) is int
        got = rep.result
        w = _pool_data()["W"][0] * 2.0
        np.testing.assert_array_equal(got.data, np.where(w >= 1.0, w, 0.0))
        assert got.valid_count == int((w >= 1.0).sum())
    assert "rep.result.data" in seen


def test_pool_persist_and_warm_restart_enumerates_nothing(pool, pool_state):
    pool.execute(T.array.matmul("M", "W"), mode="training")
    pool.persist()
    restarted = ProcPool(1, state_path=pool_state, train_plans=2,
                         scatter="always", device="cpu",
                         worker_init=_torch_pool.forbid_enumeration)
    try:
        _register_all(restarted)
        for _ in range(2):
            rep = restarted.execute(T.array.matmul("M", "W"))
            assert rep.mode == "production"    # warm from the shared files
            assert rep.shards == 2 and rep.cache_hit
    finally:
        restarted.close()


def test_queryserver_over_pool_admission(pool):
    srv = QueryServer(pool)
    reports = srv.submit_many([T.array.matmul("M", "W") for _ in range(6)],
                              workers=3)
    assert len(reports) == 6
    assert srv.stats["requests"] == 6
    assert srv.stats["shed"] == 0
    assert all(r.shards == 2 for r in reports)


def test_unsharded_query_round_robins(pool):
    # a query with no sharded leaves takes the ordinary single-worker path
    before = pool.dispatches
    for _ in range(2):
        rep = pool.execute(T.array.count("W"), mode="training")
        assert rep.shards == 0
        assert int(np.asarray(rep.result.data)) == 12
    assert pool.dispatches == before + 2
    assert len(set(pool.ping())) == 2


# ---------------------------------------------------------------------------
# worker faults
# ---------------------------------------------------------------------------

def test_worker_kill_respawn_retry_and_clean_error():
    """SIGKILL a worker mid-request: the master must detect the death via
    the breaker channel, respawn with the registration log replayed, and
    either retry transparently (retries>=1) or surface a clean EngineDown
    (retries=0) — zero hung requests, zero lost requests."""
    data = _pool_data()
    M, W = T.DenseTensor(data["M"][0]), T.DenseTensor(data["W"][0])
    q = T.array.matmul("M", "W")
    inj = WorkerKillInjector(kill_on_dispatch=2)
    p = ProcPool(2, train_plans=2, retries=1, kill_injector=inj,
                 request_timeout_s=120.0, device="cpu")
    try:
        p.register("M", M, "dense_array")
        p.register("W", W, "dense_array")
        ref = p.execute(q, mode="training")        # dispatch 1: survives
        rep = p.execute(q, mode="training")        # dispatch 2: kill lands
        assert inj.kills == 1
        assert p.respawns >= 1
        assert p.breaker_trips >= 1                # death hit the breaker
        np.testing.assert_allclose(rep.result.data, ref.result.data, **TOL)
        # the respawned worker keeps serving (registration replay worked)
        for _ in range(2):
            again = p.execute(q)
            np.testing.assert_allclose(again.result.data, ref.result.data,
                                       **TOL)
        assert all(pid is not None for pid in p.ping())
    finally:
        p.close()

    inj0 = WorkerKillInjector(kill_on_dispatch=1)
    p0 = ProcPool(1, train_plans=2, retries=0, kill_injector=inj0,
                  request_timeout_s=120.0, device="cpu")
    try:
        p0.register("M", M, "dense_array")
        p0.register("W", W, "dense_array")
        with pytest.raises(EngineDown) as exc:
            p0.execute(q, mode="training")
        assert worker_channel(0) in str(exc.value)
        assert p0.respawns == 1
        rep = p0.execute(q, mode="training")       # next request serves fine
        assert rep.result.data.shape == (40, 4)
    finally:
        p0.close()


def test_worker_without_a_card_fails_cleanly():
    """``device=None`` means the card; on a host without one every worker
    fails to start.  The first RPC must raise ``EngineDown`` on the
    worker's channel, naming why, after at most one respawn and well
    inside its timeout — no hang, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    t0 = time.monotonic()
    p = ProcPool(1, retries=1, start_timeout_s=60.0, request_timeout_s=60.0)
    spawned = []
    real_spawn = p._spawn

    def counting_spawn(idx):
        spawned.append(idx)
        return real_spawn(idx)

    p._spawn = counting_spawn
    try:
        with pytest.raises(EngineDown) as exc:
            p.register("W", T.DenseTensor(np.ones((2, 2))), "dense_array")
        assert worker_channel(0) in str(exc.value)
        assert "no CUDA device" in str(exc.value)
        assert len(spawned) <= 1                    # at most one respawn
        assert p.respawns == 0
        with pytest.raises(EngineDown):
            p.ping()
        assert len(spawned) <= 2
    finally:
        p.close()
    assert time.monotonic() - t0 < 60.0


def test_pool_master_in_a_fresh_process_loads_neither_jax_nor_reference():
    """As ``chip_smoke.py``'s procpool phase runs it: the master in a
    freshly spawned process, given numpy, serving through a 2-worker pool,
    ends with neither JAX nor the reference imported and CUDA never
    initialized; its scattered and unscattered results are bitwise equal
    and equal to the in-process serve."""
    data = _torch_pool.waves(16, 64)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_torch_pool.master_serves,
                       args=(child, "cpu", data, 2, 8, 2))
    proc.start()
    child.close()
    assert parent.poll(240), "pool master did not answer"
    out = parent.recv()
    proc.join(timeout=60)
    assert proc.exitcode == 0
    assert out["jax"] is False and out["repro"] == []
    assert out["cuda_initialized"] is False
    assert out["leaf_types"] == ["ndarray"]
    assert out["always"][1] == 2 and out["never"][1] == 0
    np.testing.assert_array_equal(out["always"][0], out["never"][0])
    bd = T.BigDAWG(train_plans=1, train_repeats=1, device="cpu")
    bd.register("waves", T.DenseTensor(data), "dense_array")
    want = bd.execute(T.qlang.bigdawg(_torch_pool.front_half(2, 8)),
                      mode="training").result
    np.testing.assert_array_equal(out["never"][0], want.data.numpy())


@pytest.mark.parametrize("kw", [dict(kill_on_dispatch=3),
                                dict(kill_on_dispatch=2, target_worker=1),
                                dict(kill_on_dispatch=2, repeat=True)])
def test_worker_kill_injector_fires_as_the_reference_does(kw, monkeypatch):
    # both modules call the one os.kill: record it, one injector at a time
    calls = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: calls.append((pid, sig)))
    killed = {}
    for name, cls in (("port", WorkerKillInjector),
                      ("ref", rfault.WorkerKillInjector)):
        inj = cls(**kw)
        for n in range(9):
            inj.on_dispatch(n % 2, 100 + n)
        killed[name] = (list(calls), inj.kills)
        calls.clear()
    assert killed["port"] == killed["ref"]
    fired, kills = killed["port"]
    assert fired and kills == len(fired)
    assert all(sig == signal.SIGKILL for _, sig in fired)


# ---------------------------------------------------------------------------
# streaming appends across the pool
# ---------------------------------------------------------------------------

def test_pool_append_reaches_every_worker_and_respawn(tmp_path):
    rng = np.random.default_rng(14)
    base = T.DenseTensor(rng.normal(size=(12, 4)).astype(np.float32))
    delta = T.DenseTensor(rng.normal(size=(4, 4)).astype(np.float32))
    state = str(tmp_path / "mon.json")
    with ProcPool(2, state_path=state, train_plans=1, device="cpu") as pool:
        pool.register("S", base, "dense_array", streaming=True)
        pool.register("P", base, "dense_array")
        with pytest.raises(ValueError):
            pool.register("T", base, "dense_array", shards=2, streaming=True)
        with pytest.raises(ValueError):
            pool.append("P", delta)          # not a streaming registration
        with pytest.raises(KeyError):
            pool.append("missing", delta)
        q = T.array.scale(T.Ref("S"), factor=2.0)
        pool.execute(q, mode="training")
        assert pool.append("S", delta) == 1
        full = tt.append_rows(base, delta)
        # both workers serve the grown table (round-robin hits each)
        for _ in range(2):
            rep = pool.execute(q, mode="production")
            np.testing.assert_allclose(rep.result.data, full.data * 2.0,
                                       rtol=1e-5)
        # a killed worker replays the grown table, not the pre-append base
        pool.workers[0].proc.terminate()
        pool.workers[0].proc.join(timeout=10)
        for _ in range(2):
            rep = pool.execute(q, mode="production")
            np.testing.assert_allclose(rep.result.data, full.data * 2.0,
                                       rtol=1e-5)
        assert pool.respawns >= 1


# ---------------------------------------------------------------------------
# API surface: connect(processes=) / QueryServer(processes=)
# ---------------------------------------------------------------------------

def test_connect_with_processes_session(tmp_path):
    state = str(tmp_path / "session.json")
    data = _pool_data()
    with T.connect(state, processes=2, device="cpu", train_plans=2,
                   scatter="always") as s:
        assert isinstance(s.bigdawg, ProcPool)
        assert s.bigdawg.device == "cpu"
        s.register("A", T.ColumnarTable(dict(data["A"][0])), "columnar",
                   shards=2)
        s.register("M", T.DenseTensor(data["M"][0]), "dense_array", shards=2)
        s.register("W", T.DenseTensor(data["W"][0]), "dense_array")
        res = s.execute(T.array.matmul("M", "W"), mode="training")
        assert res.value.data.shape == (40, 4)
        assert res.report.shards == 2
        assert res.provenance == ()        # fragment plans: no per-node map
        res2 = s.execute(T.relational.sort("A", by="value"), mode="training")
        assert np.all(np.diff(res2.value.columns["value"]) >= 0)
        s.persist()
    # context-manager exit closed the pool
    with pytest.raises(RuntimeError):
        s.bigdawg.execute(T.array.count("M"))


def test_queryserver_processes_kwarg():
    data = _pool_data()
    bd = T.BigDAWG(train_plans=2, device="cpu")
    bd.register("M", T.DenseTensor(data["M"][0]), "dense_array")
    bd.register("W", T.DenseTensor(data["W"][0]), "dense_array")
    srv = QueryServer(bd, processes=2)
    try:
        assert isinstance(srv.bd, ProcPool)        # lifted via from_bigdawg
        assert srv.bd.device == "cpu"              # the middleware's device
        q = T.array.matmul("M", "W")
        srv.warm([q])
        rep = srv.submit(q)
        np.testing.assert_allclose(rep.result.data,
                                   data["M"][0] @ data["W"][0], **TOL)
        assert srv.stats["requests"] == 1
    finally:
        srv.close()
