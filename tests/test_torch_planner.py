"""The port's IR, signatures and planner against the reference: identical
``signature_text`` over equivalent catalogs, and — loaded from one
calibration file — identical ``dp_plans`` keys and costs."""
import numpy as np
import jax.numpy as jnp
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.convert import from_numpy_container

LEVELS, NBINS, K = 6, 32, 11
ANALYTIC = (f"ARRAY(knn(tfidf(bin_hist(haar(waves, levels={LEVELS}), "
            f"nbins={NBINS}, levels={LEVELS})), test_hist, k={K}))")
QUICKSTART = ("ARRAY(matmul(RELATIONAL(select(A, column=value, lo=-0.5, "
              "hi=2.0)), B))")
TEXT_Q = ("RELATIONAL(join(A, B, left_on=key, right_on=key)) "
          "|> ARRAY(matmul(_, W))")
MULTI_ISLAND = [
    TEXT_Q,
    "BIGDAWG(ARRAY(matmul(RELATIONAL(join(A, B, left_on=key, "
    "right_on=key)), W)))",
    "RELATIONAL(select(A, column='value', lo=-0.5, hi=2))",
    "ARRAY(A)",
    "DEGENERATE:kv_sparse(tfidf(T))",
    "ARRAY(count(DEGENERATE:dense_array(matmul(M, Wd))))",
]


def _catalog_objects():
    """One set of numpy containers (reference classes) and their homes."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(8, 6)).astype(np.float32)
    ii, kk = np.meshgrid(np.arange(8), np.arange(6), indexing="ij")
    return [
        ("A", R.ColumnarTable({"i": ii.ravel().astype(np.int32),
                               "key": kk.ravel().astype(np.int32),
                               "value": M.ravel()}), "columnar"),
        ("B", R.ColumnarTable({"key": np.arange(6, dtype=np.int32),
                               "j": np.array([2, 0, 5, 1, 4, 3], np.int32)}),
         "columnar"),
        ("W", R.DenseTensor(rng.normal(size=(6, 4)).astype(np.float32)),
         "dense_array"),
        ("M", R.DenseTensor(rng.normal(size=(12, 6)).astype(np.float32)),
         "dense_array"),
        ("Wd", R.DenseTensor(rng.normal(size=(6, 5)).astype(np.float32)),
         "dense_array"),
        ("T", R.COOMatrix(np.array([0, 1, 2], np.int32),
                          np.array([1, 0, 3], np.int32),
                          np.array([1.0, 2.0, 3.0], np.float32), (3, 4)),
         "kv_sparse"),
        ("waves", R.DenseTensor(rng.normal(size=(32, 64)).astype(np.float32)),
         "dense_array"),
        ("test_hist", R.DenseTensor(rng.poisson(
            2.0, size=(1, (LEVELS + 1) * NBINS)).astype(np.float32)),
         "dense_array"),
    ]


def _both_bigdawgs(cm_path=None):
    rb = R.BigDAWG(cost_model=R.CostModel(cm_path), fuse=False)
    tb = T.BigDAWG(cost_model=T.CostModel(cm_path), device="cpu")
    for name, obj, engine in _catalog_objects():
        if obj.kind == "dense":
            rb.register(name, R.DenseTensor(jnp.asarray(obj.data)), engine)
        else:
            rb.register(name, obj, engine)
        tb.register(name, from_numpy_container(obj, "cpu"), engine)
    return rb, tb


@pytest.fixture(scope="module")
def calib_path(tmp_path_factory):
    """One calibration file, measured by the reference, read by both."""
    path = str(tmp_path_factory.mktemp("calib") / "monitor.calib.json")
    cm = R.CostModel(path)
    cm.calibrate(n=32)
    return path


@pytest.mark.parametrize("text", [ANALYTIC, QUICKSTART] + MULTI_ISLAND)
def test_signature_text_identical(text):
    rb, tb = _both_bigdawgs()
    rq, tq = R.bigdawg(text), T.bigdawg(text)
    assert T.signature_text(tq, tb.catalog) == \
        R.signature_text(rq, rb.catalog)
    assert T.signature(tq, tb.catalog) == R.signature(rq, rb.catalog)


def test_signature_renders_torch_shapes_like_jax():
    rb, tb = _both_bigdawgs()
    text = T.signature_text(T.bigdawg("ARRAY(matmul(M, Wd))"), tb.catalog)
    assert "$M:dense(12, 6)" in text and "$Wd:dense(6, 5)" in text


def _planner_dp_queries(isl):
    """The query shapes of tests/test_planner_dp.py, in one package."""
    def analytic():
        s = isl.relational.select("waves", column="value", lo=0.0)
        h = isl.array.haar(s, levels=2)
        b = isl.array.bin_hist(h, nbins=8, levels=2)
        return isl.array.tfidf(b)

    def wide():
        return isl.array.matmul(analytic(), isl.array.transpose(analytic()))

    def diamond():
        a = isl.array.select("waves", lo=0.0)
        return isl.array.matmul(a, isl.array.tfidf(a))

    def shared():
        h = isl.array.tfidf("waves")
        return isl.array.matmul(h, isl.array.scale(h, factor=2.0))

    return {
        "matmul_select": lambda: isl.array.matmul(
            isl.relational.select("waves", column="value", lo=-1.0),
            "waves"),
        "analytic_small": analytic,
        "wide": wide,
        "diamond": diamond,
        "shared": shared,
    }


PLANNER_CASES = ["analytic", "quickstart", "matmul_select", "analytic_small",
                 "wide", "diamond", "shared"]


@pytest.mark.parametrize("case", PLANNER_CASES)
def test_dp_plans_identical_from_one_calibration(case, calib_path):
    rb, tb = _both_bigdawgs(calib_path)
    assert rb.cost_model.calibrated and tb.cost_model.calibrated
    if case == "analytic":
        rq, tq = R.bigdawg(ANALYTIC), T.bigdawg(ANALYTIC)
    elif case == "quickstart":
        rq, tq = R.bigdawg(QUICKSTART), T.bigdawg(QUICKSTART)
    else:
        rq = _planner_dp_queries(R.api.IslandNamespace())[case]()
        tq = _planner_dp_queries(T.api.IslandNamespace())[case]()
    ref = R.dp_plans(rq, rb.catalog, max_plans=8, cost_model=rb.cost_model)
    got = T.dp_plans(tq, tb.catalog, max_plans=8, cost_model=tb.cost_model)
    assert [p.key for _, p in got] == [p.key for _, p in ref]
    np.testing.assert_allclose([c for c, _ in got], [c for c, _ in ref],
                               rtol=1e-12)
