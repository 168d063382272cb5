"""Differential check of the port's engines and casts against the reference:
every (engine, op) in ``ENGINES`` and every registered cast pair runs on the
same numpy inputs in both packages, and the outputs must agree in kind,
dtype, shape, ``valid_count`` and ``nbytes``, with values equal where the
arithmetic is integer or order-free (counts, indices, histograms — the
dense ``bin_hist`` bit for bit) and within 1e-5 elsewhere (float sums are
taken in another order)."""
import numpy as np
import pytest
import torch

from repro.core import cast as rcast
from repro.core import tables as rt
from repro.core.engines import ENGINES as RENGINES
from repro_torch.core import cast as tcast
from repro_torch.core import tables as tt
from repro_torch.core.engines import ENGINES as TENGINES, segment_sum

from _torch_parity import assert_same, both

RNG = np.random.default_rng(1234)
X = RNG.normal(size=(16, 32)).astype(np.float32)
COUNTS = RNG.poisson(1.5, size=(12, 20)).astype(np.float32)
TEST_ROW = RNG.poisson(1.5, size=(1, 20)).astype(np.float32)


def _dense(a):
    return rt.DenseTensor(a)


def _columnar_of(a):
    return rcast.dense_to_columnar(rt.DenseTensor(a))


def _coo_of(a):
    return rcast.dense_to_coo(rt.DenseTensor(a))


def _tfidf_np(tf):
    n = tf.shape[0]
    df = (tf > 0).sum(0).astype(np.float32)
    w = tf * (np.log(n / (1.0 + df)) + 1.0)
    return (w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True),
                           1e-9)).astype(np.float32)


def _keyed():
    keys = RNG.integers(0, 5, 40).astype(np.int32)
    valid = RNG.random(40) < 0.8
    return rt.ColumnarTable({"key": keys,
                             "value": RNG.normal(size=40).astype(np.float32),
                             "other": np.arange(40, dtype=np.int32)},
                            valid=valid)


def _repeats():
    return rt.ColumnarTable(
        {"value": RNG.integers(0, 6, 30).astype(np.float32)},
        valid=RNG.random(30) < 0.7)


def _dim(n):
    return rt.ColumnarTable({"key": np.arange(n, dtype=np.int32),
                             "w": RNG.normal(size=n).astype(np.float32)})


def _stream():
    return rt.StreamBuffer(RNG.normal(size=(6, 16)).astype(np.float32), t0=3)


MA = RNG.normal(size=(6, 5)).astype(np.float32)
MB = RNG.normal(size=(5, 4)).astype(np.float32)
TFIDF = _tfidf_np(COUNTS)

# (engine, op, attrs, input builders, exact)
CASES = [
    ("dense_array", "count", {}, [lambda: _dense(X)], True),
    ("dense_array", "distinct", {}, [lambda: _dense(np.round(X))], True),
    ("dense_array", "matmul", {}, [lambda: _dense(MA), lambda: _dense(MB)],
     False),
    ("dense_array", "select", {"lo": -0.5, "hi": 1.0}, [lambda: _dense(X)],
     True),
    ("dense_array", "haar", {"levels": 3}, [lambda: _dense(X)], False),
    ("dense_array", "bin_hist", {"nbins": 8, "levels": 2},
     [lambda: _dense(X)], True),
    ("dense_array", "tfidf", {}, [lambda: _dense(COUNTS)], False),
    ("dense_array", "knn", {"k": 5},
     [lambda: _dense(TFIDF), lambda: _dense(TEST_ROW)], True),
    ("dense_array", "add", {}, [lambda: _dense(X), lambda: _dense(X * 2)],
     True),
    ("dense_array", "scale", {"factor": 2.5}, [lambda: _dense(X)], True),
    ("dense_array", "transpose", {}, [lambda: _dense(MA)], True),
    ("dense_array", "concat", {}, [lambda: _dense(X), lambda: _dense(X[:3])],
     True),
    ("columnar", "count", {}, [_keyed], True),
    ("columnar", "distinct", {"column": "value"}, [_repeats], True),
    ("columnar", "select", {"column": "value", "lo": -0.5}, [_keyed], True),
    ("columnar", "project", {"columns": ["key", "value"]}, [_keyed], True),
    ("columnar", "groupby_sum", {"key": "key", "value": "value",
                                 "num_groups": 5}, [_keyed], False),
    ("columnar", "sort", {"by": "value"}, [_keyed], True),
    ("columnar", "join", {"left_on": "key", "right_on": "key"},
     [_keyed, lambda: _dim(5)], True),
    ("columnar", "matmul", {}, [lambda: _columnar_of(MA),
                                lambda: _columnar_of(MB)], False),
    ("columnar", "haar", {"levels": 3}, [lambda: _columnar_of(X)], False),
    ("columnar", "bin_hist", {"nbins": 8, "levels": 2},
     [lambda: _columnar_of(X)], True),
    ("columnar", "tfidf", {}, [lambda: _columnar_of(COUNTS)], False),
    ("columnar", "knn", {"k": 5}, [lambda: _columnar_of(TFIDF),
                                   lambda: _columnar_of(TEST_ROW)], True),
    ("kv_sparse", "count", {}, [lambda: _coo_of(COUNTS)], True),
    ("kv_sparse", "distinct", {}, [lambda: _coo_of(COUNTS)], True),
    ("kv_sparse", "spmm", {}, [lambda: _coo_of(COUNTS),
                               lambda: _dense(RNG.normal(size=(20, 3))
                                              .astype(np.float32))], False),
    ("kv_sparse", "tfidf", {}, [lambda: _coo_of(COUNTS)], False),
    ("kv_sparse", "knn", {"k": 5}, [lambda: _coo_of(TFIDF),
                                    lambda: _dense(TEST_ROW)], True),
    ("kv_sparse", "knn", {"k": 4}, [lambda: _coo_of(TFIDF),
                                    lambda: _coo_of(TEST_ROW)], True),
    ("kv_sparse", "degree", {"axis": 0}, [lambda: _coo_of(COUNTS)], True),
    ("kv_sparse", "degree", {"axis": 1}, [lambda: _coo_of(COUNTS)], True),
    ("stream", "window_agg", {"fn": "mean"}, [_stream], False),
    ("stream", "window_agg", {"fn": "max"}, [_stream], True),
    ("stream", "window_agg", {"fn": "min"}, [_stream], True),
    ("stream", "haar", {"levels": 2}, [_stream], False),
    ("stream", "to_array", {}, [_stream], True),
    ("stream", "ingest", {}, [_stream, lambda: _dense(
        RNG.normal(size=(2, 16)).astype(np.float32))], True),
]


def _case_id(case):
    engine, op, attrs = case[:3]
    extra = ",".join(f"{k}={v}" for k, v in attrs.items()
                     if k in ("fn", "axis", "k"))
    return f"{engine}.{op}" + (f"[{extra}]" if extra else "")


def test_cases_cover_every_engine_op():
    covered = {(e, op) for e, op, *_ in CASES}
    assert covered == {(e, op) for e, eng in TENGINES.items()
                       for op in eng.ops}
    assert {e: set(eng.ops) for e, eng in TENGINES.items()} == \
        {e: set(eng.ops) for e, eng in RENGINES.items()}


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_engine_op_matches_reference(case):
    engine, op, attrs, builders, exact = case
    pairs = [both(mk()) for mk in builders]
    ref = RENGINES[engine].run(op, dict(attrs), *[r for r, _ in pairs])
    got = TENGINES[engine].run(op, dict(attrs), *[p for _, p in pairs],
                               device="cpu")
    assert_same(ref, got, exact=exact)
    for leaf in tt.leaves(got):              # outputs live on the session
        if tt.is_tensor(leaf):               # device (host numpy for the
            assert leaf.device.type == "cpu"  # eager triple formats)


def test_dense_bin_hist_bitwise_at_main_path_layout():
    """levels 6, nbins 32 over Haar coefficients: the counts are integers in
    float32, so the port's bincount must equal the reference's one-hot sum
    bit for bit."""
    from repro.kernels.ref import haar_ref as jhaar
    import jax.numpy as jnp
    w = np.random.default_rng(5).normal(size=(8, 1024)).astype(np.float32) * 2
    coeffs = np.asarray(jhaar(jnp.asarray(w), 6))
    ref, got = both(rt.DenseTensor(coeffs))
    attrs = {"nbins": 32, "levels": 6}
    assert_same(RENGINES["dense_array"].run("bin_hist", attrs, ref),
                TENGINES["dense_array"].run("bin_hist", attrs, got,
                                            device="cpu"), exact=True)


def test_segment_sum_drops_out_of_range_ids():
    data = torch.arange(6, dtype=torch.float32)
    ids = torch.tensor([0, 1, 3, -1, 1, 2])
    out = segment_sum(data, ids, 3)
    torch.testing.assert_close(out, torch.tensor([0.0, 5.0, 5.0]))


CAST_INPUTS = {
    "dense": lambda: rt.DenseTensor(np.where(X > 0.3, X, 0.0)
                                    .astype(np.float32)),
    "columnar": lambda: rt.ColumnarTable(
        {"i": np.repeat(np.arange(4), 3).astype(np.int32),
         "j": np.tile(np.arange(3), 4).astype(np.int32),
         "value": RNG.normal(size=12).astype(np.float32)},
        valid=np.array([True] * 10 + [False, True])),
    "coo": lambda: _coo_of(np.where(X > 0.5, X, 0.0).astype(np.float32)),
    "stream": _stream,
}


@pytest.mark.parametrize("pair", sorted(rcast._CASTS),
                         ids=lambda p: f"{p[0]}>{p[1]}")
def test_cast_pair_matches_reference(pair):
    src, dst = pair
    assert set(tcast._CASTS) == set(rcast._CASTS)
    ref_in, port_in = both(CAST_INPUTS[src]())
    ref = rcast._CASTS[pair](ref_in)
    got = tcast.cast_step(port_in, dst, "cpu")
    assert_same(ref, got, exact=True)
    if dst == "dense":                        # dense casts build on the
        assert got.data.device.type == "cpu"  # session device


def test_cast_routes_match_reference():
    for src in ("dense", "columnar", "coo", "stream"):
        for dst in ("dense", "columnar", "coo", "stream"):
            assert tcast.cast_path(src, dst) == rcast.cast_path(src, dst)
