"""The port's CUDA kernels and main path on the card.  Every test here needs
a CUDA device and skips without one; run them on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
(``chip_smoke.py`` covers the same ground at the main path's full size.)"""
import numpy as np
import pytest
import torch

from repro_torch.core import DenseTensor, connect
from repro_torch.kernels import ops
from repro_torch.kernels.haar import haar_cuda, haar_ref
from repro_torch.kernels.knn import knn_scores_cuda, knn_scores_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,t,levels", [(4, 16, 2), (130, 256, 4), (3, 32, 1),
                                        (64, 16384, 6), (2, 65536, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_haar_kernel_bitwise_equals_plain(cuda, n, t, levels, dtype):
    x = torch.randn((n, t), device=cuda).to(dtype)
    torch.testing.assert_close(haar_cuda(x, levels), haar_ref(x, levels),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,v,b", [(64, 128, 4), (100, 48, 3), (4096, 224, 1),
                                   (33, 2050, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_kernel_matches_plain(cuda, n, v, b, dtype):
    train = torch.randn((n, v), device=cuda).to(dtype)
    test = torch.randn((b, v), device=cuda).to(dtype)
    tol = dict(rtol=2e-2, atol=0.3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(knn_scores_cuda(train, test),
                               knn_scores_ref(train, test), **tol)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        haar_cuda(torch.zeros((2, 8), device=cuda, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        haar_cuda(torch.zeros((2, 8), device=cuda).t(), 1)
    with pytest.raises(TypeError):
        knn_scores_cuda(torch.zeros((4, 8), device=cuda),
                        torch.zeros((1, 8), device=cuda,
                                    dtype=torch.bfloat16))


def test_main_path_launches_both_kernels(cuda):
    rng = np.random.default_rng(0)
    waves = rng.normal(size=(32, 256)).astype(np.float32)
    s = connect(device=cuda, train_plans=4)
    s.register("waves", DenseTensor(torch.from_numpy(waves)), "dense_array")
    s.register("test_hist", DenseTensor(torch.from_numpy(
        rng.poisson(2.0, size=(1, 32)).astype(np.float32))), "dense_array")
    ops.reset_launches()
    res = s.execute("ARRAY(knn(tfidf(bin_hist(haar(waves, levels=3), "
                    "nbins=8, levels=3)), test_hist, k=5))", mode="training")
    assert res.value.data.is_cuda and res.value.data.dtype == torch.int32
    assert ops.launches()["haar"] > 0 and ops.launches()["knn_scores"] > 0


def _engine_cases():
    """(engine, op, attrs, inputs) over every op in ENGINES, built from
    numpy with the port's own casts (no reference package on the card)."""
    from repro_torch.core import cast, tables
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    counts = rng.poisson(1.5, size=(12, 20)).astype(np.float32)
    row = rng.poisson(1.5, size=(1, 20)).astype(np.float32)
    ma = rng.normal(size=(6, 5)).astype(np.float32)
    mb = rng.normal(size=(5, 4)).astype(np.float32)
    dense = lambda a: tables.DenseTensor(a)
    col = lambda a: cast.dense_to_columnar(tables.DenseTensor(a))
    coo = lambda a: cast.dense_to_coo(tables.DenseTensor(a))
    keyed = tables.ColumnarTable(
        {"key": rng.integers(0, 5, 40).astype(np.int32),
         "value": rng.normal(size=40).astype(np.float32)},
        valid=rng.random(40) < 0.8)
    dim = tables.ColumnarTable({"key": np.arange(5, dtype=np.int32),
                                "w": rng.normal(size=5).astype(np.float32)})
    stream = tables.StreamBuffer(rng.normal(size=(6, 16)).astype(np.float32))
    feats = counts / np.linalg.norm(counts, axis=1, keepdims=True)
    return [
        ("dense_array", "count", {}, [dense(x)]),
        ("dense_array", "distinct", {}, [dense(np.round(x))]),
        ("dense_array", "matmul", {}, [dense(ma), dense(mb)]),
        ("dense_array", "select", {"lo": -0.5}, [dense(x)]),
        ("dense_array", "haar", {"levels": 3}, [dense(x)]),
        ("dense_array", "bin_hist", {"nbins": 8, "levels": 2}, [dense(x)]),
        ("dense_array", "tfidf", {}, [dense(counts)]),
        ("dense_array", "knn", {"k": 5}, [dense(feats), dense(row)]),
        ("dense_array", "add", {}, [dense(x), dense(x)]),
        ("dense_array", "scale", {"factor": 2.0}, [dense(x)]),
        ("dense_array", "transpose", {}, [dense(ma)]),
        ("dense_array", "concat", {}, [dense(x), dense(x[:2])]),
        ("columnar", "count", {}, [keyed]),
        ("columnar", "distinct", {"column": "key"}, [keyed]),
        ("columnar", "select", {"column": "value", "lo": 0.0}, [keyed]),
        ("columnar", "project", {"columns": ["value"]}, [keyed]),
        ("columnar", "groupby_sum", {"key": "key", "value": "value",
                                     "num_groups": 5}, [keyed]),
        ("columnar", "sort", {"by": "value"}, [keyed]),
        ("columnar", "join", {"left_on": "key", "right_on": "key"},
         [keyed, dim]),
        ("columnar", "matmul", {}, [col(ma), col(mb)]),
        ("columnar", "haar", {"levels": 3}, [col(x)]),
        ("columnar", "bin_hist", {"nbins": 8, "levels": 2}, [col(x)]),
        ("columnar", "tfidf", {}, [col(counts)]),
        ("columnar", "knn", {"k": 5}, [col(feats), col(row)]),
        ("kv_sparse", "count", {}, [coo(counts)]),
        ("kv_sparse", "distinct", {}, [coo(counts)]),
        ("kv_sparse", "spmm", {}, [coo(counts), dense(
            rng.normal(size=(20, 3)).astype(np.float32))]),
        ("kv_sparse", "tfidf", {}, [coo(counts)]),
        ("kv_sparse", "knn", {"k": 5}, [coo(feats), coo(row)]),
        ("kv_sparse", "degree", {"axis": 1}, [coo(counts)]),
        ("stream", "window_agg", {"fn": "max"}, [stream]),
        ("stream", "haar", {"levels": 2}, [stream]),
        ("stream", "to_array", {}, [stream]),
        ("stream", "ingest", {}, [stream, dense(x[:2, :16].copy())]),
    ]


def test_every_engine_op_on_cuda_matches_cpu(cuda):
    """Each op, its inputs homed on the card, against the same op on the
    CPU: values within 1e-5 (float sums run in another order), equal
    dtypes and shapes, and every output tensor on the card."""
    from repro_torch.core import tables
    from repro_torch.core.engines import ENGINES
    cases = _engine_cases()
    assert {(e, op) for e, op, _, _ in cases} == \
        {(e, op) for e, eng in ENGINES.items() for op in eng.ops}
    for engine, op, attrs, inputs in cases:
        on_card = [tables.device_ready(i, cuda) for i in inputs]
        on_host = [tables.device_ready(i, "cpu") for i in inputs]
        got = ENGINES[engine].run(op, dict(attrs), *on_card, device=cuda)
        want = ENGINES[engine].run(op, dict(attrs), *on_host, device="cpu")
        assert got.kind == want.kind, (engine, op)
        for g, w in zip(tables.leaves(got), tables.leaves(want)):
            if tables.is_tensor(g):
                assert g.device.type == "cuda", (engine, op)
            g, w = tables.to_numpy(g), tables.to_numpy(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (engine, op)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{engine}.{op}")
