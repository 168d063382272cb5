"""The port's CUDA kernels and main path on the card.  Every test here needs
a CUDA device and skips without one; run them on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
(``chip_smoke.py`` covers the same ground at the main path's full size.)"""
import numpy as np
import pytest
import torch

from repro_torch.core import (BigDAWG, DenseTensor, Plan, Ref, array,
                              connect, fuseplan)
from repro_torch.kernels import ops
from repro_torch.kernels.haar import haar_cuda, haar_ref
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref, variant)
from repro_torch.kernels.knn import (knn_scores_cuda, knn_scores_ref,
                                     variant as knn_variant)
from repro_torch.kernels.ssd_scan import (ssd_intra_cuda, ssd_intra_ref,
                                          variant as ssd_variant)

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


# chip_smoke.KNN_SHAPES and more: B at both ends of each regime, ragged N,
# V not a multiple of 8 (element-wise loads) or longer than a chunk
@pytest.mark.parametrize("n,v,b", [(64, 128, 4), (100, 48, 3), (4096, 224, 1),
                                   (33, 2050, 9), (4096, 224, 64),
                                   (1001, 227, 8), (1001, 227, 9),
                                   (517, 600, 2), (130, 40, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_knn_kernel_matches_plain(cuda, n, v, b, dtype):
    train = torch.randn((n, v), device=cuda).to(dtype)
    test = torch.randn((b, v), device=cuda).to(dtype)
    tol = dict(rtol=2e-2, atol=0.3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-3)
    got = knn_scores_cuda(train, test)
    want = knn_scores_ref(train, test)
    torch.testing.assert_close(got, want, **tol)
    if dtype == torch.float32:             # as chip_smoke.phase_knn
        kk = min(11, n)
        assert torch.equal(torch.topk(got, kk)[1], torch.topk(want, kk)[1])


@pytest.mark.parametrize("b,kind", [(1, "gemv"), (8, "gemv"), (9, "tiled"),
                                    (64, "tiled")])
def test_knn_variant_counters(cuda, b, kind):
    """ops.knn_scores launches the kernel that knn.variant names for B,
    once, and counts it in the total too."""
    assert knn_variant(b) == kind
    ops.reset_launches()
    ops.knn_scores(torch.randn((300, 224), device=cuda),
                   torch.randn((b, 224), device=cuda))
    counts = ops.launches()
    assert counts["knn_scores"] == 1
    for other in ("gemv", "tiled"):
        assert counts[f"knn_scores_{other}"] == int(other == kind)


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


# -- the LM kernels and serving path ------------------------------------------

@pytest.mark.parametrize("bh,s,d,causal,dtype", [
    (16, 2048, 128, True, torch.bfloat16),     # the dense prefill path
    (16, 2048, 128, True, torch.float32),      # its float32 prefill
    (16, 2048, 64, True, torch.float32),
    (3, 1, 64, True, torch.float32),
    (2, 77, 128, True, torch.float32),
    (3, 200, 128, False, torch.float32),
    (3, 77, 80, True, torch.float32),
    (2, 1000, 64, True, torch.float32),
    (2, 333, 80, False, torch.float32),
    (4, 129, 17, True, torch.bfloat16),
    (2, 65, 200, True, torch.float32),
    (2, 65, 200, False, torch.bfloat16),
    (3, 150, 40, True, torch.bfloat16),        # chip_smoke's d 40 and 256
    (3, 150, 40, False, torch.float32),
    (2, 97, 256, True, torch.float32),
    (2, 97, 256, False, torch.bfloat16),
    (4, 61, 32, True, torch.float32),
    (2, 300, 112, True, torch.bfloat16),
    (2, 300, 112, True, torch.float32),
    (5, 1, 8, True, torch.float32),
    (3, 33, 24, False, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda, bh, s, d, causal, dtype):
    """Any length (ragged q and k tiles), any width up to 256; the
    reference tests' tolerances.  Where a tensor-core kernel takes the
    shape, the CUDA-core kernel (forced) is held to the same."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), flash_attention_ref(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:            # as chip_smoke.phase_flash
        want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
        assert float((got.float() - want32).abs().max()) <= 1.6e-2
    if variant(dtype, d) != "simt":
        simt = flash_attention_cuda(q, k, v, causal=causal, kind="simt")
        torch.testing.assert_close(simt.float(), flash_attention_ref(
            q, k, v, causal=causal).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dtype", [
    (1, 77, 4096, 16, 16, 64, torch.bfloat16),    # seamless's cross, "tc"
    (1, 1, 4096, 16, 16, 64, torch.bfloat16),     # its 1-token prompt
    (2, 300, 130, 4, 2, 64, torch.bfloat16),
    (1, 130, 300, 8, 2, 128, torch.bfloat16),
    (2, 300, 130, 4, 2, 128, torch.bfloat16),
    (1, 77, 4096, 16, 16, 64, torch.float32),     # "tf32"
    (1, 1, 4096, 16, 16, 64, torch.float32),
    (2, 300, 130, 4, 2, 64, torch.float32),
    (1, 130, 300, 8, 2, 128, torch.float32),
    (1, 77, 333, 8, 2, 80, torch.bfloat16),       # "mma"
    (1, 300, 97, 4, 4, 112, torch.float32),
    (1, 1, 4096, 4, 4, 32, torch.float32),
    (1, 61, 97, 4, 4, 32, torch.float32),         # the encdec ragged_check
    (2, 70, 150, 4, 2, 17, torch.bfloat16),       # "simt"
    (2, 150, 70, 4, 1, 17, torch.float32),
])
def test_flash_cross_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, dtype):
    """Non-causal attention of Sq query rows against Sk keys (the
    encoder-decoder's cross-attention), Sq < Sk and Sq > Sk, on every
    kernel: the one ``variant`` names, and the CUDA-core kernel forced."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    want = flash_attention_ref(q, k, v, causal=False).float()
    kinds = {variant(dtype, d), "simt"}
    for kind in sorted(kinds):
        ops.reset_launches()
        got = flash_attention_cuda(q, k, v, causal=False, kind=kind)
        assert ops.launches()[f"flash_attention_{kind}"] == 1
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:            # as chip_smoke.phase_flash
        want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=False)
        got = flash_attention_cuda(q, k, v, causal=False)
        assert float((got.float() - want32).abs().max()) <= 1.6e-2


def _expand_fold(t, h):
    """(B, S, KV, d) -> (B·H, S, d): KV heads repeated to h query heads."""
    B, S, _, d = t.shape
    t = torch.repeat_interleave(t, h // t.shape[2], dim=2)
    return t.permute(0, 2, 1, 3).reshape(B * h, S, d)


@pytest.mark.parametrize("b,s,h,kv,d,causal,dtype", [
    (1, 2048, 16, 8, 128, True, torch.bfloat16),   # internlm2's prefill
    (2, 1, 4, 2, 128, True, torch.bfloat16),
    (1, 63, 4, 1, 64, True, torch.bfloat16),
    (2, 64, 4, 4, 128, True, torch.bfloat16),
    (1, 65, 8, 2, 128, False, torch.bfloat16),
    (2, 129, 4, 2, 64, False, torch.bfloat16),
    (1, 1000, 4, 2, 128, True, torch.bfloat16),
    (1, 1000, 4, 1, 80, True, torch.bfloat16),
    (2, 129, 4, 2, 80, False, torch.float32),
    (1, 65, 4, 4, 128, True, torch.float32),
    (1, 63, 6, 2, 64, False, torch.float32),
    (1, 333, 8, 2, 64, True, torch.float32),
    (2, 130, 4, 2, 128, True, torch.float32),
    (1, 61, 4, 2, 32, True, torch.float32),      # the dense ragged_check
    (1, 77, 8, 2, 40, True, torch.float32),      # chip_smoke's mma shapes
    (1, 130, 4, 2, 256, True, torch.bfloat16),
    (1, 1000, 4, 1, 80, True, torch.float32),
    (1, 513, 8, 8, 112, True, torch.bfloat16),
    (2, 200, 8, 4, 112, False, torch.float32),
])
def test_flash_gqa_kernel_matches_plain(cuda, b, s, h, kv, d, causal, dtype):
    """The (B, S, H, d) form with KV heads read in place, against the plain
    version on expanded and folded inputs, and against the kernel's own
    (BH, S, d) form on those inputs."""
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    qf, kf, vf = _expand_fold(q, h), _expand_fold(k, h), _expand_fold(v, h)
    unfold = lambda o: o.reshape(b, h, s, d).permute(0, 2, 1, 3)
    want = unfold(flash_attention_ref(qf, kf, vf, causal=causal))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    folded = unfold(flash_attention_cuda(qf, kf, vf, causal=causal))
    torch.testing.assert_close(got.float(), folded.float(), rtol=tol,
                               atol=tol)
    if dtype == torch.bfloat16:            # as chip_smoke.phase_flash
        want32 = unfold(flash_attention_ref(qf.float(), kf.float(),
                                            vf.float(), causal=causal))
        assert float((got.float() - want32).abs().max()) <= 1.6e-2


@pytest.mark.parametrize("d", [128, 64, 112, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_inputs(cuda, dtype, d):
    """Non-contiguous q, k and v (heads-major storage, last dim contiguous)
    are read in place and give the contiguous inputs' result."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 8, 200, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, 2, 200, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    assert not q.is_contiguous()
    got = flash_attention_cuda(q, k, v)
    want = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("d", [128, 64, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_narrowed_kv_heads(cuda, dtype, d):
    """k and v narrowed to one KV head of 8 (a rank's share where the KV
    projection stays whole: ``layers.rank_kv``) are read in place and give
    the contiguous copies' result and the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((1, 300, 3, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((1, 300, 8, d), generator=gen, device=cuda)
            .to(dtype).narrow(2, 5, 1) for _ in range(2))
    assert not k.is_contiguous()
    got = flash_attention_cuda(q, k, v)
    want = flash_attention_cuda(q, k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), flash_attention_ref(
        q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,d,kind", [(torch.bfloat16, 128, "tc"),
                                          (torch.bfloat16, 64, "tc"),
                                          (torch.float32, 128, "tf32"),
                                          (torch.float32, 64, "tf32"),
                                          (torch.float32, 80, "mma"),
                                          (torch.bfloat16, 80, "mma"),
                                          (torch.float32, 32, "mma"),
                                          (torch.bfloat16, 112, "mma"),
                                          (torch.float32, 17, "simt"),
                                          (torch.bfloat16, 17, "simt")])
def test_flash_variant_counters(cuda, dtype, d, kind):
    """At d 64 and 128 bfloat16 launches only the bfloat16 tensor-core
    kernel and float32 only the 3xTF32 one; every other multiple of 8 only
    the warp-level tensor-core kernel; the widths left only the CUDA-core
    kernel."""
    assert variant(dtype, d) == kind
    q = torch.randn((1, 70, 4, d), device=cuda).to(dtype)
    kv = torch.randn((1, 70, 2, d), device=cuda).to(dtype)
    ops.reset_launches()
    ops.flash_attention(q, kv, kv)
    counts = ops.launches()
    for other in ("tc", "tf32", "mma", "simt"):
        assert counts[f"flash_attention_{other}"] == int(other == kind)


_SSD_SHAPES = [
    (16, 128, 32, 64, 1, 128),                 # the SSM prefill path (mamba2)
    (4, 128, 8, 64, 1, 64),                    # zamba2's p and n
    (2, 128, 112, 64, 1, 64),                  # and its 112 heads
    (2, 128, 8, 64, 2, 32),
    (3, 40, 6, 17, 2, 9),
    (5, 77, 4, 33, 2, 31),
    (2, 1, 2, 5, 1, 3),
]


def _ssd_inputs(cuda, b, q, h, p, g, n):
    gen = torch.Generator(device=cuda).manual_seed(q)
    x = torch.randn((b, q, h, p), generator=gen, device=cuda)
    da = -torch.nn.functional.softplus(
        torch.randn((b, q, h), generator=gen, device=cuda))
    B = torch.randn((b, q, g, n), generator=gen, device=cuda)
    C = torch.randn((b, q, g, n), generator=gen, device=cuda)
    return x, da, B, C


# every shape on the CUDA-core kernel, and on the tensor-core kernel where
# variant() names it
@pytest.mark.parametrize("kind,b,q,h,p,g,n", [
    (kind, *shape) for shape in _SSD_SHAPES for kind in ("tc", "simt")
    if kind == "simt" or ssd_variant(shape[1], shape[3], shape[5]) == "tc"])
def test_ssd_kernel_matches_plain(cuda, kind, b, q, h, p, g, n):
    x, da, B, C = _ssd_inputs(cuda, b, q, h, p, g, n)
    got = ssd_intra_cuda(x, da, B, C, kind=kind)
    want = ssd_intra_ref(*(t.double() for t in (x, da, B, C)))
    # against float64, at tolerances scaled to the output (chip_smoke.SSD_TOL)
    for a, w, (rtol, atol, scaled) in zip(got, want, [
            (2e-4, 2e-4, True), (2e-4, 2e-4, True), (1e-5, 1e-6, False)]):
        assert a.dtype == torch.float32
        if scaled:
            atol *= float(w.abs().max())
        torch.testing.assert_close(a.double(), w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", _SSD_SHAPES)
def test_ssd_variant_counters(cuda, shape):
    """ops.ssd_intra launches exactly the kernel that variant() names for
    the shape, once."""
    b, q, h, p, g, n = shape
    kind = ssd_variant(q, p, n)
    ops.reset_launches()
    ops.ssd_intra(*_ssd_inputs(cuda, b, q, h, p, g, n))
    other = "simt" if kind == "tc" else "tc"
    counts = ops.launches()
    assert counts[f"ssd_intra_{kind}"] == 1
    assert counts[f"ssd_intra_{other}"] == 0


def test_lm_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 8, 2, 4), device=cuda)
    with pytest.raises(TypeError):
        ssd_intra_cuda(x.bfloat16(), torch.zeros((1, 8, 2), device=cuda),
                       torch.zeros((1, 8, 1, 4), device=cuda),
                       torch.zeros((1, 8, 1, 4), device=cuda))
    q = torch.zeros((1, 8, 264), device=cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 8, 6, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention_cuda(q, q[:, :, :4], q[:, :, :4])
    # 64 columns that start 2 bytes past a 16-byte boundary
    wide = torch.zeros((1, 8, 6, 72), device=cuda, dtype=torch.bfloat16)
    odd = wide[:, :, :, 1:65]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_cuda(odd, odd, odd)
    # the same at a width of the warp-level kernel
    wide = torch.zeros((1, 8, 6, 88), device=cuda, dtype=torch.bfloat16)
    odd = wide[:, :, :, 1:81]
    assert variant(torch.bfloat16, 80) == "mma"
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_cuda(odd, odd, odd)
    before = ops.launches()
    q = torch.zeros((1, 8, 4, 17), device=cuda)
    with pytest.raises(ValueError, match="no 'mma' kernel"):
        flash_attention_cuda(q, q, q, kind="mma")
    assert ops.launches() == before


LM_NAMES = ["internlm2-1.8b", "mamba2-370m", "deepseek-v2-lite-16b",
            "grok-1-314b", "zamba2-7b", "internvl2-26b", "seamless-m4t-medium",
            "qwen2-72b", "glm4-9b", "codeqwen1.5-7b"]


def _stub(cfg, batch, frames=40, seed=0):
    """The frontend stub's inputs of a family on the CPU, in float32:
    patch embeddings (vlm) or ``frames`` frames (encdec); {} for the
    others."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(
            (batch, cfg.num_frontend_tokens, cfg.d_model), generator=gen)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, frames, cfg.d_model),
                                      generator=gen)}
    return {}


def _flash_counter(cfg) -> str:
    """The launch counter of a float32 flash call at the config's q/k
    width (MLA: qk_nope + qk_rope)."""
    d = cfg.head_dim if cfg.mla is None else \
        cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return "flash_attention_" + variant(torch.float32, d)


def _prefill_launches(cfg) -> dict:
    """{launch counter: launches} of one float32 prefill of the config:
    SSD in every Mamba layer, flash attention in every attention layer
    (the hybrid: its shared block, once a group; the encoder-decoder: each
    encoder layer, and twice a decoder layer); chip_smoke's map."""
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        out["ssd_intra_" + ssd_variant(ssm.chunk, ssm.head_dim,
                                       ssm.state_dim)] = cfg.num_layers
    if cfg.family == "hybrid":
        out[_flash_counter(cfg)] = cfg.num_layers // cfg.attn_period
    elif cfg.family == "encdec":
        out[_flash_counter(cfg)] = cfg.encoder_layers + 2 * cfg.num_layers
    elif cfg.family != "ssm":
        out[_flash_counter(cfg)] = cfg.num_layers
    return out


def _step_launches(cfg) -> dict:
    """{launch counter: launches} of one train step under block remat:
    twice a layer, but in the hybrid's tail, which is not
    rematerialized."""
    tail = cfg.num_layers % cfg.attn_period if cfg.family == "hybrid" else 0
    return {k: 2 * n - (tail if k.startswith("ssd_") else 0)
            for k, n in _prefill_launches(cfg).items()}


def _only(launches: dict, want: dict) -> bool:
    """Each counter of ``want`` at its count, every other counter 0."""
    return launches == {k: want.get(k, 0) for k in launches}


@pytest.mark.parametrize("name", LM_NAMES)
def test_smoke_batch_server_on_cuda_launches_the_kernels(cuda, name):
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.models import api
    from repro_torch.runtime import BatchServer, Request
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32")
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             plan, cuda)
    shape = ShapeConfig("serve", "decode", 64, 2)
    pre = api.make_prefill(cfg, shape, plan)
    stub = {k: t.to(cuda) for k, t in _stub(cfg, 1).items()}
    srv = BatchServer(slots=2, max_len=64,
                      prefill_fn=lambda p, t: pre(p, {"tokens": t, **stub}),
                      decode_fn=api.make_decode_step(cfg, shape, plan),
                      params=params,
                      init_cache_fn=lambda b, ml: api.init_cache(
                          cfg, b, ml, torch.float32, cuda))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate((17, 5, 30))]
    ops.reset_launches()
    srv.run(reqs)
    launches = ops.launches()
    assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
    want = {k: 3 * n for k, n in _prefill_launches(cfg).items()}
    assert _only(launches, want), (launches, want)


@pytest.mark.parametrize("name", LM_NAMES)
def test_smoke_prefill_on_cuda_matches_cpu(cuda, name):
    """The smoke config's float32 prefill of a 29-token prompt (after the
    frontend stub's inputs) from one set of parameters on the card
    (kernels) and on the CPU (plain versions): logits and every cache leaf
    within chip_smoke's cpu_check tolerance, 1e-3."""
    from repro_torch.configs import PlanConfig, ShapeConfig, get_arch
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(2), plan,
                             "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 29)).astype(np.int32))
    batch = {"tokens": tokens, **_stub(cfg, 1, frames=53, seed=2)}
    pre = api.make_prefill(cfg, ShapeConfig("serve", "prefill", 64, 1),
                           plan)
    ops.reset_launches()
    card = pre(tree_map(lambda t: t.to(cuda), params),
               tree_map(lambda t: t.to(cuda), batch))
    assert _only(ops.launches(), _prefill_launches(cfg)), ops.launches()
    host = pre(params, batch)
    for a, w in zip(tree_leaves(card), tree_leaves(host)):
        assert a.dtype == w.dtype and a.shape == w.shape
        torch.testing.assert_close(a.cpu(), w, rtol=1e-3, atol=1e-3)


# -- training: the kernels' gradients and a train step ------------------------

def _rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("b,s,h,kv,d", [(2, 256, 4, 2, 32),   # dense smoke
                                        (1, 512, 16, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_through_the_kernel_matches_plain(cuda, b, s, h, kv,
                                                         d, dtype):
    """ops.flash_attention with inputs that require a gradient: the kernel
    forward (launched, counted) and the plain backward, against autograd
    through the plain version (chip_smoke's grad_check tolerances)."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    got = torch.autograd.grad(ops.flash_attention(*ins, causal=True), ins,
                              do)
    assert ops.launches()["flash_attention_" + variant(dtype, d)] == 1
    want = torch.autograd.grad(flash_attention_ref(*ins, causal=True), ins,
                               do)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [(2, 61, 97, 4, 4, 32),
                                             (2, 500, 2048, 16, 16, 64),
                                             (2, 300, 130, 8, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_gradient_through_the_kernel_matches_plain(
        cuda, b, sq, sk, h, kv, d, dtype):
    """Non-causal, Sq != Sk (the encoder-decoder's cross-attention): the
    kernel forward and the plain backward against autograd through the
    plain version, at chip_smoke's grad_check tolerances."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=gen, device=cuda).to(dtype)
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    got = torch.autograd.grad(ops.flash_attention(*ins, causal=False), ins,
                              do)
    assert ops.launches()["flash_attention_" + variant(dtype, d)] == 1
    want = torch.autograd.grad(flash_attention_ref(*ins, causal=False), ins,
                               do)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))


@pytest.mark.parametrize("b,q,h,p,g,n", [(8, 8, 16, 16, 1, 16),   # smoke
                                         (4, 128, 32, 64, 1, 128)])
def test_ssd_gradient_through_the_kernel_matches_plain(cuda, b, q, h, p, g,
                                                       n):
    x, da, B, C = _ssd_inputs(cuda, b, q, h, p, g, n)
    ins = [t.requires_grad_(True) for t in (x, da, B, C)]
    gen = torch.Generator(device=cuda).manual_seed(1)
    ops.reset_launches()
    outs = ops.ssd_intra(*ins)
    assert ops.launches()["ssd_intra_" + ssd_variant(q, p, n)] == 1
    cots = [torch.randn(o.shape, generator=gen, device=cuda) for o in outs]
    got = torch.autograd.grad(outs, ins, cots)
    want = torch.autograd.grad(ssd_intra_ref(*ins), ins, cots)
    for name, a, w in zip(("x", "da", "B", "C"), got, want):
        assert float(a.abs().max()) > 0, name
        assert _rel_err(a, w) <= 1e-4, (name, _rel_err(a, w))


@pytest.mark.parametrize("name", LM_NAMES)
def test_smoke_train_step_on_cuda_matches_cpu(cuda, name):
    """One float32 train step of the smoke config from one state on the
    card (kernels, twice a layer under block remat) and on the CPU (plain
    versions): chip_smoke's cpu_check at the smoke size, each leaf's
    gradient within 1e-4 of its largest magnitude."""
    from repro_torch.configs import PlanConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.optim import AdamW
    cfg = get_arch(name).smoke()
    plan = PlanConfig(param_dtype="float32", compute_dtype="float32")
    opt = AdamW(learning_rate=1e-3)
    state = api.init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                 opt, "cpu")
    batch = {"tokens": TokenStream(cfg.vocab_size, 2, 256).batch_at(0),
             **_stub(cfg, 2, frames=300)}
    step = api.make_train_step(cfg, plan, opt)
    ops.reset_launches()
    card, m_card = step(tree_map(lambda t: t.to(cuda), state),
                        tree_map(lambda t: t.to(cuda), batch))
    launches = ops.launches()
    host, m_host = step(state, batch)
    assert _only(launches, _step_launches(cfg)), launches
    np.testing.assert_allclose(float(m_card["loss"]), float(m_host["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m_card["grad_norm"]),
                               float(m_host["grad_norm"]), rtol=1e-3)
    for a, w in zip(tree_leaves(card["master"]), tree_leaves(host["master"])):
        np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=3e-3,
                                   atol=1e-3)
    # each leaf's gradient, as the first step's moment m: a leaf whose
    # gradient is lost on the card reads 1 here, while its master moves by
    # under lr and passes the check above
    for i, (a, w) in enumerate(zip(tree_leaves(card["opt"]["m"]),
                                   tree_leaves(host["opt"]["m"]))):
        assert _rel_err(a.cpu(), w) <= 1e-4, (i, _rel_err(a.cpu(), w))


# -- MoE and MLA at the smoke size --------------------------------------------

def test_mla_attention_on_cuda_matches_cpu(cuda):
    """deepseek's smoke MLA (q/k 48 wide, v 32 padded to 48) over 61
    tokens in float32: the warp-level flash kernel on the card, the plain
    version on the CPU, from the same parameters and inputs; the latent
    cache rows too."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map
    cfg = get_arch("deepseek-v2-lite-16b").smoke()
    p = L.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32,
                   device=torch.device("cpu"))
    x = torch.randn((2, 61, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(61)
    ops.reset_launches()
    got, (c, kr) = L.mla_apply(tree_map(lambda a: a.to(cuda), p), cfg,
                               x.to(cuda), pos.to(cuda))
    launches = ops.launches()
    want, (wc, wkr) = L.mla_apply(p, cfg, x, pos)
    assert launches[_flash_counter(cfg)] == 1
    for a, b in ((got, want), (c, wc), (kr, wkr)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,lead", [("deepseek-v2-lite-16b", (2, 16)),
                                       ("deepseek-v2-lite-16b", (8,)),
                                       ("grok-1-314b", (2, 16)),
                                       ("grok-1-314b", (3,))])
def test_moe_apply_on_cuda_matches_cpu(cuda, name, lead):
    """Prefill (B, S, D) and decode (B, D) routing of the smoke configs on
    the card and on the CPU, float32: output and aux loss."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map
    cfg = get_arch(name).smoke()
    p = M.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32,
                   device=torch.device("cpu"))
    x = torch.randn(lead + (cfg.d_model,),
                    generator=torch.Generator().manual_seed(3))
    got, aux = M.moe_apply(tree_map(lambda a: a.to(cuda), p), cfg,
                           x.to(cuda))
    want, want_aux = M.moe_apply(p, cfg, x)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)


# -- plan-level fusion: CUDA graph capture and replay -------------------------

def _fusion_case(cuda, query_fn, n=64, v=48, b=1, seed=0):
    """(segment, ext containers on the card) of the one fused segment of
    ``query_fn(array, Ref)`` under the all-dense plan."""
    rng = np.random.default_rng(seed)
    bd = BigDAWG(device=cuda)
    bd.register("H", DenseTensor(torch.from_numpy(
        rng.poisson(2.0, size=(n, v)).astype(np.float32))), "dense_array")
    bd.register("Q", DenseTensor(torch.from_numpy(
        rng.poisson(2.0, size=(b, v)).astype(np.float32))), "dense_array")
    bd.register("X", DenseTensor(torch.from_numpy(
        rng.normal(size=(n, v)).astype(np.float32))), "dense_array")
    q = query_fn(array, Ref)
    plan = Plan(tuple((i, "dense_array") for i in range(len(q.nodes()))))
    (seg,) = fuseplan.fuse_plan(q, plan, bd.catalog).segments
    ext = [bd.catalog[name].obj for kind, name in seg.ext_sources]
    return seg, ext


def _eager(seg, ext, cuda):
    """The lowered function run once eagerly on the card, no graph."""
    fn = fuseplan.compiled_segment(seg)
    fills = tuple(torch.full((), float(o.fill), device=cuda) for o in ext)
    vcs = tuple(torch.full((), o.valid_count, dtype=torch.int64,
                           device=cuda) for o in ext)
    return fn(tuple(o.data for o in ext), fills, vcs)[0]


_KNN_SEGMENT = lambda a, Ref: a.knn(a.tfidf(Ref("H")), Ref("Q"), k=5)


@pytest.mark.parametrize("b", [1, 64])
def test_graph_replay_equals_the_eager_lowered_function(cuda, b):
    """tfidf -> knn, the analytic's segment, at B 1 (gemv) and B 64 (tiled):
    the cold run (warm-up, capture, replay) and warm replays give the eager
    function's indices, and each replay credits one kNN launch."""
    fuseplan.reset_cache()
    seg, ext = _fusion_case(cuda, _KNN_SEGMENT, n=300, v=224, b=b)
    want = _eager(seg, ext, cuda)
    cold_out, cold = fuseplan.run_fused_segment(seg, ext, cuda)
    ops.reset_launches()
    outs = [fuseplan.run_fused_segment(seg, ext, cuda) for _ in range(3)]
    launches = ops.launches()
    assert cold and not any(c for _, c in outs)
    for out in [cold_out] + [o for o, _ in outs]:
        assert torch.equal(out.data, want) and out.data.dtype == torch.int32
    assert launches["knn_scores"] == 3
    assert launches[f"knn_scores_{knn_variant(b)}"] == 3
    assert not fuseplan.broken_keys()


def test_graph_sees_a_changed_fill_and_count_between_replays(cuda):
    fuseplan.reset_cache()
    seg, (x,) = _fusion_case(
        cuda, lambda a, Ref: a.scale(a.select(Ref("X"), lo=0.0), factor=2.0))
    first, _ = fuseplan.run_fused_segment(seg, [x], cuda)
    second, _ = fuseplan.run_fused_segment(
        seg, [DenseTensor(x.data, fill=-7.0)], cuda)
    mask = x.data >= 0.0
    torch.testing.assert_close(first.data, torch.where(mask, x.data, 0.0) * 2)
    torch.testing.assert_close(second.data,
                               torch.where(mask, x.data, -7.0) * 2)
    seg, (x,) = _fusion_case(
        cuda, lambda a, Ref: a.scale(a.count(Ref("X")), factor=0.5))
    a, _ = fuseplan.run_fused_segment(seg, [DenseTensor(x.data, 29)], cuda)
    b, _ = fuseplan.run_fused_segment(seg, [DenseTensor(x.data, 13)], cuda)
    assert (float(a.data), float(b.data)) == (14.5, 6.5)


def test_graph_replay_does_not_overwrite_an_earlier_result(cuda):
    fuseplan.reset_cache()
    seg, (x,) = _fusion_case(
        cuda, lambda a, Ref: a.scale(a.select(Ref("X"), lo=0.0), factor=2.0))
    first, _ = fuseplan.run_fused_segment(seg, [x], cuda)
    keep = first.data.clone()
    fuseplan.run_fused_segment(seg, [DenseTensor(-x.data)], cuda)
    torch.cuda.synchronize(cuda)
    assert torch.equal(first.data, keep)


def test_eight_threads_replaying_one_segment_agree(cuda):
    from concurrent.futures import ThreadPoolExecutor
    fuseplan.reset_cache()
    seg, ext = _fusion_case(cuda, _KNN_SEGMENT, n=300, v=224, b=64)
    want = _eager(seg, ext, cuda)
    # each thread its own test batch, so a replay that read another
    # thread's buffers would give the wrong neighbours
    batches = [DenseTensor(ext[1].data.roll(i, dims=0)) for i in range(8)]
    wants = [_eager(seg, [ext[0], q], cuda) for q in batches]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(
            lambda i: [fuseplan.run_fused_segment(seg, [ext[0], batches[i]],
                                                  cuda)[0].data
                       for _ in range(10)], range(8)))
    torch.cuda.synchronize(cuda)
    for got, w in zip(outs, wants):
        assert all(torch.equal(g, w) for g in got)
    assert torch.equal(wants[0], want)
    assert not fuseplan.broken_keys()


def test_pool_on_the_card_gives_the_in_process_result(cuda):
    """A 2-worker pool with its workers on the card, driven from a freshly
    spawned master as ``chip_smoke.py``'s procpool phase drives it: the
    scattered (2 shards) and unscattered front half of the analytic are
    bitwise equal to the in-process serve, the workers launched the Haar
    kernel, and the master never initialized CUDA (nor loaded JAX)."""
    import multiprocessing
    import _torch_pool
    from repro_torch.core.qlang import bigdawg
    data = _torch_pool.waves(64, 1024)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_torch_pool.master_serves,
                       args=(child, None, data, 4, 16, 2))
    proc.start()
    child.close()
    assert parent.poll(300), "pool master did not answer"
    out = parent.recv()
    proc.join(timeout=60)
    assert proc.exitcode == 0
    assert out["cuda_initialized"] is False and out["jax"] is False
    assert out["leaf_types"] == ["ndarray"]
    assert out["always"][1] == 2 and out["never"][1] == 0
    assert out["launches"]["haar"] > 0
    bd = BigDAWG(train_plans=1, train_repeats=1, device=cuda)
    bd.register("waves", DenseTensor(torch.from_numpy(data)), "dense_array")
    want = bd.execute(bigdawg(_torch_pool.front_half(4, 16)),
                      mode="training").result.data.cpu().numpy()
    np.testing.assert_array_equal(out["always"][0], want)
    np.testing.assert_array_equal(out["never"][0], want)
