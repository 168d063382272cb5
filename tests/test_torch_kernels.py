"""The port's plain kernel versions against the reference's oracles and its
Pallas kernels (interpret mode), plus the port's device dispatch.

Inputs are drawn with numpy from a seed and fed to both packages.  The
tolerances are the reference's own (``tests/test_kernels.py``): 1e-5 in
float32 for Haar, 2e-2 in bfloat16 (torch and XLA round bfloat16
intermediates at different places, one bfloat16 ulp apart); knn scores
1e-4/1e-3 in float32 and 2e-2/0.3 in bfloat16.  Top-k indices are compared
in float32 only, as the reference does (bfloat16 ties reorder them)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.haar import haar_pallas
from repro.kernels.knn import knn_pallas, knn_scores_pallas
from repro_torch.kernels import haar as thaar
from repro_torch.kernels import knn as tknn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import bf16_pair


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" \
        else dict(rtol=1e-5, atol=1e-5)


def _pair(x: np.ndarray, dtype: str):
    if dtype == "bf16":
        return bf16_pair(x)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("n,t,levels", [(4, 16, 2), (8, 64, 3), (130, 256, 4),
                                        (3, 32, 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_haar_plain_matches_reference(n, t, levels, dtype):
    x = np.random.default_rng(n * t).normal(size=(n, t)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = tref.haar_ref(xt, levels)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_f32(got), _f32(jref.haar_ref(xj, levels)),
                               **_tol(dtype))
    np.testing.assert_allclose(
        _f32(got), _f32(haar_pallas(xj, levels, block_rows=8,
                                    interpret=True)), **_tol(dtype))


def test_haar_plain_bitwise_in_f32():
    """Same operation order as the reference, so float32 agrees bit for
    bit (the CUDA kernel keeps that order too)."""
    x = np.random.default_rng(7).normal(size=(64, 1024)).astype(np.float32)
    got = tref.haar_ref(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.haar_ref(
        jnp.asarray(x), 6)))


def test_haar_energy_preserved():
    x = np.random.default_rng(3).normal(size=(16, 128)).astype(np.float32)
    y = tref.haar_ref(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                               np.linalg.norm(x, axis=1), rtol=1e-5)


@pytest.mark.parametrize("n,v,b", [(64, 128, 4), (256, 512, 8), (100, 48, 3)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_knn_scores_plain_matches_reference(n, v, b, dtype):
    rng = np.random.default_rng(n + v + b)
    train = rng.normal(size=(n, v)).astype(np.float32)
    test = rng.normal(size=(b, v)).astype(np.float32)
    (trj, trt), (tej, tet) = _pair(train, dtype), _pair(test, dtype)
    got = tref.knn_scores_ref(trt, tet)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    tol = dict(rtol=2e-2 if dtype == "bf16" else 1e-4,
               atol=0.3 if dtype == "bf16" else 1e-3)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.knn_scores_ref(trj, tej)),
                               **tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(knn_scores_pallas(trj, tej, interpret=True)),
        **tol)


@pytest.mark.parametrize("n,v,b,k", [(128, 64, 2, 5), (100, 48, 3, 7),
                                     (300, 199, 1, 11)])
def test_knn_topk_indices_match_reference(n, v, b, k):
    rng = np.random.default_rng(v)
    train = rng.normal(size=(n, v)).astype(np.float32)
    test = rng.normal(size=(b, v)).astype(np.float32)
    idx, score = tref.knn_ref(torch.from_numpy(train), torch.from_numpy(test),
                              k)
    assert idx.dtype == torch.int32 and idx.shape == (b, k)
    for want_idx, want_score in (
            jref.knn_ref(jnp.asarray(train), jnp.asarray(test), k),
            knn_pallas(jnp.asarray(train), jnp.asarray(test), k,
                       interpret=True)):
        assert np.asarray(want_idx).dtype == np.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                                   rtol=1e-4, atol=1e-3)


def test_ops_take_the_plain_version_for_cpu_tensors(monkeypatch):
    """A CPU tensor never reaches a kernel launcher, and so never moves a
    launch counter."""
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launcher")
    monkeypatch.setattr(tops, "haar_cuda", boom)
    monkeypatch.setattr(tops, "knn_scores_cuda", boom)
    tops.reset_launches()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 32)).astype(np.float32))
    torch.testing.assert_close(tops.haar(x, 3), tref.haar_ref(x, 3),
                               rtol=0, atol=0)
    idx, _ = tops.knn(x, x[:2], 2)
    assert idx.dtype == torch.int32
    assert tops.launches() == {"haar": 0, "knn_scores": 0}


def test_ops_refuse_other_devices():
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.haar(x, 2)
    with pytest.raises(ValueError, match="no kernel"):
        tops.knn_scores(x, x)


def test_cuda_launchers_refuse_cpu_tensors():
    """The launchers check the device before touching nvcc or ctypes."""
    x = torch.zeros((4, 32))
    before = tops.launches()
    with pytest.raises(ValueError, match="CUDA"):
        thaar.haar_cuda(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_scores_cuda(x, x)
    assert tops.launches() == before


def test_connect_without_a_card_raises(monkeypatch):
    from repro_torch.core import connect
    from repro_torch.data import patients_table
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        connect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        patients_table(4)
    assert connect(device="cpu").bigdawg.device == torch.device("cpu")
