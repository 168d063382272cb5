"""kNN dot-product scores test @ trainᵀ: the hand-written CUDA kernel
(``csrc/knn.cu``) and, beside it, its plain PyTorch version, plus top-k.

``knn_scores_cuda`` launches one of two kernels on CUDA tensors, chosen by
``variant`` from the number of test rows B alone: "gemv", a matrix-vector
kernel bound by the latency of its loads, for B <= ``GEMV_MAX_B`` (the
analytic's B = 1), and "tiled", a tensor-core product that reads train
once, for larger B.  Each has its own launch counter
(``knn_scores_cuda.launches_gemv``, ``.launches_tiled``) beside the total
``.launches``.  ``knn_scores_ref`` is the plain version.  Top-k runs
outside the kernel (``torch.topk``) and its indices are returned as int32,
the reference's index dtype.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import counters

_DTYPES = (torch.float32, torch.bfloat16)
GEMV_MAX_B = 8
_KIND_CODE = {"gemv": 0, "tiled": 1}     # knn_scores_launch's


def variant(b: int) -> str:
    """Which kernel takes B test rows: "gemv" up to ``GEMV_MAX_B``, else
    "tiled"."""
    return "gemv" if b <= GEMV_MAX_B else "tiled"


def knn_scores_ref(train: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Dot-product scores.  train: (N, V); test: (B, V) -> (B, N) float32."""
    return torch.einsum("bv,nv->bn", test.to(torch.float32),
                        train.to(torch.float32))


def top_k(scores: torch.Tensor, k: int):
    """(int32 indices, scores) of the k largest scores per row."""
    s, idx = torch.topk(scores, k, dim=-1)
    return idx.to(torch.int32), s


def knn_ref(train, test, k):
    return top_k(knn_scores_ref(train, test), k)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("knn")
    if lib.knn_scores_launch.argtypes is None:
        lib.knn_scores_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.knn_scores_launch.restype = ctypes.c_int
    return lib


def knn_scores_cuda(train: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Launch the scores kernel that ``variant(B)`` names: train (N, V),
    test (B, V), both contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device.  Returns (B, N) float32.  Raises on anything
    else, and if the launch is refused."""
    for name, t in (("train", train), ("test", test)):
        if t.device.type != "cuda":
            raise ValueError(f"knn_scores_cuda needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"knn_scores_cuda takes float32 or bfloat16, "
                            f"{name} is {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-d, got {t.ndim}-d")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if train.device != test.device:
        raise ValueError(f"train on {train.device}, test on {test.device}")
    if train.dtype != test.dtype:
        raise TypeError(f"train is {train.dtype}, test is {test.dtype}")
    n, v = train.shape
    b, vt = test.shape
    if v != vt:
        raise ValueError(f"feature widths differ: train {v}, test {vt}")
    if max(n, b, v) > 2**31 - 1:
        raise ValueError("dimensions must fit in int32")
    out = torch.empty((b, n), dtype=torch.float32, device=train.device)
    if n == 0 or b == 0:
        return out
    kind = variant(b)
    lib = _lib()
    with torch.cuda.device(train.device):
        stream = torch.cuda.current_stream(train.device).cuda_stream
        rc = lib.knn_scores_launch(train.data_ptr(), test.data_ptr(),
                                   out.data_ptr(), n, b, v,
                                   int(train.dtype == torch.bfloat16),
                                   _KIND_CODE[kind], stream)
    if rc != 0:
        raise RuntimeError(f"knn_scores {kind} kernel launch failed: "
                           f"cudaError {rc}")
    counters.count(knn_scores_cuda, "launches", f"launches_{kind}")
    return out


knn_scores_cuda.launches = 0
knn_scores_cuda.launches_gemv = 0
knn_scores_cuda.launches_tiled = 0
