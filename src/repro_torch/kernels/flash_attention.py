"""Forward attention over (BH, S, d): the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and, beside it, its plain PyTorch version.

``flash_attention_cuda`` launches the kernel on CUDA tensors;
``flash_attention_ref`` is the plain version, written to the reference's
oracle (``repro.kernels.ref.flash_attention_ref``): float32 softmax over
scores divided by sqrt(d), cast to q's dtype before the product with v.
The kernel computes the reference's TPU kernel instead (scores multiplied
by 1/sqrt(d), online softmax, P rounded to v's dtype); the two agree within
the reference tests' tolerances (float32 1e-4, bfloat16 3e-2).  The causal
mask is top-left aligned: query i sees keys 0..i.
"""
from __future__ import annotations

import math

import torch

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, d); k, v: (BH, Sk, d) -> (BH, Sq, d), float32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) / math.sqrt(d)
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel: q (BH, Sq, d), k and v (BH, Sk, d), contiguous
    CUDA tensors of one dtype (float32 or bfloat16) on one device,
    1 <= d <= 256.  Returns (BH, Sq, d) in q's dtype.  Raises on anything
    else, and if the launch is refused."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, {name}"
                             f" is on {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16,"
                            f" {name} is {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (BH, S, d), got {t.ndim}-d")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    sk = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head width {d} outside 1..{MAX_HEAD_DIM}")
    if bh > 65535 or max(sq, sk) * d > 2**31 - 1:
        raise ValueError(f"too large for the kernel's grid: {tuple(q.shape)}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, 1.0 / math.sqrt(d), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
