"""Multi-level Haar DWT over rows of an (N, T) tensor: the hand-written CUDA
kernel (``csrc/haar.cu``) and, beside it, its plain PyTorch version.

``haar_cuda`` launches the kernel on a CUDA tensor; ``haar_ref`` is the plain
version, which the CPU path runs and which ``chip_smoke.py`` holds the
kernel against on the card.  ``kernels.ops.haar`` picks between them by the
tensor's device alone.
"""
from __future__ import annotations

import math

import torch

INV_SQRT2 = 1.0 / math.sqrt(2.0)
_DTYPES = (torch.float32, torch.bfloat16)


def haar_ref(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Multi-level Haar DWT over the last axis: [a_L, d_L, ..., d_1].

    Arithmetic runs in the input dtype, 1/sqrt(2) included, so a bfloat16
    input rounds after every add/sub and every multiply."""
    inv = torch.tensor(INV_SQRT2, dtype=x.dtype, device=x.device)
    details = []
    a = x
    for _ in range(levels):
        e, o = a[..., 0::2], a[..., 1::2]
        details.append((e - o) * inv)
        a = (e + o) * inv
    return torch.cat([a] + details[::-1], dim=-1)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("haar")
    if lib.haar_launch.argtypes is None:
        lib.haar_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.haar_launch.restype = ctypes.c_int
    return lib


def haar_cuda(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Launch the Haar kernel on CUDA tensor ``x`` (N, T), float32 or
    bfloat16, contiguous, T divisible by 2**levels.  Raises on anything
    else, and if the launch is refused."""
    if x.device.type != "cuda":
        raise ValueError(f"haar_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"haar_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"haar_cuda takes an (N, T) tensor, got {x.ndim}-d")
    if not x.is_contiguous():
        raise ValueError("haar_cuda needs a contiguous tensor")
    n, t = x.shape
    if levels < 0 or t % (1 << levels):
        raise ValueError(f"T={t} must be divisible by 2^levels={1 << levels}")
    out = torch.empty_like(x)
    if n == 0 or t == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.haar_launch(x.data_ptr(), out.data_ptr(), n, t, levels,
                             int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"haar kernel launch failed: cudaError {rc}")
    haar_cuda.launches += 1
    return out


haar_cuda.launches = 0
