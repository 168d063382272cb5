"""Mamba2 SSD within one chunk, batched over chunks: the hand-written CUDA
kernel (``csrc/ssd_scan.cu``) and, beside it, its plain PyTorch version.

``ssd_intra_cuda`` launches the kernel on float32 CUDA tensors;
``ssd_intra_ref`` is the plain version, written to the reference's oracle
(``repro.kernels.ref.ssd_intra_ref``).  Both take x (b, Q, h, p) already
multiplied by dt, da (b, Q, h) and B, C (b, Q, g, n), and return
(y (b, Q, h, p), states (b, h, n, p) float32, chunk_decay (b, h) float32):
the chunk's output, its contribution to the state decayed to the chunk's
end, and exp(sum da).  Given float64 inputs, the plain version computes and
returns states and decay in float64, to hold the kernel against.
"""
from __future__ import annotations

import torch

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
_TILE = 32                   # output rows per tile in the kernel


def ssd_intra_ref(x, da, B, C):
    """In float32, or in float64 when x is float64 (a reference for the
    kernel's float32 sums)."""
    b, Q, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    ct = torch.promote_types(x.dtype, torch.float32)
    daT = da.permute(0, 2, 1).to(ct)                           # (b, h, Q)
    cs = torch.cumsum(daT, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(diff.masked_fill(~mask, float("-inf")))    # (b, h, Q, Q)
    Bf = B.to(ct)
    Cf = C.to(ct)
    xf = x.to(ct).reshape(b, Q, g, hg, p)
    G = torch.einsum("bqgn,bkgn->bgqk", Cf, Bf)
    M = G.reshape(b, g, 1, Q, Q) * Lm.reshape(b, g, hg, Q, Q)
    y = torch.einsum("bghqk,bkghp->bqghp", M, xf).reshape(b, Q, h, p)
    decay_states = torch.exp(cs[..., -1:] - cs)                # (b, h, Q)
    dsg = decay_states.reshape(b, g, hg, Q)
    states = torch.einsum("bkgn,bghk,bkghp->bghnp", Bf, dsg, xf)
    states = states.reshape(b, h, n, p)
    chunk_decay = torch.exp(cs[..., -1])                       # (b, h)
    return y.to(x.dtype), states, chunk_decay


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory one block of the kernel needs (``smem_floats`` in
    ``csrc/ssd_scan.cu``)."""
    n4 = (n + 3) // 4 * 4
    return 4 * (2 * q + q * p + n4 * (q + 1) + n4 * (_TILE + 1)
                + q * (_TILE + 1))


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan")
    if lib.ssd_intra_launch.argtypes is None:
        lib.ssd_intra_launch.argtypes = ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
        lib.ssd_intra_launch.restype = ctypes.c_int
    return lib


def ssd_intra_cuda(x: torch.Tensor, da: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor):
    """Launch the kernel: x (b, Q, h, p), da (b, Q, h), B and C (b, Q, g, n),
    contiguous float32 CUDA tensors on one device, h a multiple of g.
    Returns (y, states, chunk_decay) as ``ssd_intra_ref`` does.  Raises on
    anything else (a bfloat16 input included: the model computes this term
    in float32), and if the launch is refused."""
    for name, t, nd in (("x", x, 4), ("da", da, 3), ("B", B, 4), ("C", C, 4)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_intra_cuda needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_cuda takes float32, {name} is "
                            f"{t.dtype}")
        if t.ndim != nd:
            raise ValueError(f"{name} must be {nd}-d, got {t.ndim}-d")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    b, q, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(da.shape) != (b, q, h) or tuple(C.shape) != tuple(B.shape) \
            or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"shapes differ: x {tuple(x.shape)}, da "
                         f"{tuple(da.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if min(q, h, p, g, n) < 1 or h % g:
        raise ValueError(f"need q, h, p, g, n >= 1 and h % g == 0: "
                         f"q {q}, h {h}, p {p}, g {g}, n {n}")
    if b > 65535 or h > 65535 or x.numel() > 2**31 - 1:
        raise ValueError(f"too large for the kernel's grid: {tuple(x.shape)}")
    if smem_bytes(q, p, n) > SMEM_LIMIT:
        raise ValueError(f"a chunk of {q} rows (p {p}, n {n}) needs "
                         f"{smem_bytes(q, p, n)} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    y = torch.empty_like(x)
    states = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    decay = torch.empty((b, h), dtype=torch.float32, device=x.device)
    if b == 0:
        return y, states, decay
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_intra_launch(x.data_ptr(), da.data_ptr(), B.data_ptr(),
                                  C.data_ptr(), y.data_ptr(),
                                  states.data_ptr(), decay.data_ptr(), b, q,
                                  h, p, g, n, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra kernel launch failed: cudaError {rc}")
    ssd_intra_cuda.launches += 1
    return y, states, decay


ssd_intra_cuda.launches = 0
