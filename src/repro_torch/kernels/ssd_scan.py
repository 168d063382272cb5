"""Mamba2 SSD within one chunk, batched over chunks: the hand-written CUDA
kernels (``csrc/ssd_scan.cu``) and, beside them, their plain PyTorch
version.

``ssd_intra_cuda`` launches one of two kernels on float32 CUDA tensors,
chosen by ``variant`` from the shape alone: the tensor-core kernel
(``wgmma`` in 3xTF32) for chunks of 128 rows with p and n multiples of 8 up
to 64 and 128 (the repo's SSM configs), the CUDA-core kernel for everything
else.  Each has its own launch counter, ``ssd_intra_cuda.launches_tc`` and
``.launches_simt``.  ``ssd_intra_ref`` is the plain version, written to the
reference's oracle (``repro.kernels.ref.ssd_intra_ref``).  All take x (b, Q,
h, p) already multiplied by dt, da (b, Q, h) and B, C (b, Q, g, n), and
return (y (b, Q, h, p), states (b, h, n, p) float32, chunk_decay (b, h)
float32): the chunk's output, its contribution to the state decayed to the
chunk's end, and exp(sum da).  Given float64 inputs, the plain version
computes and returns states and decay in float64, to hold the kernel
against.

``SSDIntra`` is the ``torch.autograd.Function`` of training: its forward is
``ssd_intra_cuda`` (the kernel's outputs, launched once per call and
counted), its backward ``ssd_intra_bwd``, the vector-Jacobian product of
the float32 formula (``ssd_intra_ref``, recomputed from the saved inputs).
The TPU kernel has no backward kernel; neither has the port yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import counters

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
_TILE = 32                   # output rows per tile in the CUDA-core kernel
TC_CHUNK = 128               # the tensor-core kernel's one chunk length
TC_MAX_P, TC_MAX_N = 64, 128


def variant(q: int, p: int, n: int) -> str:
    """Which kernel takes a chunk of q rows, head width p and state width n:
    "tc" (tensor cores, wgmma) or "simt" (CUDA cores)."""
    tc = (q == TC_CHUNK and p % 8 == 0 and 0 < p <= TC_MAX_P
          and n % 8 == 0 and 0 < n <= TC_MAX_N)
    return "tc" if tc else "simt"


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
    """Shared memory one block of the CUDA-core kernel needs
    (``smem_floats`` in ``csrc/ssd_scan.cu``)."""
    n4 = (n + 3) // 4 * 4
    return 4 * (2 * q + q * p + n4 * (q + 1) + n4 * (_TILE + 1)
                + q * (_TILE + 1))


def tc_smem_bytes(n: int) -> int:
    """Shared memory one block of the tensor-core kernel needs at state
    width n (``tc_smem_bytes`` in ``csrc/ssd_scan.cu``): B's hi and lo
    halves in tiles of 32 columns (64 or 128 columns, zero past n), xᵀ's
    hi and lo halves, the staging buffer that TMA fills with the next
    head's x, the cumulative sum and weights, three mbarriers, and 1024
    bytes to align the base."""
    tiles = 2 if n <= 64 else 4          # whole halves of 64 columns
    return (2 * tiles * TC_CHUNK * 128 + 2 * 4 * 64 * 128
            + 2 * TC_CHUNK * 128 + 2 * TC_CHUNK * 4 + 32 + 1024)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("ssd_scan")
    if lib.ssd_intra_launch.argtypes is None:
        lib.ssd_intra_launch.argtypes = ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
        lib.ssd_intra_launch.restype = ctypes.c_int
    return lib


def ssd_intra_cuda(x: torch.Tensor, da: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, kind: str | None = None):
    """Launch a kernel: x (b, Q, h, p), da (b, Q, h), B and C (b, Q, g, n),
    contiguous float32 CUDA tensors on one device, h a multiple of g.
    ``kind`` is the variant; None takes ``variant(Q, p, n)``, and "simt"
    may be asked for at any shape (to compare the two kernels).  The
    tensor-core kernel also needs x, B and C 16-byte aligned.  Returns (y,
    states, chunk_decay) as ``ssd_intra_ref`` does.  Raises on anything
    else (a bfloat16 input included: the model computes this term in
    float32), and if the launch is refused; layout, dtype and shape are
    checked before the device, so a refusal never builds a kernel."""
    for name, t, nd in (("x", x, 4), ("da", da, 3), ("B", B, 4), ("C", C, 4)):
        if t.ndim != nd:
            raise ValueError(f"{name} must be {nd}-d, got {t.ndim}-d")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_cuda takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    if x.numel() > 2**31 - 1:
        raise ValueError(f"too large for the kernels: {tuple(x.shape)}")
    fits = variant(q, p, n)
    kind = fits if kind is None else kind
    if kind not in ("tc", "simt") or (kind == "tc" and fits != "tc"):
        raise ValueError(f"no {kind!r} kernel for q {q}, p {p}, n {n} "
                         f"(variant: {fits!r})")
    for name, t in (("x", x), ("da", da), ("B", B), ("C", C)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_intra_cuda needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if kind == "tc":
        if any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError("the tensor-core kernel needs x, B and C "
                             "16-byte aligned")
    else:
        if b > 65535 or h > 65535:
            raise ValueError(f"too large for the kernel's grid: "
                             f"{tuple(x.shape)}")
        if smem_bytes(q, p, n) > SMEM_LIMIT:
            raise ValueError(f"a chunk of {q} rows (p {p}, n {n}) needs "
                             f"{smem_bytes(q, p, n)} bytes of shared "
                             f"memory, more than {SMEM_LIMIT}")
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
                                  h, p, g, n, int(kind == "tc"), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra {kind} kernel launch failed: "
                           f"code {rc}")
    counters.count(ssd_intra_cuda, f"launches_{kind}")
    return y, states, decay


ssd_intra_cuda.launches_tc = 0
ssd_intra_cuda.launches_simt = 0


def ssd_intra_bwd(x, da, B, C, dy, dstates, ddecay):
    """(dx, dda, dB, dC): the gradient of ``ssd_intra_ref``'s (y, states,
    chunk_decay) at (x, da, B, C) against (dy, dstates, ddecay), by autograd
    through the plain version in float32."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, da, B, C)]
        outs = ssd_intra_ref(*ins)
        return torch.autograd.grad(outs, ins, (dy, dstates, ddecay))


class SSDIntra(torch.autograd.Function):
    """The intra-chunk SSD with a gradient: the kernel forward
    (``ssd_intra_cuda``), the plain backward (``ssd_intra_bwd``).
    ``kernels.ops.ssd_intra`` applies it to every CUDA tensor."""

    @staticmethod
    def forward(ctx, x, da, B, C):
        ctx.save_for_backward(x, da, B, C)
        return ssd_intra_cuda(x, da, B, C)

    @staticmethod
    def backward(ctx, dy, dstates, ddecay):
        return ssd_intra_bwd(*ctx.saved_tensors, dy, dstates, ddecay)
