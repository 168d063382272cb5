"""Forward attention: the hand-written CUDA kernels
(``csrc/flash_attention.cu``) and, beside them, their plain PyTorch version.

Two layouts, the same function:

* the Pallas kernel's ``(BH, S, d)``: q, k and v share the fold of batch and
  heads;
* the projections' own ``(B, S, H, d)`` for q and ``(B, S, KV, d)`` for k and
  v, with ``H % KV == 0``: query head h reads KV head ``h // (H // KV)``, as
  ``jnp.repeat`` over heads does in the reference.  The output is
  ``(B, S, H, d)``.

The kernels read either in place through element strides (the 3-D form is
the 4-D one with one head), so a caller folds, expands and copies nothing.

``flash_attention_cuda`` launches one of four kernels on CUDA tensors,
chosen by ``variant`` from the dtype and head width alone: at
``TC_HEAD_DIMS`` the tensor-core kernels, ``wgmma`` in bfloat16 ("tc") and
in 3xTF32 for float32 ("tf32": every operand split into two TF32 halves,
three products each, so the result keeps float32's accuracy); at every
other width that is a multiple of 8 the warp-level tensor-core kernel
("mma": ``mma.sync``, bfloat16 or 3xTF32); and the CUDA-core kernel
("simt") for the widths left.  ``kind=`` forces one (the CUDA-core kernel
takes any shape).  Each has its own launch counter,
``flash_attention_cuda.launches_tc``, ``.launches_tf32``,
``.launches_mma`` and ``.launches_simt``.  ``flash_attention_ref`` is the
plain version, written to the reference's oracle
(``repro.kernels.ref.flash_attention_ref``): float32 softmax over scores
divided by sqrt(d), cast to q's dtype before the product with v.  The
kernels compute the reference's TPU kernel instead (scores multiplied by
1/sqrt(d), online softmax, P rounded to v's dtype); the two agree within
the reference tests' tolerances (float32 1e-4, bfloat16 3e-2).
The causal mask is top-left aligned: query i sees keys 0..i.

``FlashAttention`` is the ``torch.autograd.Function`` of training: its
forward is ``flash_attention_cuda`` (the kernel's output, launched once per
call and counted), its backward ``flash_attention_bwd``, the gradient of
softmax attention written out in plain PyTorch.  The TPU kernel has no
backward kernel (the reference differentiates its jnp attention), so
neither has the port yet.  The backward reads the kernel's O for
D = rowsum(dO·O), recomputes P one block of at most 1024 query rows at a
time (the reference's ``attn_chunk``), and sums dK and dV over each group
of H // KV query heads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import counters

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)
MAX_HEADS = 65535          # B·H: the kernels' grid
SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use
MMA_WIDTH_STEP = 8          # the "mma" kernel takes d in multiples of this
_KIND_CODE = {"simt": 0, "tc": 1, "tf32": 2, "mma": 3}   # the launcher's


def variant(dtype: torch.dtype, d: int) -> str:
    """Which kernel takes (dtype, head width): "tc" (bfloat16 wgmma), "tf32"
    (float32 3xTF32 wgmma), both at ``TC_HEAD_DIMS``; "mma" (warp-level
    tensor cores) at every other multiple of ``MMA_WIDTH_STEP`` up to
    ``MAX_HEAD_DIM``; or "simt" (CUDA cores) for the rest."""
    if d in TC_HEAD_DIMS:
        return "tc" if dtype == torch.bfloat16 else "tf32"
    if d % MMA_WIDTH_STEP == 0 and 0 < d <= MAX_HEAD_DIM:
        return "mma"
    return "simt"


TF32_ROWS, TF32_KEYS = 64, 64   # query rows a block, keys a tile


def tf32_smem_bytes(d: int) -> int:
    """Shared memory one block of the float32 tensor-core kernel takes at
    head width d (``F32Smem`` in ``csrc/flash_attention.cu``): Q's lo (64
    rows), K and Vᵀ of one tile of 64 keys as hi and lo, the next K and V
    as TMA lands them, eight mbarriers, and 1024 bytes to align the base."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"the float32 tensor-core kernel takes d in "
                         f"{TC_HEAD_DIMS}, not {d}")
    return (TF32_ROWS * d * 4 + 6 * TF32_KEYS * d * 4) + 8 * 8 + 1024


def _attend(q, k, v, causal):
    """(BH, Sq, d) x (BH, Sk, d) -> (BH, Sq, d), float32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) / math.sqrt(d)
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, d), k and v: (BH, Sk, d) -> (BH, Sq, d); or q:
    (B, Sq, H, d), k and v: (B, Sk, KV, d) -> (B, Sq, H, d), where the KV
    heads are repeated to the query heads and everything folded to
    (B·H, S, d) first."""
    if q.ndim == 3:
        return _attend(q, k, v, causal)
    B, S, H, d = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} query heads")

    def fold(t):
        t = torch.repeat_interleave(t, H // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

    o = _attend(fold(q), fold(k), fold(v), causal)
    return o.reshape(B, H, S, d).permute(0, 2, 1, 3)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def tc_occupancy(d: int, kind: str = "tc") -> dict:
    """Registers a thread (at launch, before ``setmaxnreg``), shared memory
    a block and blocks per SM of a tensor-core kernel ("tc" or "tf32") at
    head width d on the current CUDA device."""
    import ctypes
    if kind not in ("tc", "tf32"):
        raise ValueError(f"no tensor-core kernel {kind!r}")
    fn = _lib().flash_attention_tc_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(d, int(kind == "tf32"), ctypes.byref(regs), ctypes.byref(smem),
            ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"flash_attention_tc_info failed: code {rc}")
    return {"registers": regs.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}


def _check(q, k, v, kind):
    """Raise on what the kernel does not take, layout first, then dtype and
    the kernel (``kind``, None for ``variant``), then device; returns the
    4-D views, (B, Sq, Sk, H, KV, d) and the kernel's kind."""
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError(f"q, k and v must all be (BH, S, d) or "
                         f"(B, S, heads, d), got {q.ndim}-, {k.ndim}- and "
                         f"{v.ndim}-d")
    q4, k4, v4 = (t.unsqueeze(2) if t.ndim == 3 else t for t in (q, k, v))
    B, sq, H, d = q4.shape
    sk, KV = k4.shape[1], k4.shape[2]
    if k4.shape != v4.shape or k4.shape[0] != B or k4.shape[3] != d:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} query heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head width {d} outside 1..{MAX_HEAD_DIM}")
    if sk < 1:
        raise ValueError("no keys: k and v have length 0")
    if B * H > MAX_HEADS or max(sq, sk) >= 2**31:
        raise ValueError(f"too large for the kernel's grid: {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 and d > 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16,"
                            f" {name} is {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    fits = variant(q.dtype, d)
    kind = fits if kind is None else kind
    if kind not in ("simt", fits):
        raise ValueError(f"no {kind!r} kernel for {q.dtype} at head width "
                         f"{d} (variant: {fits!r})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, {name}"
                             f" is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return (q4, k4, v4), (B, sq, sk, H, KV, d), kind


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kind: str | None = None) -> torch.Tensor:
    """Launch a kernel on q, k, v of one dtype (float32 or bfloat16) on one
    CUDA device, in either layout of the module docstring, with the last
    dimension contiguous, 1 <= d <= 256.  ``kind`` is the kernel: None takes
    ``variant(dtype, d)``; "simt" may be asked for at any shape (to compare
    the kernels), "tc", "tf32" and "mma" only where ``variant`` names them.
    The tensor-core kernels also need strides that are multiples of 8
    elements and 16-byte aligned data.  Returns a new contiguous tensor in
    q's layout and dtype.  Raises on anything else, and if the launch is
    refused; layout, dtype and kernel are checked before the device, so a
    refusal never builds a kernel."""
    (q4, k4, v4), (B, sq, sk, H, KV, d), kind = _check(q, k, v, kind)
    if kind != "simt":
        for name, t in (("q", q4), ("k", k4), ("v", v4)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"the tensor-core kernels need {name} "
                                 f"16-byte aligned with strides in multiples"
                                 f" of 8 elements, got {t.stride()}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * H == 0 or sq == 0:
        return out
    o4 = out.unsqueeze(2) if out.ndim == 3 else out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            B, sq, sk, H, KV, d,
            *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
            *o4.stride()[:3], 1.0 / math.sqrt(d), int(causal),
            int(q.dtype == torch.bfloat16), _KIND_CODE[kind], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: "
                           f"code {rc}")
    counters.count(flash_attention_cuda, f"launches_{kind}")
    return out


flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_tf32 = 0
flash_attention_cuda.launches_mma = 0
flash_attention_cuda.launches_simt = 0


BWD_BLOCK = 1024           # query rows whose P the backward holds at once


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        block: int = BWD_BLOCK):
    """(dq, dk, dv) of softmax attention at q, k, v, in either layout of
    the module docstring, given its output ``o`` and the output's gradient
    ``do``.  Per block of ``block`` query rows: S = q·kᵀ (in the inputs'
    dtype, as the forward's plain version takes it), P = softmax(S/sqrt(d))
    in float32, dV += Pᵀ·dO, dS = P∘(dO·Vᵀ − D) with D = rowsum(dO∘O),
    dQ = dS·K/sqrt(d), dK += dSᵀ·Q/sqrt(d); P and dS enter the products in
    the inputs' dtype, dK and dV are summed in float32.  Under a causal mask
    a block reads only the keys its last row sees."""
    q4, k4, v4, o4, do4 = (t.unsqueeze(2) if t.ndim == 3 else t
                           for t in (q, k, v, o, do))
    B, sq, H, d = q4.shape
    sk, KV = k4.shape[1], k4.shape[2]
    G = H // KV
    dt, f32 = q.dtype, torch.float32
    scale = 1.0 / math.sqrt(d)
    qg = q4.reshape(B, sq, KV, G, d)            # head h = kv·G + g
    dog = do4.reshape(B, sq, KV, G, d)
    D = (dog.to(f32) * o4.reshape(B, sq, KV, G, d).to(f32)).sum(-1)
    D = D.permute(0, 2, 3, 1)                   # (B, KV, G, sq)
    dq = torch.empty_like(qg)
    dk = torch.zeros((B, sk, KV, d), dtype=f32, device=q.device)
    dv = torch.zeros((B, sk, KV, d), dtype=f32, device=q.device)
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        kend = min(q1, sk) if causal else sk
        qb, dob = qg[:, q0:q1], dog[:, q0:q1]
        kb, vb = k4[:, :kend], v4[:, :kend]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).to(f32)
        s.mul_(scale)
        if causal:
            rows = torch.arange(q0, q1, device=q.device)
            keys = torch.arange(kend, device=q.device)
            s.masked_fill_(rows[:, None] < keys[None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :kend] += torch.einsum("bkgqs,bqkgd->bskd", p.to(dt), dob)
        ds = torch.einsum("bqkgd,bskd->bkgqs", dob, vb).to(f32)
        ds.sub_(D[..., q0:q1, None]).mul_(p).mul_(scale)
        del p
        ds = ds.to(dt)
        dq[:, q0:q1] = torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
        dk[:, :kend] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
    dq = dq.reshape(q4.shape)
    if q.ndim == 3:
        return dq[:, :, 0], dk[:, :, 0].to(dt), dv[:, :, 0].to(dt)
    return dq, dk.to(dt), dv.to(dt)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the kernel forward
    (``flash_attention_cuda``), the plain backward (``flash_attention_bwd``).
    ``kernels.ops.flash_attention`` applies it to every CUDA tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o = flash_attention_cuda(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None
