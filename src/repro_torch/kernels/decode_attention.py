"""Decode attention over a grouped-query cache: the hand-written CUDA
kernel (``csrc/decode_attention.cu``) and, beside it, its plain PyTorch
version.

One new query row a slot, q (B, H, hd), against the cache rows up to the
slot's position, k and v (B, Smax, KV, hd) with ``H % KV == 0``: query head
h reads KV head ``h // (H // KV)``.  Row s of slot b takes part where
``s <= pos[b]``.  The output is (B, H, hd) in q's dtype.

``decode_attention_cuda`` reads the cache in place through its strides (a
rank's narrowed view of the KV heads too), each row once for the G = H //
KV query heads that read it, and only the rows up to each position: one
block per (slot, KV head, chunk of 256 rows), then a kernel that merges
the chunks.  Each call counts one launch
(``decode_attention_cuda.launches``), its two device kernels together.
``decode_attention_ref`` is the plain version: float32 scores over
sqrt(hd), the rows past the position masked, softmax, the weights cast to
q's dtype before the product with v, as the reference decodes; it takes
each of a group's query heads against the group's KV head, so it repeats
no head.  The kernel keeps its weights and sums in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import counters

_DTYPES = (torch.float32, torch.bfloat16)
_POS_DTYPES = (torch.int32, torch.int64)
MAX_HEAD_DIM = 128
MAX_GROUP = 16             # H // KV
HEAD_DIM_STEP = 8


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), k and v (B, S, KV, hd), pos (B,) -> (B, H, hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.stack([torch.einsum("bhk,bshk->bhs", qg[:, :, j], k)
                     for j in range(H // KV)], 2)
    s = s.to(torch.float32) / math.sqrt(hd)
    mask = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.stack([torch.einsum("bhs,bshk->bhk", w[:, :, j], v)
                     for j in range(H // KV)], 2)
    return o.reshape(B, H, hd)


def _lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention_workspace.argtypes = [i, i, i, i]
        lib.decode_attention_workspace.restype = ll
        lib.decode_attention_launch.argtypes = [p] * 6 + [i] * 5 + [ll] * 6 \
            + [i, i, p]
        lib.decode_attention_launch.restype = i
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Launch the decode kernel: q (B, H, hd) contiguous, k and v (B, S,
    KV, hd) of q's dtype (float32 or bfloat16) with a contiguous last
    dimension and 16-byte aligned rows, pos (B,) int32 or int64, all CUDA
    tensors on one device; hd a multiple of 8 up to 128 and H // KV up to
    16.  Returns (B, H, hd) in q's dtype.  Raises on anything else, and if
    the launch is refused."""
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention_cuda takes float32 or bfloat16, "
                        f"q is {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q is {q.dtype}, k {k.dtype}, v {v.dtype}")
    if pos.dtype not in _POS_DTYPES:
        raise TypeError(f"pos must be int32 or int64, got {pos.dtype}")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, H, hd), k and v (B, S, KV, hd): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or pos.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and pos "
                         f"{tuple(pos.shape)} disagree")
    if hd % HEAD_DIM_STEP or hd > MAX_HEAD_DIM:
        raise ValueError(f"head width {hd}: the kernel takes multiples of "
                         f"{HEAD_DIM_STEP} up to {MAX_HEAD_DIM}")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{H} query heads over {KV} KV heads: the kernel "
                         f"takes groups H // KV of at most {MAX_GROUP}")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous last dimension and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")
    q = q.contiguous()
    pos = pos.contiguous()
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    lib = _lib()
    ws = torch.empty((lib.decode_attention_workspace(B, S, H, hd),),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, S, H, KV, hd, *k.stride()[:3],
            *v.stride()[:3], int(q.dtype == torch.bfloat16),
            int(pos.dtype == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    counters.count(decode_attention_cuda, "launches")
    return out


decode_attention_cuda.launches = 0
