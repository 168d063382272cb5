"""Dispatch to the hand-written kernels by the tensor's device alone.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, which raises on what it does not accept.  There is no override and
no fallback: a CUDA tensor never reaches a plain version.  Each kernel's
wrapper counts its launches (``haar_cuda.launches``;
``knn_scores_cuda.launches`` in all and ``.launches_gemv`` and
``.launches_tiled`` per kernel; flash attention and SSD one count per
variant, ``flash_attention_cuda.launches_tc``, ``.launches_tf32``,
``.launches_mma`` and ``.launches_simt``,
``ssd_intra_cuda.launches_tc`` and ``.launches_simt``;
``decode_attention_cuda.launches``; ``LAUNCHES``), so
a run can show that its main path went through the kernels.  ``COUNTERS``
holds the program's work counts next to the launch counts
(``counters.LM_WORK``: ``expand_kv_bytes``, ``moe_rows_computed``,
``moe_rows_routed``), so ``launches()`` reads and ``reset_launches()``
zeroes both.  The counts are thread-safe, and a CUDA graph replay of
captured launches credits them again (``kernels.counters``).
``flash_attention`` and ``ssd_intra`` carry the LM prefill and training
paths (``models.layers.attention_apply``, ``models.ssm.ssd_chunked``),
``decode_attention`` the decode step's attention over a GQA cache
(``models.layers.attention_decode``; no gradient).  A
CUDA tensor goes through the kernel's ``torch.autograd.Function``
(``FlashAttention``, ``SSDIntra``: the kernel forward, a plain PyTorch
backward), which records a backward node only when an input requires a
gradient, and launches the kernel once either way; a CPU tensor goes
through the plain version, which autograd differentiates, but inside
``work.count()``, where it goes through the same Function with the plain
forward, so that the count credits each call's work from its shapes, with
the same backward, on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import counters, work
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.haar import haar_cuda, haar_ref
from repro_torch.kernels.knn import (knn_scores_cuda, knn_scores_ref, top_k)
from repro_torch.kernels.ssd_scan import (SSDIntra, ssd_intra_cuda,
                                          ssd_intra_ref)

# launch counters: name -> (wrapper, attribute)
LAUNCHES = {"haar": (haar_cuda, "launches"),
            "knn_scores": (knn_scores_cuda, "launches"),
            "knn_scores_gemv": (knn_scores_cuda, "launches_gemv"),
            "knn_scores_tiled": (knn_scores_cuda, "launches_tiled"),
            "flash_attention_tc": (flash_attention_cuda, "launches_tc"),
            "flash_attention_tf32": (flash_attention_cuda, "launches_tf32"),
            "flash_attention_mma": (flash_attention_cuda, "launches_mma"),
            "flash_attention_simt": (flash_attention_cuda, "launches_simt"),
            "ssd_intra_tc": (ssd_intra_cuda, "launches_tc"),
            "ssd_intra_simt": (ssd_intra_cuda, "launches_simt"),
            "decode_attention": (decode_attention_cuda, "launches")}
# and the program's work counters beside them
COUNTERS = {**LAUNCHES, **{name: (counters.LM_WORK, name)
                           for name in vars(counters.LM_WORK)}}


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


def haar(x: torch.Tensor, levels: int) -> torch.Tensor:
    if _route(x, "haar"):
        return haar_cuda(x.contiguous(), levels)
    return haar_ref(x, levels)


def knn_scores(train: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    if _route(train, "knn_scores"):
        return knn_scores_cuda(train.contiguous(), test.contiguous())
    return knn_scores_ref(train, test)


def knn(train: torch.Tensor, test: torch.Tensor, k: int):
    """(int32 indices, float32 scores) of the k best train rows per test
    row; top-k runs outside the kernel."""
    return top_k(knn_scores(train, test), k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, d); or q (B, S, H, d) with k, v (B, S, KV, d), the
    KV heads read in place by groups of H // KV query heads.  v may be
    narrower than q and k (MLA), and the output then has v's width; a
    kernel that takes one width gets v zero-padded and its output sliced
    (``flash_attention_cuda``).  The kernel reads any strides; only a last
    dimension that is not contiguous is copied."""
    cuda = _route(q, "flash_attention")
    if cuda:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    if cuda or work.counting():
        return FlashAttention.apply(q, k, v, causal, not cuda)
    return flash_attention_ref(q, k, v, causal=causal)


def ssd_intra(x: torch.Tensor, da: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor):
    """Intra-chunk SSD over (b, Q, ...) chunks: (y, states, chunk_decay);
    on the card the kernel that ``ssd_scan.variant`` names for the shape."""
    cuda = _route(x, "ssd_intra")
    if cuda or work.counting():
        return SSDIntra.apply(x.contiguous(), da.contiguous(),
                              B.contiguous(), C.contiguous(), not cuda)
    return ssd_intra_ref(x, da, B, C)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One query row a slot, q (B, H, hd), against the rows ``<= pos`` of
    the GQA cache k, v (B, S, KV, hd), read in place: (B, H, hd)."""
    if _route(q, "decode_attention"):
        return decode_attention_cuda(q, k, v, pos)
    return decode_attention_ref(q, k, v, pos)


def reset_launches() -> None:
    counters.reset(COUNTERS.values())


def launches() -> dict:
    return counters.read(COUNTERS)
