"""Dispatch to the hand-written kernels by the tensor's device alone.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, which raises on what it does not accept.  There is no override and
no fallback: a CUDA tensor never reaches a plain version.  Each kernel's
wrapper counts its launches (``haar_cuda.launches``,
``knn_scores_cuda.launches``), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.haar import haar_cuda, haar_ref
from repro_torch.kernels.knn import (knn_scores_cuda, knn_scores_ref, top_k)

KERNELS = {"haar": haar_cuda, "knn_scores": knn_scores_cuda}


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


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
