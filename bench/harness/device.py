"""The device calls the drivers share; off the card they do nothing."""
from __future__ import annotations

import torch


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize(device)


def peak(device):
    """The process's peak of allocated device memory, in bytes."""
    return int(torch.cuda.max_memory_allocated(device)) if _cuda(device) \
        else None


def free(device) -> None:
    if _cuda(device):
        torch.cuda.empty_cache()
