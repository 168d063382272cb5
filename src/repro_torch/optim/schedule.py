"""Learning-rate schedules (pure functions of the step count).

The port of ``repro.optim.schedule``: each schedule maps a 0-d int32 count
tensor to a 0-d float32 learning rate on the count's device."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=count.device)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def f(count):
        c = count.to(torch.float32)
        warm = peak_lr * c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup_steps, warm, cos)
    return f
