"""AdamW with decoupled weight decay, global-norm clipping, and configurable
moment dtype (bf16 moments for memory-bound giants like grok-1).

The port of ``repro.optim.adamw``, over the port's parameter trees (nested
dicts of tensors).  The state tree is the reference's, ``{"m", "v",
"count"}``, so a checkpoint carries across packages.  ``update`` returns
new tensors and changes none of its arguments.  It runs on ``DTensor``
trees as it is (a state placed on a mesh by ``models.api.distribute``):
``global_norm``'s sums come back as partial sums and are reduced, so the
clip is that of the whole gradient."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unzip


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params):
        mdt = getattr(torch, self.moment_dtype)
        zeros = lambda p: torch.zeros_like(p, dtype=mdt)
        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    def update(self, grads, state, params):
        """Returns (new_params, new_state, stats). grads/params: f32 trees."""
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0) \
            if self.clip_norm else 1.0
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        lr = self._lr(count)
        mdt = getattr(torch, self.moment_dtype)
        f32 = torch.float32

        def upd(p, g, m, v):
            g = g.to(f32) * scale
            m32 = b1 * m.to(f32) + (1 - b1) * g
            v32 = b2 * v.to(f32) + (1 - b2) * g * g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            p2 = p.to(f32) - lr * (step + self.weight_decay * p.to(f32))
            return p2.to(p.dtype), m32.to(mdt), v32.to(mdt)

        new, m, v = tree_unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new, {"m": m, "v": v, "count": count}, \
            {"grad_norm": gnorm, "lr": lr}
