"""Int8 error-feedback gradient compression.

The port of ``repro.optim.compression``.  The reference applies it at the
microbatch-accumulation boundary, where a hand-rolled collective would
compress before its reduce-scatter; the port keeps the same arithmetic
on one device or on a mesh: each gradient leaf is quantized to int8 with
one scale, the quantization error is carried in the train state and added
back the next step.  On ``DTensor`` leaves the max behind the scale comes
back as a partial max and is reduced: one scale for the whole leaf, not
one a shard.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 codes equal the reference's."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map, tree_unzip


def int8_ef_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quant(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(torch.float32) * scale


def int8_ef_compress(grads, ef_state):
    """Quantize grads to int8 with error feedback.

    Returns (dequantized grads as would arrive post-reduce, new ef_state)."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = _quant(g)
        dq = _dequant(q, s)
        return dq, g - dq

    return tree_unzip(tree_map(one, grads, ef_state), 2)
