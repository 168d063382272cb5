"""Model API of the port: the serving part of ``repro.models.api``.

  init_params(cfg, gen, plan, device)   -> parameter dict
  cast_params(params, dtype)            -> same dict, float leaves cast
  make_prefill(cfg, shape, plan)        -> f(params, batch) -> (logits, cache, pos)
  make_decode_step(cfg, shape, plan)    -> f(params, cache, tokens, pos) -> (tok, cache)
  count_params(cfg)                     -> parameter count (shapes only)

Families ``dense`` and ``ssm`` are ported; ``moe``, ``vlm``, ``hybrid`` and
``encdec`` raise ``NotImplementedError`` naming their ROADMAP item.  The
train step and partition specs are not ported yet (ROADMAP.md queue 1, LM
side).  Prefill and decode run under ``torch.inference_mode()``; decode
updates the cache in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeConfig
from repro_torch.core.tables import resolve_device
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as T
from repro_torch.models.layers import not_ported
from repro_torch.models.util import tree_leaves

F32_SENSITIVE = {"router", "A_log", "dt_bias", "Dskip"}
PORTED_FAMILIES = ("dense", "ssm")


def _family(cfg: ArchConfig) -> str:
    if cfg.family not in PORTED_FAMILIES:
        if cfg.family not in ("moe", "vlm", "hybrid", "encdec"):
            raise ValueError(cfg.family)
        raise not_ported(f"the {cfg.family} family",
                         f"LM side, {cfg.family}")
    return cfg.family


def init_params(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(),
                device=None):
    """Parameters at the reference init's distributions, drawn from the
    ``torch.Generator`` ``gen`` (on ``device``).  ``device=None`` means the
    CUDA card; ``"meta"`` gives shapes only and reads no generator."""
    dev = resolve_device(device)
    if _family(cfg) == "dense":
        return T.init_lm(cfg, gen, plan, dev)
    return ssm_lm.init_ssm_lm(cfg, gen, plan, dev)


def cast_params(params, dtype):
    """Floating leaves cast to ``dtype``, except the float32-sensitive ones
    (``F32_SENSITIVE``), which keep their dtype."""
    def one(name, p):
        if isinstance(p, dict):
            return {k: one(k, v) for k, v in p.items()}
        if name in F32_SENSITIVE or not p.is_floating_point():
            return p
        return p.to(dtype)
    return {k: one(k, v) for k, v in params.items()}


def make_prefill(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    max_len = shape.seq_len
    if _family(cfg) == "dense":
        fn = lambda p, b: T.lm_prefill(cfg, plan, p, b["tokens"], max_len)
    else:
        fn = lambda p, b: ssm_lm.ssm_prefill(cfg, plan, p, b["tokens"])
    return torch.inference_mode()(fn)


def make_decode_step(cfg: ArchConfig, shape: ShapeConfig, plan: PlanConfig):
    if _family(cfg) == "dense":
        fn = lambda p, c, t, pos: T.lm_decode_step(cfg, plan, p, c, t, pos)
    else:
        fn = lambda p, c, t, pos: ssm_lm.ssm_decode_step(cfg, plan, p, c, t,
                                                         pos)
    return torch.inference_mode()(fn)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    """The decode cache of a family: the dense KV cache or the SSM
    states."""
    if _family(cfg) == "dense":
        return T.init_cache(cfg, batch, max_len, dtype, device)
    return ssm_lm.init_ssm_cache(cfg, batch, dtype, device)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Analytic N from the parameter shapes (made on the ``meta`` device:
    nothing is allocated)."""
    if active_only and cfg.moe is not None:
        raise not_ported("active-parameter counts of MoE", "LM side, MoE")
    shapes = init_params(cfg, None, PlanConfig(), "meta")
    return sum(math.prod(t.shape) for t in tree_leaves(shapes))
