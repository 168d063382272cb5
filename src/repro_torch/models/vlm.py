"""InternVL2-style VLM: a vision frontend STUB and the decoder LM backbone.

The port of ``repro.models.vlm``.  The caller provides precomputed patch
embeddings (B, P, D) (the InternViT tower is out of scope, as in the
reference); they are prepended to the token embeddings, and the loss
applies to the text positions only.  Everything else is the transformer's.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import transformer as T

init_vlm = T.init_lm


def vlm_loss(cfg: ArchConfig, plan: PlanConfig, params, patch_embeds, tokens,
             aux_coef=0.0):
    return T.lm_loss(cfg, plan, params, tokens, extra_embeds=patch_embeds,
                     aux_coef=aux_coef)


def vlm_prefill(cfg, plan, params, patch_embeds, tokens, max_len):
    return T.lm_prefill(cfg, plan, params, tokens, max_len,
                        extra_embeds=patch_embeds)


vlm_decode_step = T.lm_decode_step
