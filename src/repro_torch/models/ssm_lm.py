"""Pure-SSM LM (mamba2-370m): stacked Mamba2 blocks, no attention anywhere.

The port of ``repro.models.ssm_lm``: init, loss, prefill and decode.  The
forward runs the SSD kernel once per layer (``ssm.ssd_chunked``; in
training its ``autograd.Function``), with each block's activations
recomputed in the backward pass when ``plan.remat == "block"``.  Decode is
plain PyTorch and writes each layer's new SSM and conv state into the cache
IN PLACE (the reference returns a new cache).  Under a plan scope each
layer's weights are gathered whole at the top of its body (the Mamba
mixer is not split over "model": every model rank computes the whole
layer), and a decode gathers each state's heads (split over "model" by
``CACHE_RULES``) and writes back the rank's own.  The vocabulary is split
over "model" as the transformer's: a masked embedding lookup, the
vocabulary-parallel loss, a global decode argmax.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import partition, ssm
from repro_torch.models.specs import gather_fsdp
from repro_torch.models.transformer import (lm_loss_from_hidden,
                                           next_token_targets, padded_vocab)
from repro_torch.models.util import remat, stack_scan, unstack


def init_ssm_lm(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(), *,
                device):
    dtype = getattr(torch, plan.param_dtype)
    Vp = padded_vocab(cfg)
    return {
        "emb": L._dense_init(gen, (Vp, cfg.d_model), cfg.d_model, dtype,
                             device),
        "final_norm": L._ones((cfg.d_model,), dtype, device),
        "blocks": ssm.init_mamba_block(gen, cfg, dtype, device,
                                       lead=(cfg.num_layers,)),
    }


def ssm_hidden(cfg: ArchConfig, plan: PlanConfig, params, embeds,
               collect_state=False):
    def body(x, lp):
        lp = gather_fsdp(lp, whole=True)
        h, state = ssm.mamba_apply(lp, cfg,
                                   L.rms_norm(x, lp["ln"], cfg.norm_eps))
        return x + h, (state if collect_state else None)

    if plan.remat == "block":
        body = remat(body)
    x, states = stack_scan(body, embeds, params["blocks"])
    return (L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps),
            states)


def _embed(params, tokens):
    return L.embed(gather_fsdp(params["emb"]), tokens,
                   params["emb"].shape[0])


def _logits(params, h):
    return L.vocab_logits(h, gather_fsdp(params["emb"]),
                          params["emb"].shape[0])


def ssm_lm_loss(cfg, plan, params, tokens, aux_coef=0.0):
    e = _embed(params, tokens)
    hidden, _ = ssm_hidden(cfg, plan, params, e)
    return lm_loss_from_hidden(cfg, plan, params, hidden,
                               *next_token_targets(tokens))


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, *, device):
    """Per-layer (ssm_state, conv_state) stacked over layers."""
    s, c = ssm.init_mamba_state(cfg, batch, dtype,
                                device=torch.device("meta"))
    L_ = cfg.num_layers
    return {"ssm": torch.zeros((L_,) + tuple(s.shape), dtype=s.dtype,
                               device=device),
            "conv": torch.zeros((L_,) + tuple(c.shape), dtype=c.dtype,
                                device=device)}


def ssm_prefill(cfg, plan, params, tokens):
    e = _embed(params, tokens)
    hidden, states = ssm_hidden(cfg, plan, params, e, collect_state=True)
    logits = _logits(params, hidden[:, -1])
    cache = {"ssm": states[0], "conv": states[1].to(e.dtype)}
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                     device=e.device)
    return logits, cache, pos


def ssm_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache, tokens,
                    pos):
    """One decode step; pos is unused (state-space models carry no
    positional cache).  Returns (next_tokens (B,) int32, cache); the cache
    is updated in place."""
    x = _embed(params, tokens)
    for lp, c in zip(unstack(params["blocks"]), unstack(cache)):
        lp = gather_fsdp(lp, whole=True)
        s_i, c_i = c["ssm"], c["conv"]
        h, (s2, c2) = ssm.mamba_step(
            lp, cfg, L.rms_norm(x, lp["ln"], cfg.norm_eps),
            (partition.rows_of(s_i), partition.rows_of(c_i)))
        partition.store_rows(s_i, s2)
        partition.store_rows(c_i, c2)
        x = x + h
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return L.greedy(x, gather_fsdp(params["emb"]),
                    params["emb"].shape[0]), cache
