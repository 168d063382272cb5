"""Pure-SSM LM (mamba2-370m): stacked Mamba2 blocks, no attention anywhere.

The port of ``repro.models.ssm_lm``: init, loss, prefill and decode.  The
forward runs the SSD kernel once per layer (``ssm.ssd_chunked``; in
training its ``autograd.Function``), with each block's activations
recomputed in the backward pass when ``plan.remat == "block"``.  Decode is
plain PyTorch and writes each layer's new SSM and conv state into the cache
IN PLACE (the reference returns a new cache).  Under a plan scope each
layer's weights are gathered at the top of its body
(``specs.gather_mamba``) and the mixer runs on the rank's heads where
``ssm.mixer_splits`` says so (``models.ssm``), else whole on every model
rank; a decode reads and writes the rank's heads of each SSM state in
place and the conv state's span.  Under ``sp_boundary`` (where the guard
splits S) the residual stream between blocks is the rank's rows of the
sequence, as the reference's ``pcon(x, "dp", "sp", None)``: the block's
norm acts on the rows, the mixer all-gathers them at entry and
reduce-scatters its output, and the final norm's input is gathered.  The
vocabulary is split over "model" as the transformer's: a masked embedding
lookup, the vocabulary-parallel loss, a global decode argmax.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import partition, ssm
from repro_torch.models.specs import gather_fsdp, gather_mamba
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


def mamba_block(cfg: ArchConfig, x, lp, *, seq: bool, collect_state: bool):
    """One Mamba block on the residual ``x`` (the rank's rows of the
    sequence with ``seq``): (x + mixer(norm(x)), its state or None)."""
    lp = gather_mamba(lp, cfg, seq_rows=seq)
    h, state = ssm.mamba_apply(lp, cfg, L.rms_norm(x, lp["ln"], cfg.norm_eps),
                               seq=seq, state=collect_state)
    return x + h, state


def ssm_hidden(cfg: ArchConfig, plan: PlanConfig, params, embeds,
               collect_state=False):
    seq = partition.seq_splits(embeds.shape[1])

    def body(x, lp):
        return mamba_block(cfg, x, lp, seq=seq, collect_state=collect_state)

    if plan.remat == "block":
        body = remat(body)
    x = partition.tp_split(embeds, 1) if seq else embeds
    x, states = stack_scan(body, x, params["blocks"])
    x = partition.tp_gather(x, 1) if seq else x
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
        x = ssm.mamba_decode_layer(gather_mamba(lp, cfg), cfg, x, c["ssm"],
                                   c["conv"])
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return L.greedy(x, gather_fsdp(params["emb"]),
                    params["emb"].shape[0]), cache
