"""Decoder-only transformer LM, dense/GQA: init, loss, prefill and decode.

The port of ``repro.models.transformer`` for the dense family.  Layers are
stacked as in the reference (every block leaf has a leading layer axis) and
walked by a Python loop; with ``plan.remat == "block"`` each block's
activations are recomputed in the backward pass, as the reference's
``jax.remat`` over its scan body.  Prefill and training attention run on
the flash-attention kernel (``layers.attention_apply``; in training its
``autograd.Function``); decode is plain PyTorch and updates the KV cache IN
PLACE, layer by layer (the reference threads a new cache through its loop):
at full width the internlm2 cache for 8 slots of 4096 tokens is 3.2 GB in
bfloat16.  The loss takes the sequence in chunks of ``plan.loss_chunk``
and recomputes each chunk's float32 logits in the backward pass.

MoE and MLA blocks are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models.util import remat, stack_scan
from repro_torch.tree import tree_map


def padded_vocab(cfg: ArchConfig) -> int:
    return ((cfg.vocab_size + 255) // 256) * 256


def _dtype(plan: PlanConfig) -> torch.dtype:
    return getattr(torch, plan.param_dtype)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise L.not_ported("mixture-of-experts blocks (MoE)", "LM side, MoE")
    if cfg.mla is not None:
        raise L.not_ported("multi-head latent attention (MLA)",
                           "LM side, MLA")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, dtype, device, *, d_ff: int, lead=()):
    """One block's parameters, or ``lead``-stacked blocks (``lead=(L,)``)."""
    _check_family(cfg)
    return {
        "ln1": L._ones(lead + (cfg.d_model,), dtype, device),
        "ln2": L._ones(lead + (cfg.d_model,), dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device, lead),
        "mlp": L.init_mlp(gen, cfg.d_model, d_ff, dtype, device, lead),
    }


def init_lm(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(),
            device=torch.device("cpu")):
    _check_family(cfg)
    dtype = _dtype(plan)
    Vp = padded_vocab(cfg)
    params = {
        "emb": L._dense_init(gen, (Vp, cfg.d_model), cfg.d_model, dtype,
                             device),
        "final_norm": L._ones((cfg.d_model,), dtype, device),
        "blocks": init_block(gen, cfg, dtype, device, d_ff=cfg.d_ff,
                             lead=(cfg.num_layers,)),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._dense_init(gen, (Vp, cfg.d_model), cfg.d_model,
                                       dtype, device)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def block_apply(p, cfg: ArchConfig, x, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, cache = L.attention_apply(p["attn"], cfg, h, positions)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h), cache


def lm_hidden(cfg: ArchConfig, plan: PlanConfig, params, embeds, positions,
              collect_cache=False):
    """embeds: (B, S, D) -> (final hidden (B, S, D), {"main": (k, v)
    stacked over layers, or None})."""
    _check_family(cfg)

    def body(x, lp):
        x, cache = block_apply(lp, cfg, x, positions)
        return x, (cache if collect_cache else None)

    if plan.remat == "block":
        body = remat(body)
    x, caches = stack_scan(body, embeds, params["blocks"])
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), {"main": caches}


def embed_tokens(cfg: ArchConfig, params, tokens):
    return params["emb"][tokens.to(torch.long)]


def unembed(cfg: ArchConfig, params, x):
    head = params["emb"] if "head" not in params else params["head"]
    return torch.einsum("...d,vd->...v", x, head).to(torch.float32)


# --------------------------------------------------------------------------
# loss (sequence-chunked)
# --------------------------------------------------------------------------

def lm_loss_from_hidden(cfg: ArchConfig, plan: PlanConfig, params, hidden,
                        targets, mask):
    """hidden: (B, S, D); targets/mask: (B, S).  Mean NLL over mask.

    The sequence goes in chunks of ``plan.loss_chunk`` (the whole sequence
    when that does not divide S), each chunk's float32 logits recomputed in
    the backward pass; the target logit is taken by ``gather``, the same
    sum as the reference's one-hot product."""
    S = hidden.shape[1]
    head = params["emb"] if "head" not in params else params["head"]
    chunk = min(plan.loss_chunk, S)
    if S % chunk:
        chunk = S
    maskf = mask.to(torch.float32)

    def chunk_loss(xc, tc, mc):
        logits = torch.einsum("bsd,vd->bsv", xc, head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc.to(torch.long)[..., None])[..., 0]
        return torch.sum((lse - tgt) * mc)

    total = sum(remat(chunk_loss)(hidden[:, i:i + chunk],
                                  targets[:, i:i + chunk],
                                  maskf[:, i:i + chunk])
                for i in range(0, S, chunk))
    return total / torch.clamp(torch.sum(maskf), min=1.0)


def lm_loss(cfg: ArchConfig, plan: PlanConfig, params, tokens,
            extra_embeds: Optional[torch.Tensor] = None, aux_coef=0.01):
    """Next-token loss.  tokens: (B, S).  The reference adds ``aux_coef`` x
    the MoE balance loss, which a dense stack does not have; prepended
    embeddings (``extra_embeds``) belong to the vision-language family."""
    if extra_embeds is not None:
        raise L.not_ported("the LM loss over prepended embeddings",
                           "LM side, vlm")
    e = embed_tokens(cfg, params, tokens)
    Bsz, S, _ = e.shape
    positions = torch.arange(S, device=e.device)
    hidden, _ = lm_hidden(cfg, plan, params, e, positions)
    return lm_loss_from_hidden(cfg, plan, params, hidden,
                               *next_token_targets(tokens))


def next_token_targets(tokens):
    """(targets, mask) of next-token prediction: each position's next
    token, and a mask that drops the last position (whose target wraps)."""
    Bsz, S = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones((Bsz, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device=torch.device("cpu")):
    """Decode KV cache: {"main": {"k", "v"}}, each (L, B, max_len, KV,
    hd)."""
    _check_family(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"main": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


def block_decode(p, cfg: ArchConfig, x, cache_slices, pos, *, use_cp=False):
    """One block of one decode step; updates ``cache_slices`` in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, _, _ = L.attention_decode(p["attn"], cfg, h, cache_slices["k"],
                                 cache_slices["v"], pos, use_cp=use_cp)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h)


def _decode_stack(cfg, plan, blocks, cache, x, pos):
    for i in range(cache["k"].shape[0]):
        x = block_decode(tree_map(lambda a: a[i], blocks), cfg, x,
                         {"k": cache["k"][i], "v": cache["v"][i]}, pos,
                         use_cp=plan.decode_cp)
    return x


def lm_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache, tokens,
                   pos):
    """One decode step.  tokens: (B,) int32; pos: (B,) write positions.

    Returns (next_tokens (B,) int32, cache); the cache is updated in
    place."""
    _check_family(cfg)
    x = params["emb"][tokens.to(torch.long)]
    x = _decode_stack(cfg, plan, params["blocks"], cache["main"], x, pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x)                     # (B, Vp)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def lm_prefill(cfg: ArchConfig, plan: PlanConfig, params, tokens, max_len,
               extra_embeds: Optional[torch.Tensor] = None,
               cache_dtype=None):
    """Run the prompt, build a decode cache of capacity max_len.

    Returns (last_logits (B, Vp) float32, cache, next_pos (B,) int32)."""
    e = embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:
        e = torch.cat([extra_embeds.to(e.dtype), e], dim=1)
    Bsz, S, _ = e.shape
    positions = torch.arange(S, device=e.device)
    hidden, caches = lm_hidden(cfg, plan, params, e, positions,
                               collect_cache=True)
    cdt = cache_dtype or e.dtype
    cache = init_cache(cfg, Bsz, max_len, cdt, e.device)
    k, v = caches["main"]
    cache["main"]["k"][:, :, :S] = k
    cache["main"]["v"][:, :, :S] = v
    logits = unembed(cfg, params, hidden[:, -1, :])
    return logits, cache, torch.full((Bsz,), S, dtype=torch.int32,
                                     device=e.device)
