"""Decoder-only transformer LM (dense GQA, MLA and MoE variants): init,
loss, prefill and decode.

The port of ``repro.models.transformer`` for the dense and MoE families,
and the backbone of the vision-language family (``models.vlm``: patch
embeddings prepended to the prompt's).
Attention is GQA (``layers.attention_apply``) or MLA (``layers.mla_apply``),
the feed-forward a SwiGLU MLP or a mixture of experts (``moe.moe_apply``),
and an MoE model's first ``moe.first_dense_layers`` blocks are a dense
``prefix_blocks`` stack with ``moe.d_ff_dense``.  Layers are
stacked as in the reference (every block leaf has a leading layer axis) and
walked by a Python loop; with ``plan.remat == "block"`` each block's
activations are recomputed in the backward pass, as the reference's
``jax.remat`` over its scan body.  Prefill and training attention run on
the flash-attention kernel (in training its ``autograd.Function``);
decode is plain PyTorch and updates the KV cache (GQA: k and v; MLA: the
latent c and the rotated kr) IN PLACE, layer by layer (the reference
threads a new cache through its loop): at full width the internlm2 cache
for 8 slots of 4096 tokens is 3.2 GB in bfloat16.  The loss takes the
sequence in chunks of ``plan.loss_chunk`` and recomputes each chunk's
float32 logits in the backward pass, and adds ``aux_coef`` x the MoE
blocks' load-balance loss, summed over layers.  Under a plan scope
(``models.specs``) each layer's weights are gathered whole at the top of
its body (``gather_fsdp``), the embedding, head and final norm at their
use, and an MoE decode routes the slots of every data-parallel rank as
one group, as on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import partition
from repro_torch.models.specs import gather_fsdp
from repro_torch.models.util import remat, stack_scan
from repro_torch.tree import tree_leaves, tree_map


def padded_vocab(cfg: ArchConfig) -> int:
    return ((cfg.vocab_size + 255) // 256) * 256


def _dtype(plan: PlanConfig) -> torch.dtype:
    return getattr(torch, plan.param_dtype)


def prefix_layers(cfg: ArchConfig) -> int:
    """Leading dense layers of an MoE model (``prefix_blocks``)."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, dtype, device, *, use_moe: bool,
               d_ff: int, lead=()):
    """One block's parameters, or ``lead``-stacked blocks (``lead=(L,)``):
    MLA or GQA attention, an MoE or an MLP."""
    p = {
        "ln1": L._ones(lead + (cfg.d_model,), dtype, device),
        "ln2": L._ones(lead + (cfg.d_model,), dtype, device),
        "attn": (L.init_mla(gen, cfg, dtype, device=device, lead=lead)
                 if cfg.mla is not None
                 else L.init_attention(gen, cfg, dtype, device, lead)),
    }
    if use_moe:
        p["moe"] = M.init_moe(gen, cfg, dtype, device=device, lead=lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, d_ff, dtype, device, lead)
    return p


def init_lm(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(), *,
            device):
    dtype = _dtype(plan)
    Vp = padded_vocab(cfg)
    n_prefix = prefix_layers(cfg)
    params = {
        "emb": L._dense_init(gen, (Vp, cfg.d_model), cfg.d_model, dtype,
                             device),
        "final_norm": L._ones((cfg.d_model,), dtype, device),
        "blocks": init_block(gen, cfg, dtype, device,
                             use_moe=cfg.moe is not None, d_ff=cfg.d_ff,
                             lead=(cfg.num_layers - n_prefix,)),
    }
    if n_prefix:
        params["prefix_blocks"] = init_block(
            gen, cfg, dtype, device, use_moe=False,
            d_ff=cfg.moe.d_ff_dense, lead=(n_prefix,))
    if not cfg.tie_embeddings:
        params["head"] = L._dense_init(gen, (Vp, cfg.d_model), cfg.d_model,
                                       dtype, device)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def block_apply(p, cfg: ArchConfig, x, positions, *, use_moe: bool,
                moe_group: int = 0):
    """Returns (x, attention cache, MoE aux loss or None)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        h, cache = L.mla_apply(p["attn"], cfg, h, positions)
    else:
        h, cache = L.attention_apply(p["attn"], cfg, h, positions)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if use_moe:
        h, aux = M.moe_apply(p["moe"], cfg, h, group_size=moe_group)
    else:
        h = L.mlp_apply(p["mlp"], h)
    return x + h, cache, aux


def _run_stack(cfg, plan: PlanConfig, blocks, x, positions, *, use_moe,
               collect_cache: bool):
    """One stack of blocks: (x, caches stacked over layers or None, aux
    summed over layers, 0.0 for a dense stack)."""
    def body(x, lp):
        lp = gather_fsdp(lp, plan.moe_ep)   # FSDP: gather weights, per layer
        x, cache, aux = block_apply(lp, cfg, x, positions, use_moe=use_moe,
                                    moe_group=plan.moe_group_size)
        return x, (cache if collect_cache else None, aux)

    if plan.remat == "block":
        body = remat(body)
    x, ys = stack_scan(body, x, blocks)
    caches, auxs = ys if ys is not None else (None, None)
    return x, caches, (torch.sum(auxs) if use_moe else 0.0)


def lm_hidden(cfg: ArchConfig, plan: PlanConfig, params, embeds, positions,
              collect_cache=False):
    """embeds: (B, S, D) -> (final hidden (B, S, D), {"prefix", "main":
    attention caches stacked over layers, or None}, aux loss)."""
    x, caches, aux = embeds, {}, 0.0
    if "prefix_blocks" in params:
        x, caches["prefix"], a = _run_stack(
            cfg, plan, params["prefix_blocks"], x, positions, use_moe=False,
            collect_cache=collect_cache)
        aux = aux + a
    x, caches["main"], a = _run_stack(
        cfg, plan, params["blocks"], x, positions,
        use_moe=cfg.moe is not None, collect_cache=collect_cache)
    aux = aux + a
    return (L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps),
            caches, aux)


def embed_tokens(cfg: ArchConfig, params, tokens):
    return gather_fsdp(params["emb"])[tokens.to(torch.long)]


def _head(params):
    return gather_fsdp(params["emb"] if "head" not in params
                       else params["head"])


def unembed(cfg: ArchConfig, params, x):
    head = _head(params)
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
    head = _head(params)
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
    """Next-token loss plus ``aux_coef`` x the MoE balance loss (0 for a
    dense stack).  tokens: (B, S_text).  ``extra_embeds`` (B, P, D), the
    vision-language family's patches, are prepended; the loss covers the
    text positions only."""
    e = embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:
        e = torch.cat([extra_embeds.to(e.dtype), e], dim=1)
    positions = torch.arange(e.shape[1], device=e.device)
    hidden, _, aux = lm_hidden(cfg, plan, params, e, positions)
    P = 0 if extra_embeds is None else extra_embeds.shape[1]
    loss = lm_loss_from_hidden(cfg, plan, params, hidden[:, P:],
                               *next_token_targets(tokens))
    return loss + aux_coef * aux


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

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
               device):
    """Decode cache: {"main"[, "prefix"]: per-layer leaves}, GQA {"k", "v"}
    each (L, B, max_len, KV, hd), or MLA {"c": (L, B, max_len, R), "kr":
    (L, B, max_len, rd)}."""
    if cfg.mla is not None:
        rows = {"c": (cfg.mla.kv_lora_rank,),
                "kr": (cfg.mla.qk_rope_head_dim,)}
    else:
        rows = dict.fromkeys(("k", "v"), (cfg.num_kv_heads, cfg.head_dim))

    def one(n):
        return {name: torch.zeros((n, batch, max_len) + shape, dtype=dtype,
                                  device=device)
                for name, shape in rows.items()}
    n_prefix = prefix_layers(cfg)
    cache = {"main": one(cfg.num_layers - n_prefix)}
    if n_prefix:
        cache["prefix"] = one(n_prefix)
    return cache


def block_decode(p, cfg: ArchConfig, x, cache_slices, pos, *, use_moe: bool,
                 use_cp=False):
    """One block of one decode step; updates ``cache_slices`` in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        h, _, _ = L.mla_decode(p["attn"], cfg, h, cache_slices["c"],
                               cache_slices["kr"], pos)
    else:
        h, _, _ = L.attention_decode(p["attn"], cfg, h, cache_slices["k"],
                                     cache_slices["v"], pos, use_cp=use_cp)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        # the slots of every data-parallel rank route as one group
        h = partition.local_rows(M.moe_apply(p["moe"], cfg,
                                             partition.gather_rows(h))[0],
                                 partition.current_split())
    else:
        h = L.mlp_apply(p["mlp"], h)
    return x + h


def _decode_stack(cfg, plan, blocks, cache, x, pos, *, use_moe: bool):
    for i in range(tree_leaves(cache)[0].shape[0]):
        x = block_decode(gather_fsdp(tree_map(lambda a: a[i], blocks),
                                     plan.moe_ep), cfg, x,
                         {k: a[i] for k, a in cache.items()}, pos,
                         use_moe=use_moe, use_cp=plan.decode_cp)
    return x


def lm_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache, tokens,
                   pos):
    """One decode step.  tokens: (B,) int32; pos: (B,) write positions.

    Returns (next_tokens (B,) int32, cache); the cache is updated in
    place."""
    x = embed_tokens(cfg, params, tokens)
    if "prefix_blocks" in params:
        x = _decode_stack(cfg, plan, params["prefix_blocks"], cache["prefix"],
                          x, pos, use_moe=False)
    x = _decode_stack(cfg, plan, params["blocks"], cache["main"], x, pos,
                      use_moe=cfg.moe is not None)
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
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
    hidden, caches, _ = lm_hidden(cfg, plan, params, e, positions,
                                  collect_cache=True)
    cdt = cache_dtype or e.dtype
    cache = init_cache(cfg, Bsz, max_len, cdt, device=e.device)
    for grp, leaves in cache.items():
        for name, src in zip(leaves, caches[grp]):
            leaves[name][:, :, :S] = src
    logits = unembed(cfg, params, hidden[:, -1, :])
    return logits, cache, torch.full((Bsz,), S, dtype=torch.int32,
                                     device=e.device)
