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
(``models.specs``) each layer's weights are gathered over the ``fsdp``
axes at the top of its body (``gather_fsdp``), the embedding, head and
final norm at their use, and an MoE decode routes the slots of every
data-parallel rank as one group, as on one device.  Where the plan splits
the compute over "model", the blocks run on the rank's heads, ``d_ff``
columns and experts (``layers``, ``moe``); the embedding is a masked
lookup in the rank's vocabulary range, the loss is vocabulary-parallel
(each chunk's max, sum of exponentials and target logit all-reduced), the
decode argmax a global one over the ranks' (max, index), and a prefill's
last logits are gathered whole.  Under ``sp_boundary`` the residual
stream between blocks is the rank's S/tp rows of the sequence (block
remat saves 1/tp of it): a block all-gathers it at entry and its MLP's
output is reduce-scattered; under ``sp_residual`` both residual sums in
the block stay on the rank's rows (the attention's and the MLP's outputs
reduce-scattered, their inputs all-gathered).  An MoE block takes the
rows whole around the experts.  Under a profiler each block marks its
attention, MLP or experts as regions (``core.tracing.region``:
``model.attention``, ``model.mlp``, ``model.moe``), in prefill, decode and
training alike (under remat a second set in the backward pass).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.core.tracing import region
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import partition
from repro_torch.models.specs import gather_fsdp, tp_partial_leaves
from repro_torch.models.util import remat, stack_scan, unstack


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
                d_ff: int, moe_group: int = 0, seq: str = "whole"):
    """Returns (x, attention cache, MoE aux loss or None).  ``seq`` is the
    layout of x over "model": "whole", or the rank's rows of the sequence
    ("boundary": gathered at entry, the MLP's output reduce-scattered;
    "residual": both residual sums on the rank's rows)."""
    rows = seq == "residual"
    attend = L.mla_apply if cfg.mla is not None else L.attention_apply
    if seq == "boundary":
        x = partition.tp_gather(x, 1)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    with region("model.attention"):
        h, cache = attend(p["attn"], cfg, h, positions, seq_in=rows,
                          seq_out=rows)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if use_moe:     # the experts take the rows whole
        with region("model.moe"):
            h, aux = M.moe_apply(p["moe"], cfg,
                                 partition.tp_gather(h, 1) if rows else h,
                                 group_size=moe_group)
        h = partition.tp_split(h, 1) if rows else h
        x = x + h
        return (partition.tp_split(x, 1) if seq == "boundary" else x,
                cache, aux)
    if seq == "boundary":
        x = partition.tp_split(x, 1)
    with region("model.mlp"):
        h = L.mlp_apply(p["mlp"], h, d_ff, seq_in=rows,
                        seq_out=rows or seq == "boundary")
    return x + h, cache, aux


def _seq_layout(plan: PlanConfig, S: int) -> str:
    """The residual stream's layout over "model" between blocks: the
    rank's rows under ``sp_boundary`` ("boundary", or "residual" with
    ``sp_residual``) where the guard splits S, else "whole"."""
    if not partition.seq_splits(S):
        return "whole"
    return "residual" if plan.sp_residual else "boundary"


def _run_stack(cfg, plan: PlanConfig, blocks, x, positions, *, use_moe,
               collect_cache: bool, d_ff: int, seq: str):
    """One stack of blocks: (x, caches stacked over layers or None, aux
    summed over layers, 0.0 for a dense stack)."""
    partial = tp_partial_leaves(cfg, seq_rows=seq == "residual")

    def body(x, lp):
        # FSDP: gather weights, per layer
        lp = gather_fsdp(lp, plan.moe_ep, partial=partial)
        x, cache, aux = block_apply(lp, cfg, x, positions, use_moe=use_moe,
                                    moe_group=plan.moe_group_size, d_ff=d_ff,
                                    seq=seq)
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
    seq = _seq_layout(plan, x.shape[1])
    if seq != "whole":
        x = partition.tp_split(x, 1)
    if "prefix_blocks" in params:
        x, caches["prefix"], a = _run_stack(
            cfg, plan, params["prefix_blocks"], x, positions, use_moe=False,
            collect_cache=collect_cache, d_ff=cfg.moe.d_ff_dense, seq=seq)
        aux = aux + a
    x, caches["main"], a = _run_stack(
        cfg, plan, params["blocks"], x, positions,
        use_moe=cfg.moe is not None, collect_cache=collect_cache,
        d_ff=cfg.d_ff, seq=seq)
    aux = aux + a
    if seq != "whole":
        x = partition.tp_gather(x, 1)
    return (L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps),
            caches, aux)


def embed_tokens(cfg: ArchConfig, params, tokens):
    return L.embed(gather_fsdp(params["emb"]), tokens, padded_vocab(cfg))


def _head(params):
    return gather_fsdp(params["emb"] if "head" not in params
                       else params["head"])


def unembed(cfg: ArchConfig, params, x):
    """Float32 logits over the whole (padded) vocabulary."""
    return L.vocab_logits(x, _head(params), padded_vocab(cfg))


# --------------------------------------------------------------------------
# loss (sequence-chunked)
# --------------------------------------------------------------------------

def lm_loss_from_hidden(cfg: ArchConfig, plan: PlanConfig, params, hidden,
                        targets, mask):
    """hidden: (B, S, D); targets/mask: (B, S).  Mean NLL over mask.

    The sequence goes in chunks of ``plan.loss_chunk`` (the whole sequence
    when that does not divide S), each chunk's float32 logits recomputed in
    the backward pass; the target logit is taken by ``gather``, the same
    sum as the reference's one-hot product.  With the head split over
    "model" each rank computes its vocabulary's logits, and the chunk's
    row maxima, sums of exponentials and target logits (from the rank that
    owns the target) are all-reduced."""
    S = hidden.shape[1]
    head = _head(params)
    chunk = min(plan.loss_chunk, S)
    if S % chunk:
        chunk = S
    maskf = mask.to(torch.float32)
    Vl = head.shape[0]
    split = Vl < padded_vocab(cfg)
    if split:
        hidden = partition.tp_enter(hidden)
        v0 = partition.tp_rank() * Vl

    def chunk_loss(xc, tc, mc):
        logits = torch.einsum("bsd,vd->bsv", xc, head).to(torch.float32)
        if not split:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1,
                               tc.to(torch.long)[..., None])[..., 0]
            return torch.sum((lse - tgt) * mc)
        m = partition.tp_max(torch.amax(logits.detach(), dim=-1))
        lse = m + torch.log(partition.tp_exit(
            torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
        local = tc.to(torch.long) - v0
        mine = (local >= 0) & (local < Vl)
        t = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        tgt = partition.tp_exit(torch.where(mine, t, torch.zeros_like(t)))
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
                 d_ff: int, use_cp=False):
    """One block of one decode step; updates ``cache_slices`` in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    with region("model.attention"):
        if cfg.mla is not None:
            h, _, _ = L.mla_decode(p["attn"], cfg, h, cache_slices["c"],
                                   cache_slices["kr"], pos)
        else:
            h, _, _ = L.attention_decode(p["attn"], cfg, h,
                                         cache_slices["k"],
                                         cache_slices["v"], pos,
                                         use_cp=use_cp)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        # the slots of every data-parallel rank route as one group
        with region("model.moe"):
            h = partition.local_rows(
                M.moe_apply(p["moe"], cfg, partition.gather_rows(h))[0],
                partition.current_split())
    else:
        with region("model.mlp"):
            h = L.mlp_apply(p["mlp"], h, d_ff)
    return x + h


def _decode_stack(cfg, plan, blocks, cache, x, pos, *, use_moe: bool,
                  d_ff: int):
    for lp, cs in zip(unstack(blocks), unstack(cache)):
        x = block_decode(gather_fsdp(lp, plan.moe_ep), cfg, x, cs, pos,
                         use_moe=use_moe, use_cp=plan.decode_cp, d_ff=d_ff)
    return x


def lm_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache, tokens,
                   pos):
    """One decode step.  tokens: (B,) int32; pos: (B,) write positions.

    Returns (next_tokens (B,) int32, cache); the cache is updated in
    place."""
    x = embed_tokens(cfg, params, tokens)
    if "prefix_blocks" in params:
        x = _decode_stack(cfg, plan, params["prefix_blocks"], cache["prefix"],
                          x, pos, use_moe=False, d_ff=cfg.moe.d_ff_dense)
    x = _decode_stack(cfg, plan, params["blocks"], cache["main"], x, pos,
                      use_moe=cfg.moe is not None, d_ff=cfg.d_ff)
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return L.greedy(x, _head(params), padded_vocab(cfg)), cache


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
            if name in ("k", "v"):
                src = L.whole_kv_heads(src, cfg.num_kv_heads)
            leaves[name][:, :, :S] = src
    logits = unembed(cfg, params, hidden[:, -1, :])
    return logits, cache, torch.full((Bsz,), S, dtype=torch.int32,
                                     device=e.device)
