"""Seamless-M4T-style encoder-decoder backbone (the audio frontend is a
stub: the encoder consumes precomputed frame embeddings (B, S, D)).

The port of ``repro.models.encdec``.  The encoder is non-causal
self-attention with RoPE over the frames; each decoder block is causal
self-attention, cross-attention over the encoder's output (keys and values
projected from it, no RoPE) and a SwiGLU MLP.  All three attentions of a
prefill or a train step run on the flash kernel
(``layers.attention_apply``); with ``plan.remat == "block"`` each block's
activations are recomputed in the backward pass.  Decode is plain
PyTorch: the self-attention writes its key and value rows into the cache
IN PLACE (``layers.attention_decode``), and the cross-attention reads the
fixed encoder cache ``xk``/``xv`` with no mask, as the reference computes
it in jnp: rows of ``xk`` that ``BatchServer`` zero-filled past a shorter
request's frames score 0 and take weight.  Under a plan scope each
layer's weights are gathered over the ``fsdp`` axes at the top of its
body, and the three attentions and the MLP run on the rank's heads and
``d_ff`` columns where the plan splits the compute over "model"
(``layers``); the vocabulary is split as the transformer's.  The encoder
cache ``xk``/``xv`` keeps every KV head (``CACHE_RULES``), and a decode
gathers its spans (cross-attention has no context-parallel route, as in
the reference).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import partition
from repro_torch.models.specs import gather_fsdp, tp_partial_leaves
from repro_torch.models.transformer import (lm_loss_from_hidden,
                                           next_token_targets, padded_vocab)
from repro_torch.models.util import remat, stack_scan, unstack

# fixed encoder-context length of the decode cache (the reference's
# decode-shape cells)
DECODE_ENC_LEN = 4096


def init_encdec(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(), *,
                device):
    dtype = getattr(torch, plan.param_dtype)
    D = cfg.d_model

    def ones(lead):
        return L._ones(lead + (D,), dtype, device)

    def enc_blocks(lead):
        return {"ln1": ones(lead), "ln2": ones(lead),
                "attn": L.init_attention(gen, cfg, dtype, device, lead),
                "mlp": L.init_mlp(gen, D, cfg.d_ff, dtype, device, lead)}

    def dec_blocks(lead):
        return {"ln1": ones(lead), "lnx": ones(lead), "ln2": ones(lead),
                "attn": L.init_attention(gen, cfg, dtype, device, lead),
                "xattn": L.init_attention(gen, cfg, dtype, device, lead),
                "mlp": L.init_mlp(gen, D, cfg.d_ff, dtype, device, lead)}

    return {
        "emb": L._dense_init(gen, (padded_vocab(cfg), D), D, dtype, device),
        "enc_blocks": enc_blocks((cfg.encoder_layers,)),
        "dec_blocks": dec_blocks((cfg.num_layers,)),
        "enc_norm": ones(()),
        "final_norm": ones(()),
    }


def encode(cfg, plan: PlanConfig, params, frames):
    """frames: (B, S_enc, D) stub embeddings -> encoder hidden."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    partial = tp_partial_leaves(cfg)

    def body(x, lp):
        lp = gather_fsdp(lp, partial=partial)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, _ = L.attention_apply(lp["attn"], cfg, h, positions, causal=False)
        x = x + h
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], h, cfg.d_ff), None

    if plan.remat == "block":
        body = remat(body)
    x, _ = stack_scan(body, frames, params["enc_blocks"])
    return L.rms_norm(x, gather_fsdp(params["enc_norm"]), cfg.norm_eps)


def decode_hidden(cfg, plan: PlanConfig, params, tokens, enc_out,
                  collect_cache=False):
    """tokens: (B, S) -> (final hidden (B, S, D), ((k, v), (xk, xv))
    stacked over layers, or None)."""
    x = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    partial = tp_partial_leaves(cfg)

    def body(x, lp):
        lp = gather_fsdp(lp, partial=partial)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, self_kv = L.attention_apply(lp["attn"], cfg, h, positions,
                                       causal=True)
        x = x + h
        h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
        h, cross_kv = L.attention_apply(lp["xattn"], cfg, h, None,
                                        causal=False, xkv=enc_out)
        x = x + h
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.d_ff)
        return x, ((self_kv, cross_kv) if collect_cache else None)

    if plan.remat == "block":
        body = remat(body)
    x, caches = stack_scan(body, x, params["dec_blocks"])
    return (L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps),
            caches)


def _embed(params, tokens):
    return L.embed(gather_fsdp(params["emb"]), tokens,
                   params["emb"].shape[0])


def _logits(params, h):
    return L.vocab_logits(h, gather_fsdp(params["emb"]),
                          params["emb"].shape[0])


def encdec_loss(cfg, plan, params, frames, tokens, aux_coef=0.0):
    enc_out = encode(cfg, plan, params, frames)
    hidden, _ = decode_hidden(cfg, plan, params, tokens, enc_out)
    return lm_loss_from_hidden(cfg, plan, params, hidden,
                               *next_token_targets(tokens))


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, dtype, *, device):
    """Self-attention k, v (L, B, max_len, KV, hd) and the encoder's
    cross-attention xk, xv (L, B, enc_len, KV, hd)."""
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.head_dim)

    def zeros(n):
        return torch.zeros(lead + (n,) + tail, dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def encdec_prefill(cfg, plan, params, frames, bos_tokens, max_len):
    """Encode frames, run the decoder prompt, build the self and cross
    caches (xk and xv as long as the frames).

    Returns (last_logits (B, Vp) float32, cache, next_pos (B,) int32)."""
    enc_out = encode(cfg, plan, params, frames)
    hidden, caches = decode_hidden(cfg, plan, params, bos_tokens, enc_out,
                                   collect_cache=True)
    (sk, sv), (xk, xv) = ((L.whole_kv_heads(t, cfg.num_kv_heads)
                           for t in pair) for pair in caches)
    dt = enc_out.dtype
    Bsz, Sp = bos_tokens.shape
    rows = (cfg.num_layers, Bsz, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(rows, dtype=dt, device=enc_out.device),
             "v": torch.zeros(rows, dtype=dt, device=enc_out.device),
             "xk": xk.to(dt), "xv": xv.to(dt)}
    cache["k"][:, :, :Sp] = sk
    cache["v"][:, :, :Sp] = sv
    logits = _logits(params, hidden[:, -1])
    return logits, cache, torch.full((Bsz,), Sp, dtype=torch.int32,
                                     device=enc_out.device)


def encdec_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache,
                       tokens, pos):
    """One decode step.  tokens: (B,) int32; pos: (B,) write positions.

    Returns (next_tokens (B,) int32, cache); the self-attention cache is
    updated in place."""
    x = _embed(params, tokens)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lp, c in zip(unstack(params["dec_blocks"]), unstack(cache)):
        lp = gather_fsdp(lp)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, _, _ = L.attention_decode(lp["attn"], cfg, h, c["k"], c["v"], pos)
        x = x + h
        # cross-attention over the fixed encoder cache, unmasked, on this
        # rank's query heads and the KV heads they read
        h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
        xp = lp["xattn"]
        q = torch.einsum("bd,dhk->bhk", h, xp["wq"])
        if cfg.qkv_bias:
            q = q + xp["bq"]
        Hl = q.shape[1]
        xk, xv = (L.rank_kv(partition.rows_of(c[n]), H, KV, Hl)
                  for n in ("xk", "xv"))
        ke = L._expand_kv(xk, Hl // xk.shape[2])
        ve = L._expand_kv(xv, Hl // xv.shape[2])
        s = torch.einsum("bhk,bshk->bhs", q, ke).to(torch.float32) \
            / math.sqrt(hd)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhs,bshk->bhk", w, ve)
        out = torch.einsum("bhk,hkd->bd", o, xp["wo"])
        x = x + (partition.tp_exit(out) if Hl < H else out)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.d_ff)
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return L.greedy(x, gather_fsdp(params["emb"]),
                    params["emb"].shape[0]), cache
