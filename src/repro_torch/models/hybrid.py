"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block
applied every ``attn_period`` backbone layers with per-invocation LoRA
deltas.

The port of ``repro.models.hybrid`` and of the hybrid prefill that the
reference writes inline in ``repro.models.api``.  Layout: ``num_layers =
n_groups * attn_period + tail``; each group runs ``attn_period`` Mamba2
layers, then the shared transformer block with the group's LoRA deltas
added to its weights (``_shared_effective``: W + a·b, in the reference's
order, so bfloat16 rounds where the reference's does).  The Mamba layers
run the SSD kernel (``ssm.ssd_chunked``) and the shared block's prefill
and training attention the flash kernel (``layers.attention_apply``): a
zamba2-7b prefill launches 81 SSD and 13 flash kernels.  With
``plan.remat == "block"`` each group's activations are recomputed in the
backward pass; the tail's are kept, as in the reference.  Decode is plain
PyTorch and writes every SSM and conv state and the shared block's key and
value rows into the cache IN PLACE (the reference threads a new cache
through its loop).  Under a plan scope each Mamba layer runs as
``ssm_lm.mamba_block`` (the mixer on the rank's heads where
``ssm.mixer_splits`` says so), and the shared block and the group's LoRA
factors are gathered over the ``fsdp`` axes before ``_shared_effective``,
where the reference gathers them: the LoRA ``b_*`` are split over
"model" as their weights are and the ``a_*`` replicated, so W + a·b is
this rank's shard of the effective weight, and the shared block runs on
the rank's heads and ``d_ff`` columns (``layers``).  Under
``sp_boundary`` (where the guard splits S) the residual stream is the
rank's rows of the sequence throughout, as the reference's Mamba
boundaries: the Mamba blocks as ``ssm_lm``'s, the shared block's norms
on the rows and its attention and MLP taking and giving rows
(``seq_in`` / ``seq_out``).  The vocabulary is split as the
transformer's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models import layers as L
from repro_torch.models import partition, ssm
from repro_torch.models.specs import (gather_fsdp, gather_mamba,
                                      tp_partial_leaves)
from repro_torch.models.ssm_lm import mamba_block
from repro_torch.models.transformer import (lm_loss_from_hidden,
                                           next_token_targets, padded_vocab)
from repro_torch.models.util import remat, stack_scan, unstack


def _geometry(cfg: ArchConfig):
    """(groups, layers a group, tail layers)."""
    n_groups = cfg.num_layers // cfg.attn_period
    tail = cfg.num_layers - n_groups * cfg.attn_period
    return n_groups, cfg.attn_period, tail


def init_hybrid(cfg: ArchConfig, gen, plan: PlanConfig = PlanConfig(), *,
                device):
    dtype = getattr(torch, plan.param_dtype)
    Vp = padded_vocab(cfg)
    G, P, T = _geometry(cfg)
    D, H, KV, hd, r = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.shared_lora_rank)

    def a():
        return L._dense_init(gen, (G, D, r), D, dtype, device)

    def zeros(*shape):
        return torch.zeros((G, r) + shape, dtype=dtype, device=device)

    params = {
        "emb": L._dense_init(gen, (Vp, D), D, dtype, device),
        "final_norm": L._ones((D,), dtype, device),
        # (G, P, ...) stacked backbone + (T, ...) tail
        "groups": ssm.init_mamba_block(gen, cfg, dtype, device, lead=(G, P)),
        "shared": {
            "ln1": L._ones((D,), dtype, device),
            "ln2": L._ones((D,), dtype, device),
            "attn": L.init_attention(gen, cfg, dtype, device),
            "mlp": L.init_mlp(gen, D, cfg.d_ff, dtype, device),
        },
        "lora": {
            "a_q": a(), "b_q": zeros(H, hd),
            "a_k": a(), "b_k": zeros(KV, hd),
            "a_v": a(), "b_v": zeros(KV, hd),
            "a_1": a(), "b_1": zeros(cfg.d_ff),
            "a_3": a(), "b_3": zeros(cfg.d_ff),
        },
    }
    if T:
        params["tail"] = ssm.init_mamba_block(gen, cfg, dtype, device,
                                              lead=(T,))
    return params


def _shared_effective(shared, lora_i):
    """The shared block's weights with one group's LoRA deltas added."""
    attn = dict(shared["attn"])
    for w, n in (("wq", "q"), ("wk", "k"), ("wv", "v")):
        attn[w] = attn[w] + torch.einsum("dr,rhk->dhk", lora_i["a_" + n],
                                         lora_i["b_" + n])
    mlp = dict(shared["mlp"])
    for w, n in (("w1", "1"), ("w3", "3")):
        mlp[w] = mlp[w] + torch.einsum("dr,rf->df", lora_i["a_" + n],
                                       lora_i["b_" + n])
    return {"ln1": shared["ln1"], "ln2": shared["ln2"], "attn": attn,
            "mlp": mlp}


def _shared_block_apply(sp, cfg, x, positions, rows: bool = False):
    """The shared block on x, or with ``rows`` on the rank's rows of the
    sequence (each sublayer all-gathers them and gives back rows)."""
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    h, cache = L.attention_apply(sp["attn"], cfg, h, positions, seq_in=rows,
                                 seq_out=rows)
    x = x + h
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(sp["mlp"], h, cfg.d_ff, seq_in=rows,
                           seq_out=rows), cache


def hybrid_hidden(cfg, plan: PlanConfig, params, embeds, positions,
                  collect_cache=False):
    """embeds: (B, S, D) -> (final hidden, {"groups": (ssm, conv) states
    (G, P, ...), "tail": (T, ...), "kv": each group's (k, v) (G, ...)}, or
    Nones without ``collect_cache``)."""
    shared = params["shared"]
    seq = partition.seq_splits(embeds.shape[1])
    partial = tp_partial_leaves(cfg, seq_rows=seq)

    def mamba_body(x, lp):
        return mamba_block(cfg, x, lp, seq=seq, collect_state=collect_cache)

    def group_body(x, inp):
        x, states = stack_scan(mamba_body, x, inp["groups"])
        sp = _shared_effective(gather_fsdp(shared, partial=partial),
                               gather_fsdp(inp["lora"], partial=partial))
        x, kv = _shared_block_apply(sp, cfg, x, positions, rows=seq)
        return x, (states, kv if collect_cache else None)

    if plan.remat == "block":
        group_body = remat(group_body)
    x = partition.tp_split(embeds, 1) if seq else embeds
    x, ys = stack_scan(group_body, x, {"groups": params["groups"],
                                       "lora": params["lora"]})
    g_states, kvs = ys if ys is not None else (None, None)
    t_states = None
    if "tail" in params:
        x, t_states = stack_scan(mamba_body, x, params["tail"])
    x = partition.tp_gather(x, 1) if seq else x
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return x, {"groups": g_states, "tail": t_states, "kv": kvs}


def _embed(params, tokens):
    return L.embed(gather_fsdp(params["emb"]), tokens,
                   params["emb"].shape[0])


def _logits(params, h):
    return L.vocab_logits(h, gather_fsdp(params["emb"]),
                          params["emb"].shape[0])


def hybrid_loss(cfg, plan, params, tokens, aux_coef=0.0):
    e = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=e.device)
    hidden, _ = hybrid_hidden(cfg, plan, params, e, positions)
    return lm_loss_from_hidden(cfg, plan, params, hidden,
                               *next_token_targets(tokens))


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
                      device):
    """Per-layer SSM and conv states, (G, P, ...) and (T, ...), and the
    shared block's k and v, one (B, max_len, KV, hd) a group."""
    G, P, T = _geometry(cfg)
    s, c = ssm.init_mamba_state(cfg, batch, dtype,
                                device=torch.device("meta"))

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"ssm_g": zeros((G, P) + tuple(s.shape), s.dtype),
             "conv_g": zeros((G, P) + tuple(c.shape), c.dtype),
             "k": zeros(kv, dtype), "v": zeros(kv, dtype)}
    if T:
        cache["ssm_t"] = zeros((T,) + tuple(s.shape), s.dtype)
        cache["conv_t"] = zeros((T,) + tuple(c.shape), c.dtype)
    return cache


def hybrid_prefill(cfg, plan, params, tokens, max_len):
    """Run the prompt, build a decode cache of capacity max_len.

    Returns (last_logits (B, Vp) float32, cache, next_pos (B,) int32): the
    states after the prompt, and k / v at rows [0, S)."""
    e = _embed(params, tokens)
    Bsz, S = tokens.shape
    positions = torch.arange(S, device=e.device)
    h, caches = hybrid_hidden(cfg, plan, params, e, positions,
                              collect_cache=True)
    logits = _logits(params, h[:, -1])
    cache = init_hybrid_cache(cfg, Bsz, max_len, e.dtype, device=e.device)
    # as the reference: the conv tails replace the zeros (shorter than
    # conv_width - 1 rows for a shorter prompt)
    cache["ssm_g"] = caches["groups"][0]
    cache["conv_g"] = caches["groups"][1].to(e.dtype)
    if caches["tail"] is not None:
        cache["ssm_t"] = caches["tail"][0]
        cache["conv_t"] = caches["tail"][1].to(e.dtype)
    k, v = (L.whole_kv_heads(t, cfg.num_kv_heads) for t in caches["kv"])
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    pos = torch.full((Bsz,), S, dtype=torch.int32, device=e.device)
    return logits, cache, pos


def hybrid_decode_step(cfg: ArchConfig, plan: PlanConfig, params, cache,
                       tokens, pos):
    """One decode step.  tokens: (B,) int32; pos: (B,) write positions.

    Returns (next_tokens (B,) int32, cache); the cache is updated in
    place."""
    x = _embed(params, tokens)
    T = _geometry(cfg)[2]

    def mamba_step(x, lp, ssm_state, conv_state):
        return ssm.mamba_decode_layer(gather_mamba(lp, cfg), cfg, x,
                                      ssm_state, conv_state)

    shared = gather_fsdp(params["shared"])
    for lps, lora_i, states, kv in zip(
            unstack(params["groups"]), unstack(params["lora"]),
            unstack({"s": cache["ssm_g"], "c": cache["conv_g"]}),
            unstack({"k": cache["k"], "v": cache["v"]})):
        for lp, st in zip(unstack(lps), unstack(states)):
            x = mamba_step(x, lp, st["s"], st["c"])
        sp = _shared_effective(shared, gather_fsdp(lora_i))
        h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
        h, _, _ = L.attention_decode(sp["attn"], cfg, h, kv["k"], kv["v"],
                                     pos, use_cp=plan.decode_cp)
        x = x + h
        h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(sp["mlp"], h, cfg.d_ff)
    if T:
        for lp, st in zip(unstack(params["tail"]),
                          unstack({"s": cache["ssm_t"], "c": cache["conv_t"]})):
            x = mamba_step(x, lp, st["s"], st["c"])
    x = L.rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
    return L.greedy(x, gather_fsdp(params["emb"]),
                    params["emb"].shape[0]), cache
