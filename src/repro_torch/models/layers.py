"""Shared model layers: norms, RoPE, SwiGLU MLP, GQA/MHA and MLA attention.

Functional, as the reference's ``repro.models.layers``: parameters are plain
dicts of tensors made by ``init_*``, with the reference's names and layouts
(``wq`` (D, H, hd), ``wo`` (H, hd, D), ``w1`` (D, F), ...), and forward
functions take (params, inputs) and use ``torch.einsum`` in the reference's
index order.  The reference's sharding constraints (``pcon``) are dropped:
activations are each rank's local tensors (``models.partition``).

Full-sequence attention in prefill and training goes through the
flash-attention kernel, ``kernels.ops.flash_attention``, in place of the
reference's query-chunked jnp ``sdpa_chunked``, with the GQA KV heads read
in place (no expanded or folded copies); with gradients it is the kernel's
``autograd.Function``, whose plain backward recomputes P in blocks of
``sdpa_chunked``'s 1024 query rows.  It is causal self-attention in the
decoder-only families, non-causal in the encoder-decoder's encoder, and
cross-attention (keys and values projected from ``xkv``, Sq != Sk,
non-causal, no RoPE) in its decoder.  Decode attention
is plain PyTorch, as in the reference, and writes the new key and value
into the cache IN PLACE (the reference returns an updated copy): at full
width the internlm2 cache is gigabytes, and no caller needs the old one.

Multi-head latent attention (MLA, DeepSeek-V2) prefills and trains on the
same flash kernel: q and k are ``qk_nope + qk_rope`` wide (192 at
deepseek-v2-lite) and v ``v_head_dim`` (128), passed at its own width as
the reference's ``sdpa_chunked`` takes it (scaled by 1/sqrt(q's width), as
the kernels do); the bfloat16 tensor-core kernel reads v at 128, a kernel
that takes one width gets it zero-padded (``flash_attention_cuda``).  MLA
decode is
the reference's absorbed form (attention in the latent space), in plain
PyTorch, writing the latent ``c`` and rotated ``kr`` rows in place.

Under a plan scope with ranks (``models.partition``) the activations are
the rank's rows of the batch, the weights reach these functions gathered
over the ``fsdp`` axes only, and the compute is split over "model" as the
reference's GSPMD splits it (Megatron-LM's scheme): attention on the
rank's query heads (``wq``, ``wo``, MLA's ``wkv_b``) and the KV heads
they read, the MLP on its ``d_ff`` columns.  A split region starts with
``partition.tp_enter`` (f) and ends with ``tp_exit`` (g) on the
row-parallel product (``wo``, ``w2``), or, with ``seq_in`` / ``seq_out``,
takes and gives the rank's rows of the sequence (an all-gather on entry,
a reduce-scatter on exit).  Whether a weight is split is read from its
local shape against the config's: the divisibility guard may replicate it
(``wk``/``wv`` when KV % tp != 0: the rank reads the KV heads its query
heads need, a view; ``wq``/``wo`` when H % tp != 0: the whole attention
on every rank, no g).  A decode cache leaf is a ``DTensor`` whose seq
dimension may be split over "model" (``CACHE_RULES``), with every KV head.
Context-parallel decode (``use_cp``, ``_decode_attend_cp``) attends to
the rank's own span with every query head (the local heads all-gathered,
as the reference's ``shard_map`` takes q replicated over "model") and
combines the spans' partial softmaxes with all-reduces over "model" (the
log-sum-exp trick); ``cp_combines()`` counts its combines.  Without a
scope, or when the cache's seq dimension is not split, it falls back to
``ops.decode_attention``, as the reference does.  The naive route under a
mesh (and MLA's and the cross-attention's, which have no CP variant) gathers
the spans, attends on the rank's heads, and writes back the rank's own
span.  The vocabulary helpers (``embed``, ``vocab_logits``, ``greedy``)
take the embedding or head split over "model" on its rows.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import counters, ops
from repro_torch.models import partition


# --------------------------------------------------------------------------
# initialization helpers
# --------------------------------------------------------------------------

def _dense_init(gen, shape, in_dim, dtype, device):
    """N(0, 1/in_dim) in float32, cast to ``dtype``; on the ``meta`` device
    only the shape (no generator is read)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


def rms_norm_gated(x, z, w, eps: float = 1e-5, width: int = 0):
    """Mamba2 gated norm: rmsnorm(x * silu(z)).  ``width``: the normalised
    dimension's whole size where x, z and w hold this rank's columns of it
    (the heads of a Mamba mixer split over "model"): the squares' sum is
    summed over the ranks (``partition.tp_sum``) and divided by it."""
    xf = x.to(torch.float32) * F.silu(z.to(torch.float32))
    if width and width != x.shape[-1]:
        var = partition.tp_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) \
            / width
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_apply(x, positions, theta: float):
    """Rotate the last dim.  x: (..., S, H, rd), or (B, H, rd) for decode.

    positions broadcasts against x's sequence/batch dims: (S,) or (B, S),
    or (B,) for single-token decode; the broadcast is picked by ndim, as in
    the reference."""
    rd = x.shape[-1]
    if rd % 2:
        raise ValueError("rope dim must be even")
    half = rd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs         # (..., half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim in (ang.ndim + 2, ang.ndim + 1):   # prefill (S, H) / decode (H)
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, dtype, device, lead=()):
    return {
        "w1": _dense_init(gen, lead + (d_model, d_ff), d_model, dtype, device),
        "w3": _dense_init(gen, lead + (d_model, d_ff), d_model, dtype, device),
        "w2": _dense_init(gen, lead + (d_ff, d_model), d_ff, dtype, device),
    }


def mlp_apply(p, x, d_ff: int, *, seq_in=False, seq_out=False):
    """SwiGLU.  ``d_ff`` is the MLP's whole width: where the local ``w1``
    is narrower, the MLP runs on this rank's columns (f, w1 and w3, w2,
    then g).  ``seq_in`` / ``seq_out``: x is, and the output is to be, the
    rank's rows of the sequence (dimension 1)."""
    split = p["w1"].shape[-1] < d_ff
    x = _enter(x, split, seq_in)
    h = torch.einsum("...d,df->...f", x, p["w1"])
    g = torch.einsum("...d,df->...f", x, p["w3"])
    h = F.silu(g.to(torch.float32)).to(x.dtype) * h
    return _exit(torch.einsum("...f,fd->...d", h, p["w2"]), split, seq_out)


def _enter(x, split: bool, seq_in: bool):
    """The input of a region split over "model" (f, or the all-gather of
    the rank's seq rows), or of one that every rank computes whole."""
    if split:
        return partition.seq_enter(x) if seq_in else partition.tp_enter(x)
    return partition.tp_gather(x, 1) if seq_in else x


def _exit(out, split: bool, seq_out: bool):
    """A region's output: the ranks' partial sums summed (g) or
    reduce-scattered to the rank's seq rows; a whole output as it is or
    its rank's rows."""
    if split:
        return partition.seq_exit(out) if seq_out else partition.tp_exit(out)
    return partition.tp_split(out, 1) if seq_out else out


# --------------------------------------------------------------------------
# dense GQA/MHA attention
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, dtype, device, lead=()):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, lead + (D, H, hd), D, dtype, device),
        "wk": _dense_init(gen, lead + (D, KV, hd), D, dtype, device),
        "wv": _dense_init(gen, lead + (D, KV, hd), D, dtype, device),
        "wo": _dense_init(gen, lead + (H, hd, D), H * hd, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (KV, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (KV, hd), dtype=dtype, device=device)
    return p


def _expand_kv(k, n_rep):
    """Repeat KV heads to the query heads: query head h reads KV head
    h // n_rep (``jnp.repeat`` along heads).  A repeat counts the bytes it
    writes (``counters.LM_WORK.expand_kv_bytes``)."""
    if n_rep == 1:
        return k
    out = torch.repeat_interleave(k, n_rep, dim=-2)
    counters.add(counters.LM_WORK, "expand_kv_bytes",
                 out.numel() * out.element_size())
    return out


def rank_kv(k, H: int, KV: int, Hl: int):
    """The KV heads (dimension -2 of ``k``, which holds all KV) that this
    rank's ``Hl`` query heads read, query head h reading KV head
    h // (H // KV), as a view: the rank's heads must come in equal groups
    of the KV heads they read, as they do where Hl is a multiple of the
    group H // KV or divides it (every config at tp 4 and 16); else a
    ValueError.  ``k`` itself when the rank holds every query head."""
    if Hl == H:
        return k
    G = H // KV
    h0 = partition.tp_rank() * Hl
    kv0 = h0 // G
    n = (h0 + Hl - 1) // G + 1 - kv0
    if Hl % n or any((h0 + j) // G - kv0 != j // (Hl // n)
                     for j in range(Hl)):
        raise ValueError(f"query heads {h0}..{h0 + Hl - 1} of {H} read "
                         f"groups of {G} KV heads unevenly")
    return k.narrow(-2, kv0, n)


def _heads_kv(k, cfg: ArchConfig, Hl: int):
    """The KV heads of a projection ``k`` that this rank's query heads
    read: ``k`` itself where its heads are split with them."""
    if k.shape[-2] < cfg.num_kv_heads:
        return k
    return rank_kv(k, cfg.num_heads, cfg.num_kv_heads, Hl)


def _kv_bias(b, k):
    """A KV bias (replicated by its rule) for the KV heads of ``k``: this
    rank's where the heads are split."""
    n = k.shape[-2]
    return b if b.shape[-2] == n else b.narrow(-2, partition.tp_rank() * n, n)


def whole_kv_heads(t, KV: int):
    """A key or value tensor (heads at dimension -2) with every KV head:
    gathered over "model" where the rank holds its own (the cache's
    layout, ``CACHE_RULES``)."""
    return t if t.shape[-2] == KV else partition.tp_gather(t, t.ndim - 2)


def attention_apply(p, cfg: ArchConfig, x, positions, *, causal=True,
                    xkv=None, seq_in=False, seq_out=False):
    """Attention over the full sequence (prefill, training), on the flash
    kernel, which reads q (B, Sq, H, hd) and the KV heads of k and v
    (B, Sk, KV, hd) in place.  k and v are projected from ``xkv`` (B, Sk,
    D) when it is given (cross-attention), else from x.  RoPE only with
    ``positions`` (k's at ``arange(Sk)`` under ``xkv``, as the reference).
    With the heads split over "model" the kernel runs on this rank's
    query heads and the KV heads they read, and ``wo``'s rows end in g
    (``seq_in`` / ``seq_out`` as ``mlp_apply``'s).  Returns (out, (k, v)):
    k and v with the KV heads this rank projected (``whole_kv_heads``
    gives the cache's)."""
    Hl = p["wq"].shape[-2]
    split = Hl < cfg.num_heads
    x = _enter(x, split, seq_in)
    src = x if xkv is None else (partition.tp_enter(xkv) if split else xkv)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k, v = k + _kv_bias(p["bk"], k), v + _kv_bias(p["bv"], v)
    if positions is not None:
        q = rope_apply(q, positions, cfg.rope_theta)
        kpos = positions if xkv is None else torch.arange(src.shape[1],
                                                          device=x.device)
        k = rope_apply(k, kpos, cfg.rope_theta)
    kv_cache = (k, v)
    o = ops.flash_attention(q, _heads_kv(k, cfg, Hl), _heads_kv(v, cfg, Hl),
                            causal=causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return _exit(out, split, seq_out), kv_cache


def attention_decode(p, cfg: ArchConfig, x, cache_k, cache_v, pos,
                     use_cp: bool = False):
    """Single-token decode.  x: (B, D); cache_k/v: (B, Smax, KV, hd);
    pos: (B,).  Writes this token's key and value into ``cache_k`` and
    ``cache_v`` in place at ``pos`` and returns (out (B, D), cache_k,
    cache_v).

    use_cp: context-parallel attention over the seq-sharded cache (a
    ``DTensor`` leaf under a plan scope): each rank attends to its local
    span, and the spans combine with the log-sum-exp trick (all-reduces of
    (B, H[, hd]) partials over "model").  The naive route all-gathers the
    spans instead.  With the heads split over "model" the new key and
    value are gathered to every KV head for the cache, the rank's query
    heads attend (CP: all of them, then the rank's output heads are
    kept), and ``wo``'s rows end in g."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Hl = p["wq"].shape[-2]
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    k = torch.einsum("bd,dhk->bhk", x, p["wk"])
    v = torch.einsum("bd,dhk->bhk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k, v = k + _kv_bias(p["bk"], k), v + _kv_bias(p["bv"], v)
    q = rope_apply(q, pos, cfg.rope_theta)
    k = rope_apply(k, pos, cfg.rope_theta)
    k, v = whole_kv_heads(k, KV), whole_kv_heads(v, KV)
    axis = _cp_axis(cache_k) if use_cp else None
    if axis is not None:
        qa = q if Hl == H else partition.tp_gather(q, 1)
        o = _decode_attend_cp(cfg, qa, k, v, cache_k, cache_v, pos, axis)
        if Hl < H:
            o = o.narrow(1, partition.tp_rank() * Hl, Hl)
    else:
        ck, cv = partition.rows_of(cache_k), partition.rows_of(cache_v)
        rows = torch.arange(x.shape[0], device=x.device)
        at = pos.to(torch.long)
        ck[rows, at] = k.to(ck.dtype)
        cv[rows, at] = v.to(cv.dtype)
        o = ops.decode_attention(q, rank_kv(ck, H, KV, Hl),
                                 rank_kv(cv, H, KV, Hl), pos)
        partition.store_rows(cache_k, ck)
        partition.store_rows(cache_v, cv)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return _exit(out, Hl < H, False), cache_k, cache_v


def _cp_axis(cache_k):
    """The mesh axis that splits a decode cache leaf's seq dimension (dim
    1), as the plan resolves "cache", or None: no scope, the plan does not
    shard the cache, or the divisibility guard replicated it."""
    env = partition.ranks_env()
    if env is None or not isinstance(cache_k, DTensor):
        return None
    axis = env.resolve("cache")
    if axis is None:
        return None
    k = cache_k.device_mesh.mesh_dim_names.index(axis)
    return axis if cache_k.placements[k] == Shard(1) else None


def _decode_attend_cp(cfg, q, k_new, v_new, cache_k, cache_v, pos, axis):
    """Context-parallel decode attention: each rank holds the span
    (B_local, S/n, KV, hd) of the cache along mesh ``axis``; only the rank whose
    span holds ``pos`` writes the new key and value (in place), scores are
    masked by the global key positions, and the spans' row maxima, softmax
    denominators and outputs combine by all-reduce (MAX, then one SUM in
    float32 of the outputs with the denominators as one more column), as
    the reference's shard_map body (pmax, then psum of each)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv = cache_k.to_local(), cache_v.to_local()
    s_loc = ck.shape[1]
    start = partition.span_start(cache_k, 1, axis)
    kpos = start + torch.arange(s_loc, device=q.device)
    # the new entry, at its row's position if that lies in this span (a
    # read-modify-write with the clamped position elsewhere: no host sync)
    rows = torch.arange(q.shape[0], device=q.device)
    mine = ((pos >= start) & (pos < start + s_loc))[:, None, None]
    at = (pos.to(torch.long) - start).clamp(0, s_loc - 1)
    ck[rows, at] = torch.where(mine, k_new.to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(mine, v_new.to(cv.dtype), cv[rows, at])
    ke = _expand_kv(ck, H // KV)
    ve = _expand_kv(cv, H // KV)
    s = torch.einsum("bhk,bshk->bhs", q, ke).to(torch.float32) / math.sqrt(hd)
    mask = kpos[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    m = partition.all_reduce(torch.amax(s, dim=-1), dist.ReduceOp.MAX, axis)
    w = torch.exp(s - m[..., None])
    o = torch.einsum("bhs,bshk->bhk", w.to(q.dtype), ve).to(torch.float32)
    # the denominators ride as one more column of o: one SUM for both
    ol = partition.all_reduce(torch.cat([o, torch.sum(w, dim=-1)[..., None]],
                                        dim=-1), dist.ReduceOp.SUM, axis)
    o, l = ol[..., :-1], ol[..., -1]
    counters.count(_decode_attend_cp, "combines")
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


_decode_attend_cp.combines = 0


def cp_combines() -> int:
    """Context-parallel combines since the last ``reset_cp_combines``:
    one a layer of a decode step that took the CP route."""
    return _decode_attend_cp.combines


def reset_cp_combines() -> None:
    counters.reset([(_decode_attend_cp, "combines")])


# --------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# --------------------------------------------------------------------------

def init_mla(gen, cfg: ArchConfig, dtype, *, device, lead=()):
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    nope, rd, vd, R = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                       m.kv_lora_rank)
    return {
        "wq": _dense_init(gen, lead + (D, H, nope + rd), D, dtype, device),
        "wkv_a": _dense_init(gen, lead + (D, R + rd), D, dtype, device),
        "kv_norm": _ones(lead + (R,), dtype, device),
        "wkv_b": _dense_init(gen, lead + (R, H, nope + vd), R, dtype, device),
        "wo": _dense_init(gen, lead + (H, vd, D), H * vd, dtype, device),
    }


def mla_apply(p, cfg: ArchConfig, x, positions, *, seq_in=False,
              seq_out=False):
    """MLA over the full sequence (prefill, training), naive expansion, on
    the flash kernel with v at its own width, a view of ``kv``.  With the heads
    split over "model" (``wq``, ``wkv_b``, ``wo``) the kernel runs on this
    rank's heads and ``wo``'s rows end in g; the latent path (``wkv_a``,
    ``kv_norm``) is computed whole on every rank.  Returns (out, (c_kv
    (B, S, R), k_rope (B, S, rd)))."""
    m = cfg.mla
    nope, R = m.qk_nope_head_dim, m.kv_lora_rank
    split = p["wq"].shape[-2] < cfg.num_heads
    x = _enter(x, split, seq_in)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q = torch.cat([q[..., :nope],
                   rope_apply(q[..., nope:], positions, cfg.rope_theta)], -1)
    a = torch.einsum("bsd,dk->bsk", x, p["wkv_a"])
    c_kv = rms_norm(a[..., :R], p["kv_norm"], cfg.norm_eps)
    k_rope = rope_apply(a[..., R:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    kv = torch.einsum("bsk,khj->bshj", c_kv, p["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], k_rope.shape[-1])], -1)
    o = ops.flash_attention(q, k, v, causal=True)
    out = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    return _exit(out, split, seq_out), (c_kv, k_rope)


def mla_decode(p, cfg: ArchConfig, x, cache_c, cache_kr, pos):
    """Absorbed MLA decode: attend in the latent space (KV never expanded).
    x: (B, D); cache_c: (B, Smax, R); cache_kr: (B, Smax, rd); pos: (B,).
    Writes this token's ``c`` and ``kr`` rows in place at ``pos`` and
    returns (out (B, D), cache_c, cache_kr).  MLA has no context-parallel
    route (neither has the reference's): under a mesh the spans are
    gathered and the rank's own written back.  With the heads split over
    "model" the rank attends on its heads (the latent rows, computed whole
    on every rank, are the same everywhere) and ``wo``'s rows end in g."""
    c_all, kr_all = partition.rows_of(cache_c), partition.rows_of(cache_kr)
    m = cfg.mla
    nope, rd, R = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    q_nope = q[..., :nope]
    q_rope = rope_apply(q[..., nope:], pos, cfg.rope_theta)
    a = torch.einsum("bd,dk->bk", x, p["wkv_a"])
    c_new = rms_norm(a[..., :R], p["kv_norm"], cfg.norm_eps)
    kr_new = rope_apply(a[:, None, R:], pos, cfg.rope_theta)[:, 0]
    rows = torch.arange(x.shape[0], device=x.device)
    at = pos.to(torch.long)
    c_all[rows, at] = c_new.to(c_all.dtype)
    kr_all[rows, at] = kr_new.to(kr_all.dtype)
    wb_k = p["wkv_b"][..., :nope]                        # (R, H, nope)
    wb_v = p["wkv_b"][..., nope:]                        # (R, H, vd)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, wb_k)   # (B, H, R)
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_all)
         + torch.einsum("bhk,bsk->bhs", q_rope, kr_all)).to(torch.float32)
    s = s / math.sqrt(nope + rd)
    mask = torch.arange(c_all.shape[1], device=x.device)[None, :] \
        <= pos[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", w, c_all)       # (B, H, R)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wb_v)        # (B, H, vd)
    out = torch.einsum("bhv,hvd->bd", o, p["wo"])
    partition.store_rows(cache_c, c_all)
    partition.store_rows(cache_kr, kr_all)
    return _exit(out, p["wq"].shape[-2] < cfg.num_heads, False), cache_c, \
        cache_kr


# --------------------------------------------------------------------------
# the vocabulary (split over "model" on the embedding's and head's rows)
# --------------------------------------------------------------------------

def embed(emb, tokens, vocab: int):
    """The embedding rows of ``tokens``.  With the rows split over "model"
    (``emb`` narrower than ``vocab``): a lookup in this rank's range, zero
    elsewhere, summed over the ranks (g); exactly one rank gives a row
    other than zero, so the sum is the whole lookup, bit for bit."""
    tok = tokens.to(torch.long)
    Vl = emb.shape[0]
    if Vl == vocab:
        return emb[tok]
    local = tok - partition.tp_rank() * Vl
    mine = ((local >= 0) & (local < Vl))[..., None]
    rows = emb[local.clamp(0, Vl - 1)]
    return partition.tp_exit(torch.where(mine, rows, torch.zeros_like(rows)))


def vocab_logits(x, head, vocab: int):
    """Float32 logits of x (..., D) over the whole vocabulary: this rank's
    columns gathered over "model" where ``head`` is split."""
    logits = torch.einsum("...d,vd->...v", x, head).to(torch.float32)
    return logits if head.shape[0] == vocab else \
        partition.tp_gather(logits, logits.ndim - 1)


def greedy(x, head, vocab: int):
    """The argmax token (int32) of x (B, D)'s logits.  With ``head`` split
    over "model", each rank offers its columns' (max, global index) and
    the largest wins, ties to the lower index (``torch.argmax``'s rule),
    with no logits gathered."""
    logits = torch.einsum("bd,vd->bv", x, head).to(torch.float32)
    i = torch.argmax(logits, dim=-1)
    if head.shape[0] == vocab:
        return i.to(torch.int32)
    m = torch.gather(logits, -1, i[:, None])
    offer = torch.cat([m.to(torch.float64),
                       (i[:, None] + partition.tp_rank() * head.shape[0])
                       .to(torch.float64)], dim=-1)[:, None, :]
    offers = partition.tp_gather(offer, 1)               # (B, ranks, 2)
    best = torch.argmax(offers[..., 0], dim=-1)
    return torch.gather(offers[..., 1], -1, best[:, None])[:, 0] \
        .to(torch.int32)
