"""A plain PyTorch reference of the decoder-only transformers the benchmark
runs: GQA attention with a SwiGLU MLP (internlm2), and multi-head latent
attention with a mixture of experts (DeepSeek-V2).

It reads the model's sizes from the configuration's published keys and
its weights from the tree that the benchmark makes from the seed (the
layout below), checks every shape against the keys, and computes in
float32 with TF32 off: no kernel, cache or batching.  It imports nothing
of the program.  ``precision="fp8"`` is the control: the input of every
linear layer and the output head is rounded to float8 e4m3, activations
with a scale a row and weights a scale an output column (the router and
attention's products stay float32).

The weight tree: ``emb`` and ``head`` (rows, d), ``final_norm``; the
layers as ``blocks`` (and a MoE model's leading dense layers as
``prefix_blocks``), every leaf stacked on a leading layer axis, each with
``ln1``, ``ln2``, ``attn`` (GQA: ``wq`` (d, H, hd), ``wk`` and ``wv``
(d, KV, hd), ``wo`` (H, hd, d); MLA: ``wq`` (d, H, nope + rope),
``wkv_a`` (d, R + rope), ``kv_norm`` (R,), ``wkv_b`` (R, H, nope + v),
``wo`` (H, v, d)), and ``mlp`` (``w1``, ``w3`` (d, ff), ``w2`` (ff, d))
or ``moe`` (``router`` (d, E), ``we1``, ``we3`` (E, d, ff), ``we2``
(E, ff, d), ``shared``: an MLP of the shared experts side by side).

Departures from the published models, which the program makes too: the
vocabulary is the head's rows (the program pads it to a multiple of 256,
and the padded rows are weights like the others); RoPE rotates by halves
(the published checkpoints order the rotary columns otherwise, a
permutation of random weights); the MLP's gate is ``w3``.  What a
configuration's file lists under ``changed`` (DeepSeek's routing weights
renormalised over the top k, its plain RoPE) is read from its keys.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0


@dataclass(frozen=True)
class Spec:
    d: int
    layers: int
    heads: int
    vocab: int
    eps: float
    theta: float
    kv_heads: int = 0
    head_dim: int = 0
    ff: int = 0
    mla: Optional[tuple] = None       # (R, nope, rope, v)
    moe: Optional[tuple] = None       # (E, K, shared, ff, dense layers,
                                      #  dense ff, renormalise)


def spec(cfg: dict) -> Spec:
    scaling = cfg.get("rope_scaling")
    # YaRN at factor 1 (or below) is plain RoPE: its interpolated
    # frequencies equal the extrapolated ones and every mscale is 1
    if scaling and not (scaling.get("type") == "yarn"
                        and scaling.get("factor", 1) <= 1):
        raise ValueError("the reference has no rope scaling")
    H, D = cfg["num_attention_heads"], cfg["hidden_size"]
    mla = moe = None
    if "kv_lora_rank" in cfg:
        if cfg.get("q_lora_rank"):
            raise ValueError("the reference has no compressed query")
        mla = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
               cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    if cfg.get("n_routed_experts"):
        if cfg.get("scoring_func", "softmax") != "softmax" or \
                cfg.get("routed_scaling_factor", 1) != 1 or \
                cfg.get("moe_layer_freq", 1) != 1:
            raise ValueError("the reference routes by softmax, unscaled, "
                             "in every layer after the dense ones")
        moe = (cfg["n_routed_experts"], cfg["num_experts_per_tok"],
               cfg.get("n_shared_experts", 0), cfg["moe_intermediate_size"],
               cfg.get("first_k_dense_replace", 0), cfg["intermediate_size"],
               bool(cfg.get("norm_topk_prob")))
    return Spec(d=D, layers=cfg["num_hidden_layers"], heads=H,
                vocab=cfg["vocab_size"], eps=cfg["rms_norm_eps"],
                theta=float(cfg["rope_theta"]),
                kv_heads=cfg.get("num_key_value_heads", H),
                head_dim=cfg.get("head_dim") or D // H,
                ff=cfg["intermediate_size"], mla=mla, moe=moe)


@contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

def _fp8(t, dim: int):
    """t rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax over ``dim``), back in float32; the gradient passes straight
    through."""
    s = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) \
        / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach()) if t.requires_grad else q


def weight(w, prec: str):
    """A (in, out) weight as the products read it."""
    w = w.to(torch.float32)
    return _fp8(w, 0) if prec == "fp8" else w


def lin(x, w, prec: str):
    """x (..., in) @ w (in, out), w already through ``weight``."""
    if prec == "fp8":
        x = _fp8(x, -1)
    return x @ w


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * w.to(torch.float32)


def rope(x, pos, theta: float):
    """x (S, heads, r): rotate each half against the other."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attend(q, k, v):
    """Causal softmax attention: q, k (S, H, dk), v (S, H, dv)."""
    S = q.shape[0]
    s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("hst,thd->shd", p, v)


def _check(t, shape, what):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, the "
                         f"configuration gives {tuple(shape)}")


def layer_weights(sp: Spec, params: dict, i: int, prec: str) -> dict:
    """Layer ``i``'s weights in float32 (and the control's rounding),
    every shape checked against the configuration."""
    n_dense = sp.moe[4] if sp.moe else 0
    stack, j = (("prefix_blocks", i) if i < n_dense and
                "prefix_blocks" in params else ("blocks", i - n_dense))
    p = params[stack]
    D, H = sp.d, sp.heads
    a = p["attn"]
    w = {"ln1": p["ln1"][j], "ln2": p["ln2"][j]}
    if sp.mla:
        R, nope, rd, vd = sp.mla
        _check(a["wq"][j], (D, H, nope + rd), "wq")
        _check(a["wkv_a"][j], (D, R + rd), "wkv_a")
        _check(a["wkv_b"][j], (R, H, nope + vd), "wkv_b")
        _check(a["wo"][j], (H, vd, D), "wo")
        w.update(wq=weight(a["wq"][j].reshape(D, -1), prec),
                 wkv_a=weight(a["wkv_a"][j], prec), kv_norm=a["kv_norm"][j],
                 wkv_b=weight(a["wkv_b"][j].reshape(R, -1), prec),
                 wo=weight(a["wo"][j].reshape(H * vd, D), prec))
    else:
        KV, hd = sp.kv_heads, sp.head_dim
        _check(a["wq"][j], (D, H, hd), "wq")
        _check(a["wk"][j], (D, KV, hd), "wk")
        _check(a["wv"][j], (D, KV, hd), "wv")
        _check(a["wo"][j], (H, hd, D), "wo")
        w.update({k: weight(a[k][j].reshape(D, -1), prec)
                  for k in ("wq", "wk", "wv")})
        w["wo"] = weight(a["wo"][j].reshape(H * hd, D), prec)
        if "bq" in a:
            w.update(bq=a["bq"][j], bk=a["bk"][j], bv=a["bv"][j])
    if sp.moe and i >= n_dense:
        E, K, shared, ff = sp.moe[:4]
        m = p["moe"]
        _check(m["router"][j], (D, E), "router")
        _check(m["we1"][j], (E, D, ff), "we1")
        _check(m["we2"][j], (E, ff, D), "we2")
        w["router"] = m["router"][j].to(torch.float32)
        w["experts"] = [tuple(weight(m[k][j][e], prec)
                              for k in ("we1", "we3", "we2"))
                        for e in range(E)]
        if shared:
            _check(m["shared"]["w1"][j], (D, shared * ff), "shared w1")
            w["shared"] = tuple(weight(m["shared"][k][j], prec)
                                for k in ("w1", "w3", "w2"))
    else:
        ff = sp.moe[5] if sp.moe else sp.ff
        _check(p["mlp"]["w1"][j], (D, ff), "w1")
        w["mlp"] = tuple(weight(p["mlp"][k][j], prec)
                         for k in ("w1", "w3", "w2"))
    return w


def _mlp(x, ws, prec):
    w1, w3, w2 = ws
    return lin(F.silu(lin(x, w3, prec)) * lin(x, w1, prec), w2, prec)


def _moe(sp: Spec, x, w, prec):
    E, K = sp.moe[0], sp.moe[1]
    probs = torch.softmax(x @ w["router"], -1)
    topw, topi = torch.topk(probs, K, -1)
    if sp.moe[6]:
        topw = topw / topw.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel():
            y = _mlp(x[rows], w["experts"][e], prec)
            out = out.index_add(0, rows, y * topw[rows, slot][:, None])
    if "shared" in w:
        out = out + _mlp(x, w["shared"], prec)
    return out


def _attention(sp: Spec, x, w, pos, prec):
    S, H = x.shape[0], sp.heads
    if sp.mla:
        R, nope, rd, vd = sp.mla
        q = lin(x, w["wq"], prec).view(S, H, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, sp.theta)],
                      -1)
        a = lin(x, w["wkv_a"], prec)
        c = rms(a[:, :R], w["kv_norm"], sp.eps)
        kr = rope(a[:, None, R:], pos, sp.theta)
        kv = lin(c, w["wkv_b"], prec).view(S, H, nope + vd)
        k = torch.cat([kv[..., :nope], kr.expand(S, H, rd)], -1)
        o = attend(q, k, kv[..., nope:])
        return lin(o.reshape(S, H * vd), w["wo"], prec)
    KV, hd = sp.kv_heads, sp.head_dim
    q = lin(x, w["wq"], prec).view(S, H, hd)
    k = lin(x, w["wk"], prec).view(S, KV, hd)
    v = lin(x, w["wv"], prec).view(S, KV, hd)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k = rope(q, pos, sp.theta), rope(k, pos, sp.theta)
    k = torch.repeat_interleave(k, H // KV, dim=1)      # head h reads
    v = torch.repeat_interleave(v, H // KV, dim=1)      # KV head h // G
    return lin(attend(q, k, v).reshape(S, H * hd), w["wo"], prec)


def block(sp: Spec, x, w, prec: str):
    """One layer over one sequence x (S, d), float32."""
    pos = torch.arange(x.shape[0], device=x.device)
    x = x + _attention(sp, rms(x, w["ln1"], sp.eps), w, pos, prec)
    h = rms(x, w["ln2"], sp.eps)
    return x + (_moe(sp, h, w, prec) if "experts" in w
                else _mlp(h, w["mlp"], prec))


def _head(sp: Spec, params, prec):
    head = params["head"]
    if head.shape[0] < sp.vocab or head.shape[1] != sp.d:
        raise ValueError(f"head {tuple(head.shape)} for a vocabulary of "
                         f"{sp.vocab} at width {sp.d}")
    return weight(head.t(), prec)


# --------------------------------------------------------------------------
# serving: logits of whole sequences, layer by layer
# --------------------------------------------------------------------------

@torch.no_grad()
def logits_at(cfg: dict, params: dict, seqs: list, prec: str = "float32"):
    """For each (tokens (S,), first) of ``seqs``: the float32 logits over
    the head's rows at positions first..S-1, (S - first, rows).  The
    layers run one at a time over every sequence, so that one layer's
    float32 weights are held at a time."""
    sp = spec(cfg)
    with exact_float32():
        hs = [params["emb"][t.long()].to(torch.float32) for t, _ in seqs]
        for i in range(sp.layers):
            w = layer_weights(sp, params, i, prec)
            hs = [block(sp, h, w, prec) for h in hs]
            del w
        head = _head(sp, params, prec)
        return [lin(rms(h[first:], params["final_norm"], sp.eps), head, prec)
                for h, (_, first) in zip(hs, seqs)]


# --------------------------------------------------------------------------
# training: the loss, its gradient and AdamW
# --------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def loss_sum(sp: Spec, params: dict, tokens, prec: str):
    """The sum over positions of one sequence's next-token loss (the last
    position, which has no next token, left out)."""
    x = params["emb"][tokens.long()].to(torch.float32)
    for i in range(sp.layers):
        x = torch.utils.checkpoint.checkpoint(
            lambda x, i=i: block(sp, x, layer_weights(sp, params, i, prec),
                                 prec), x, use_reentrant=False)
    logits = lin(rms(x, params["final_norm"], sp.eps),
                 _head(sp, params, prec), prec)
    tgt = tokens[1:].long()
    return torch.sum(torch.logsumexp(logits[:-1], -1)
                     - logits[:-1].gather(-1, tgt[:, None])[:, 0])


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def train(cfg: dict, params: dict, batches: list, opt: dict,
          prec: str = "float32", state: Optional[dict] = None) -> dict:
    """``len(batches)`` AdamW steps from ``params`` (float32 leaves, changed
    in place): each step's loss (the mean over its rows' positions, row by
    row), each leaf's norm of the first gradient as AdamW takes it (after
    clipping), and of the leaf's change over all the steps, and each
    step's norm of the whole gradient before clipping.  ``state``
    ({"m", "v"}: trees like ``params``, read and not changed; "count": the
    steps they have taken) continues an AdamW run; without it the moments
    start at zero."""
    sp = spec(cfg)
    leaves = list(_leaves(params))
    start = [p.detach().clone() for _, p in leaves]
    if state is None:
        m = [torch.zeros_like(p) for _, p in leaves]
        v = [torch.zeros_like(p) for _, p in leaves]
        count = 0
    else:
        m = [_at(state["m"], path).to(torch.float32).clone()
             for path, _ in leaves]
        v = [_at(state["v"], path).to(torch.float32).clone()
             for path, _ in leaves]
        count = int(state["count"])
    for _, p in leaves:
        p.requires_grad_(True)
    losses, grad_norms, totals = [], None, []
    b1, b2 = opt["b1"], opt["b2"]
    with exact_float32():
        for n, tokens in enumerate(batches, start=count + 1):
            count = tokens.shape[0] * (tokens.shape[1] - 1)
            total = 0.0
            for row in tokens:
                loss = loss_sum(sp, params, row, prec) / count
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                grads = [p.grad for _, p in leaves]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                totals.append(float(norm))
                clip = opt.get("clip_norm")
                scale = min(1.0, clip / (float(norm) + 1e-9)) if clip \
                    else 1.0
                if grad_norms is None:
                    grad_norms = {".".join(path): float(
                        torch.linalg.vector_norm(g)) * scale
                        for (path, _), g in zip(leaves, grads)}
                for k, ((_, p), g) in enumerate(zip(leaves, grads)):
                    g = g * scale
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v[k].mul_(b2).add_((1 - b2) * g * g)
                    step = (m[k] / (1 - b1 ** n)) / (
                        torch.sqrt(v[k] / (1 - b2 ** n)) + opt["eps"])
                    p.sub_(opt["learning_rate"]
                           * (step + opt["weight_decay"] * p))
                    p.grad = None
    change = {".".join(path): float(torch.linalg.vector_norm(p.detach() - s))
              for (path, p), s in zip(leaves, start)}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "grad_norm": totals}
