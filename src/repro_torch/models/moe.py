"""Mixture-of-Experts layer with capacity-factor dispatch: the port of
``repro.models.moe``.

Routing is group-limited, as in the reference: tokens route within a group
(one sequence in training and prefill, all the slots in decode).  A float32
router and softmax give each token its top-k experts, whose weights are
renormalized over those k; each expert then takes its top-C tokens of the
group by combine weight (C = ``_capacity(T)``), and tokens past capacity are
dropped (they keep the residual path).  Both top-k selections are a stable
descending sort, so that equal weights go to the lower index first, as
``lax.top_k`` orders them.

Dispatch and combine use no scatter: the slot -> token inverse comes from a
stable argsort over the slots and ``searchsorted`` (left), as in the
reference, with zero-weight slots pointed at token T so that they sort
last.  The expert products are ``torch.einsum`` over the expert axis (the
reference leaves them to XLA, outside any Pallas kernel); the SiLU gate and
the weighted sum over k are in float32.  The reference's sharding
constraints (``pcon``) are dropped: activations are each rank's local
tensors (``models.partition``).  Under a scope that splits the compute
over "model" the router and both top-k selections run whole on every
rank (the same routing everywhere), and the experts follow
``specs._expert_rule``: under ``ep`` the rank computes its E/tp experts'
outputs, which are all-gathered over "model" before the combine (so the
combine sums in the single device's order); otherwise the rank holds a
``d_ff`` slice of every expert, and the combine of its partial outputs
ends in g.  The shared experts are the split MLP.

Under a profiler the layer's phases are regions (``core.tracing.region``:
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.shared``), and every call counts, from shapes alone, the rows its
experts compute (groups x the rank's experts x C) and the rows routed
(groups x tokens x k) in ``kernels.counters.LM_WORK``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.tracing import region
from repro_torch.kernels import counters
from repro_torch.models import partition
from repro_torch.models.layers import _dense_init, init_mlp, mlp_apply


def init_moe(gen, cfg: ArchConfig, dtype, *, device, lead=()):
    """Router (float32, as the reference's), routed experts ``we1``/``we3``
    (E, D, F) and ``we2`` (E, F, D), and the shared experts' MLP."""
    m: MoEConfig = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {
        "router": _dense_init(gen, lead + (D, E), D, torch.float32, device),
        "we1": _dense_init(gen, lead + (E, D, Fe), D, dtype, device),
        "we3": _dense_init(gen, lead + (E, D, Fe), D, dtype, device),
        "we2": _dense_init(gen, lead + (E, Fe, D), Fe, dtype, device),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, D, m.d_ff_shared, dtype, device, lead)
    return p


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                  / m.num_experts)
    return max(1, min(c, tokens_per_group))


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    lower index first (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_apply(p, cfg: ArchConfig, x, *, group_size: int = 0):
    """x: (B, S, D), or (B, D) in decode (one group of all B slots).
    Returns (out, aux loss).  ``group_size`` > 0 routes the sequence in
    chunks of that many tokens when it divides S (the reference's
    ``lax.scan``), the aux loss averaged over the chunks."""
    m: MoEConfig = cfg.moe
    decode = x.ndim == 2
    if not decode and group_size and x.shape[1] > group_size \
            and x.shape[1] % group_size == 0:
        nc = x.shape[1] // group_size
        aux, ys = torch.zeros((), dtype=torch.float32, device=x.device), []
        for xc in x.split(group_size, dim=1):
            yc, a = moe_apply(p, cfg, xc)
            aux = aux + a
            ys.append(yc)
        return torch.cat(ys, dim=1), aux / nc

    xg = x[None] if decode else x                        # (G, T, D)
    G, T, D = xg.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(T, m)
    dev = x.device
    counters.add(counters.LM_WORK, "moe_rows_computed",
                 G * p["we1"].shape[-3] * C)
    counters.add(counters.LM_WORK, "moe_rows_routed", G * T * K)

    with region("moe.route"):
        logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                              p["router"])
        probs = torch.softmax(logits, dim=-1)            # (G, T, E)
        topw, topi = _top_k(probs, K)                    # (G, T, K)
        topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)

        # per-token-per-expert combine weight (0 if the expert is not in
        # the token's top-k)
        onehot = F.one_hot(topi, E).to(torch.float32)    # (G, T, K, E)
        tok_w = torch.einsum("gtk,gtke->gte", topw, onehot)  # (G, T, E)

    with region("moe.dispatch"):
        # each expert picks its top-C tokens in the group by combine weight
        ex_w, ex_idx = _top_k(tok_w.transpose(1, 2), C)  # (G, E, C)
        groups = torch.arange(G, device=dev)[:, None, None]
        xe = xg[groups, ex_idx]                          # (G, E, C, D)

    # the experts split over "model": whole ones (ep) or d_ff slices
    ep = p["we1"].shape[-3] < E
    ff = p["we1"].shape[-1] < m.d_ff_expert
    with region("moe.experts"):
        if ep:
            xe = partition.tp_split(xe, 1)               # this rank's experts
        elif ff:
            xe = partition.tp_enter(xe)
        h = torch.einsum("gecd,edf->gecf", xe, p["we1"])
        gt = torch.einsum("gecd,edf->gecf", xe, p["we3"])
        h = F.silu(gt.to(torch.float32)).to(xe.dtype) * h
        ye = torch.einsum("gecf,efd->gecd", h, p["we2"])  # (G, E, C, D)
        if ep:
            ye = partition.tp_gather(ye, 1)

    with region("moe.combine"):
        # scatter-free combine: the slots sorted by token, zero-weight
        # slots pointed at token T (past every real one)
        flat_tok = torch.where(ex_w > 0, ex_idx,
                               torch.full_like(ex_idx, T)).reshape(G, E * C)
        flat_w = ex_w.reshape(G, E * C).to(torch.float32)
        if ff:        # the combine of partial outputs: a split region
            flat_w = partition.tp_enter(flat_w)
        order = torch.argsort(flat_tok, dim=1, stable=True)  # (G, EC)
        sorted_tok = torch.gather(flat_tok, 1, order)
        tokens = torch.arange(T, device=dev)
        base = torch.searchsorted(sorted_tok,
                                  tokens.expand(G, T).contiguous())
        pos = torch.clamp(base[..., None] + torch.arange(K, device=dev),
                          0, E * C - 1).reshape(G, T * K)
        cand = torch.gather(sorted_tok, 1, pos).reshape(G, T, K)
        valid = cand == tokens[None, :, None]            # (G, T, K)
        slot = torch.gather(order, 1, pos)               # (G, T*K)
        w = torch.gather(flat_w, 1, slot).reshape(G, T, K) * valid
        yk = torch.gather(ye.reshape(G, E * C, D), 1,
                          slot[..., None].expand(G, T * K, D)
                          ).reshape(G, T, K, D)
        out = torch.sum(yk.to(torch.float32) * w[..., None], dim=2)
        if ff:
            out = partition.tp_exit(out)
        out = out.to(x.dtype)

    # Switch-style load-balance aux loss
    frac_tokens = torch.mean(torch.sum(onehot, dim=2), dim=1)   # (G, E)
    frac_probs = torch.mean(probs, dim=1)                       # (G, E)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    if m.num_shared_experts:
        with region("moe.shared"):
            out = out + mlp_apply(p["shared"], xg,
                                  m.d_ff_shared).to(out.dtype)
    if decode:
        out = out[0]
    return out, aux
