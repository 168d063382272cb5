"""Model FLOPs from a configuration's published keys (a multiply-add is
two): the numerators of ``train_mfu`` and ``prefill_mfu``.

Every matrix product of the model counts, the output head included; an
embedding lookup counts none.  A mixture of experts counts its active
experts only (``num_experts_per_tok`` routed and ``n_shared_experts``
shared) and its router.  Attention counts the query-key pairs that the
causal mask keeps, a multiply-add a pair and width in q·kᵀ and in P·v.
Training is three times the forward (forward, and the backward's two
products a product), and the recompute of block remat is not counted.
A prefill computes the logits of its last row only.
"""
from __future__ import annotations

from harness.work import pairs


def attention_dims(cfg: dict) -> tuple:
    """(query heads, KV heads, q/k width, v width)."""
    H = cfg["num_attention_heads"]
    if "kv_lora_rank" in cfg:
        return (H, H, cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                cfg["v_head_dim"])
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    return H, cfg["num_key_value_heads"], hd, hd


def _attention_params(cfg: dict) -> int:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if "kv_lora_rank" in cfg:
        R, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
        rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        if cfg.get("q_lora_rank"):
            raise ValueError("no formula for a compressed query")
        return (D * H * (nope + rope) + D * (R + rope)
                + R * H * (nope + vd) + H * vd * D)
    _, KV, hd, _ = attention_dims(cfg)
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def _ffn_params(cfg: dict, layer: int) -> int:
    D = cfg["hidden_size"]
    E = cfg.get("n_routed_experts")
    if E and layer >= cfg.get("first_k_dense_replace", 0):
        ff = cfg["moe_intermediate_size"]
        experts = cfg["num_experts_per_tok"] + cfg.get("n_shared_experts", 0)
        return D * E + experts * 3 * D * ff
    return 3 * D * cfg["intermediate_size"]


def layer_params(cfg: dict) -> int:
    """Active matrix-product parameters of all the layers (no head)."""
    return sum(_attention_params(cfg) + _ffn_params(cfg, i)
               for i in range(cfg["num_hidden_layers"]))


def head_params(cfg: dict) -> int:
    return cfg["vocab_size"] * cfg["hidden_size"]


def attention_forward(cfg: dict, seq: int) -> float:
    """FLOPs of the causal attention of one sequence, every layer."""
    H, _, dqk, dv = attention_dims(cfg)
    return (cfg["num_hidden_layers"] * 2.0 * H * (dqk + dv)
            * pairs(seq, seq, True))


def train_step(cfg: dict, batch: int, seq: int) -> float:
    n = layer_params(cfg) + head_params(cfg)
    return 6.0 * n * batch * seq + 3.0 * batch * attention_forward(cfg, seq)


def prefill(cfg: dict, length: int) -> float:
    return (2.0 * layer_params(cfg) * length + 2.0 * head_params(cfg)
            + attention_forward(cfg, length))
