"""Architecture / run / plan configuration dataclasses.

``ArchConfig`` describes a model architecture exactly as assigned (full-size
production config).  ``smoke()`` derives a reduced config of the same family
for CPU tests.  ``ShapeConfig`` describes one input-shape cell (train/prefill/
decode/long-context-decode).  ``PlanConfig`` is a *tensor plan* — the
polystore "engine" choice for a compiled step: sharding regime, remat policy,
accumulation, attention implementation.  In the reference, plans are
enumerated/selected by ``repro.core.tensorplan`` using the BigDAWG
planner/monitor protocol; the port has no tensor planner yet (ROADMAP.md
queue 1, launch tooling and tensor plans) and serves with the defaults.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # ff dim of each routed expert
    d_ff_shared: int = 0            # ff dim of the shared-expert path (total)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0     # leading layers that use a dense MLP
    d_ff_dense: int = 0             # ff dim of those dense layers
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int                  # N
    head_dim: int = 64              # P
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128                # SSD chunk length


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no q compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (zamba2-style): a shared attention block every `attn_period`
    # backbone layers, with per-invocation LoRA deltas of rank `shared_lora_rank`.
    attn_period: int = 0
    shared_lora_rank: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
    num_frontend_tokens: int = 0    # patches / audio frames folded into the seq
    # bookkeeping
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling: SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (seamless is enc-dec)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model-flops)."""
        from repro_torch.models.api import count_params  # local import, no cycle at module load
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.api import count_params
        return count_params(self, active_only=True)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family != "hybrid" else 7),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            encoder_layers=2 if self.encoder_layers else 0,
            num_frontend_tokens=8 if self.frontend else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                d_ff_shared=(64 if self.moe.num_shared_experts else 0),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=(128 if self.moe.first_dense_layers else 0))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=8)
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
        if self.attn_period:
            kw["attn_period"] = 3
            kw["shared_lora_rank"] = 8
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Input-shape cells (assigned shape set for the LM family)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    mode: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, ("skip: pure full-attention family is quadratic at 500k "
                       "context (assignment: run long_500k only for SSM/hybrid)")
    return True, ""


# --------------------------------------------------------------------------
# Tensor plans — the polystore "engine" for a compiled step
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanConfig:
    name: str = "baseline"
    fsdp: bool = True               # shard params' d_model dim over DP axes
    tp: bool = True                 # Megatron TP over the "model" axis
    sp_boundary: bool = True        # shard remat-boundary activations on seq over "model"
    sp_residual: bool = False       # Megatron sequence-parallelism: constrain
                                    # BOTH residual sums to seq-sharded, so TP
                                    # all-reduces lower as reduce-scatter +
                                    # all-gather (half the ring bytes)
    accum: int = 1                  # gradient-accumulation microbatch count
    remat: str = "block"            # none | block
    attn_chunk: int = 1024          # query-chunked attention block size
    loss_chunk: int = 1024          # seq chunk for the vocab-sharded loss
    moe_ep: bool = True             # shard experts over "model" when divisible
    moe_group_size: int = 4096      # sequence-chunked MoE dispatch (0 = off):
                                    # dispatch buffers (E*C tokens ~ 2.5x
                                    # activations) live one chunk at a time
    cache_seq_shard: bool = True    # shard decode KV cache on seq over "model"
    decode_cp: bool = False         # context-parallel decode attention via
                                    # shard_map + log-sum-exp combine: ~(B,H)
                                    # partials instead of all-gathering the
                                    # seq-sharded cache (2.2 GB/layer measured)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    master_dtype: str = "float32"
    moment_dtype: str = "float32"
    grad_compression: str = "none"  # none | int8_ef
    pipeline_stages: int = 1        # >1: GPipe over the "pod" axis (multi-pod)
    # dry-run cost accounting: cost_analysis counts a lax.scan body ONCE and
    # does NOT scale by trip count, so cost-probe compiles unroll every inner
    # loop (attention chunks, loss chunks, grad accumulation, SSD chunks) AND
    # the layer stacks into python loops at reduced probe depths (L1=1, L2=2),
    # then extrapolate linearly in depth.  Production programs keep lax.scan.
    unroll_inner: bool = False
    unroll_layers: bool = False

    def with_(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)
