"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers; a SHARED transformer block (full MHA kv=32 + SwiGLU ff=14336)
is applied every ``attn_period`` backbone layers with per-invocation LoRA
deltas, following the Zamba2 parameter-sharing scheme.  head_dim = 3584/32 = 112.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=128),
    attn_period=6,
    shared_lora_rank=64,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-7B",
)
