"""glm4-9b — dense GQA LM with tiny KV (kv=2), RoPE [hf:THUDM/glm-4-9b].

GLM-4 uses partial-rotary attention and post-norm quirks in the reference
implementation; we keep the standard pre-norm RoPE decoder here and note the
simplification (attention/KV geometry — the part that matters for sharding and
roofline — matches the assignment exactly).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    qkv_bias=False,
    rope_theta=1e6,
    source="hf:THUDM/glm-4-9b",
    notes="partial-rotary + ffn gating simplified to standard pre-norm SwiGLU",
)
