"""internlm2-1.8b — dense GQA LM [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    qkv_bias=False,
    rope_theta=1e6,
    source="arXiv:2403.17297; hf:internlm/internlm2-1_8b",
)
