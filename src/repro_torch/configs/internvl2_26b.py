"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone [arXiv:2404.16821].

Per the assignment, the modality frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, num_frontend_tokens, d_model)
which are concatenated ahead of the text tokens.  Only the transformer backbone
is modeled (48L / 6144 / 48H GQA kv=8 / ff 16384 / vocab 92553).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1e6,
    frontend="vision",
    num_frontend_tokens=256,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)
