"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model 6144, 48H GQA kv=8, expert ff 32768, vocab 131072.  With 8
experts and a 16-wide model axis, experts are TP-sharded on d_ff rather than
EP-sharded (8 ∤ 16) — see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0,
                  d_ff_expert=32768, capacity_factor=1.25),
    source="hf:xai-org/grok-1",
)
