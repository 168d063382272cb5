"""deepseek-v2-lite-16b — MoE with multi-head latent attention (MLA) [arXiv:2405.04434].

27L, d_model 2048, 16H MLA (kv_lora 512, rope 64, nope 128, v 128), vocab
102400.  MoE: 64 routed experts top-6 + 2 shared experts, expert ff 1408,
first layer dense (ff 10944).  NOTE: the assignment bracket "2 shared+160
routed" contradicts its own headline "MoE 64e top-6"; we follow 64 routed
top-6, which matches the published V2-Lite config.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # MLA: latent cache, no separate KV heads
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_ff_expert=1408, d_ff_shared=2 * 1408,
                  capacity_factor=1.25, first_dense_layers=1, d_ff_dense=10944),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
)
