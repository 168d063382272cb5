"""mamba2-370m — attention-free SSM with state-space duality (SSD) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                 # no MLP: mamba2 blocks only
    vocab_size=50280,
    head_dim=64,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
