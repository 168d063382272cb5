"""seamless-m4t-medium — encoder-decoder multimodal (audio frontend STUB) [arXiv:2308.11596].

12L encoder + 12L decoder, d_model 1024, 16H (kv=16), ff 4096, vocab 256206.
The speech frontend is a stub: ``input_specs()`` provides precomputed frame
embeddings (batch, seq, d_model) for the encoder; the decoder is a standard
self+cross-attention transformer over text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,              # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    frontend="audio",
    num_frontend_tokens=0,      # encoder consumes the full frame sequence
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)
