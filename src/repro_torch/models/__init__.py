"""LM models of the port: the dense/GQA and MoE transformer, the
vision-language model over it, the Mamba2 SSM LM, the Mamba2 /
shared-attention hybrid and the encoder-decoder behind
``repro_torch.models.api`` (the serving and training part of
``repro.models``)."""
