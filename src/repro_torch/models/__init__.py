"""LM models of the port: the dense/GQA and MoE transformer, the Mamba2
SSM LM and the Mamba2 / shared-attention hybrid behind
``repro_torch.models.api`` (the serving and training part of
``repro.models``)."""
