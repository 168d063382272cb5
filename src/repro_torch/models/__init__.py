"""LM models of the port: the dense/GQA transformer and the Mamba2 SSM LM
behind ``repro_torch.models.api`` (the serving part of ``repro.models``)."""
