from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
