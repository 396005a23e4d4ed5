from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
