"""repro_torch.checkpoint — npz-based save/restore with an async writer."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
