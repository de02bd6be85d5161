"""Fault-tolerant checkpointing with NUMARCK temporal compression."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
