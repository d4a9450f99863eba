# Checkpoints on the JAX package's disk format (manager.py).
from repro_torch.checkpoint.manager import CheckpointManager, Layout, snapshot

__all__ = ["CheckpointManager", "Layout", "snapshot"]
