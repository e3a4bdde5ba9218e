"""Crash-consistent checkpoints of parameter and state trees, and elastic
resharding onto a different mesh (mirrors :mod:`repro.ckpt`)."""

from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
from repro_torch.ckpt.elastic import reshard_tree  # noqa: F401
