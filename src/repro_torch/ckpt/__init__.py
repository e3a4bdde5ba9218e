"""Crash-consistent checkpoints of parameter and state trees (mirrors
:mod:`repro.ckpt`; elastic resharding, ``reshard_tree``, is ROADMAP A14e)."""

from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
