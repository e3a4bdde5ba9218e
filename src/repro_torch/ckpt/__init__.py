"""Crash-consistent checkpoints of flat name → array dicts (mirrors
:mod:`repro.ckpt`; elastic resharding is ROADMAP A14)."""

from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
