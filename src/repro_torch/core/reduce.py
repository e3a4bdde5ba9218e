"""Stage 1.5 graph reductions (mirrors :mod:`repro.core.reduce`).

Only the configs are ported so far, so that a pipeline config written by
the reference loads; the sparsify, coarsen and refine stages themselves are
ROADMAP A8 and raise ``NotImplementedError`` when run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    """Stage-1.5 edge-sampling knobs (see the reference)."""

    target_nnz_ratio: float = 0.4
    seed: int = 0
    backbone: bool = True

    def __post_init__(self):
        if not 0.0 < self.target_nnz_ratio <= 1.0:
            raise ValueError(
                f"SparsifyConfig.target_nnz_ratio must be in (0, 1], got "
                f"{self.target_nnz_ratio}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CoarsenConfig:
    """Stage-1.5 multilevel coarsening knobs (see the reference)."""

    levels: int = 1
    rounds: int = 2
    refine_steps: int = 2
    min_nodes: int = 64

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError(f"CoarsenConfig.levels must be >= 1, got {self.levels}")
        if self.rounds < 1:
            raise ValueError(f"CoarsenConfig.rounds must be >= 1, got {self.rounds}")
        if self.refine_steps < 0:
            raise ValueError(
                f"CoarsenConfig.refine_steps must be >= 0, got {self.refine_steps}")
        if self.min_nodes < 2:
            raise ValueError(
                f"CoarsenConfig.min_nodes must be >= 2, got {self.min_nodes}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
