"""Architecture registry (mirrors :mod:`repro.configs`): the five LM archs of
the model zoo and the paper's own pipeline.

``ARCHS`` maps arch id → :class:`repro_torch.configs.base.ArchDef`.  The GNN
and recsys archs (equiformer-v2, pna, nequip, gcn-cora, autoint) join with
their models (ROADMAP A14c, A14d).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchDef

_MODULES = [
    "glm4_9b",
    "qwen2_7b",
    "qwen3_0p6b",
    "granite_moe_3b_a800m",
    "olmoe_1b_7b",
    "spectral",
]


def _load() -> dict:
    import importlib

    out = {}
    for m in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        out[mod.ARCH.name] = mod.ARCH
    return out


ARCHS: dict = _load()

ASSIGNED = [a for a in ARCHS.values() if a.name != "spectral"]
