"""Architecture registry (mirrors :mod:`repro.configs`): the 10 assigned
archs — five LMs, four GNNs, AutoInt — and the paper's own pipeline.

``ARCHS`` maps arch id → :class:`repro_torch.configs.base.ArchDef`, in the
reference's order; ``configs.cells`` holds the launcher's training knobs,
the GNN shape adapters and the dry-run cells.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchDef

_MODULES = [
    "glm4_9b",
    "qwen2_7b",
    "qwen3_0p6b",
    "granite_moe_3b_a800m",
    "olmoe_1b_7b",
    "equiformer_v2",
    "pna",
    "nequip",
    "gcn_cora",
    "autoint",
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
