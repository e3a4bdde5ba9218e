"""Per-arch training knobs of the launcher and the GNN shape adapters
(mirrors the parts of :mod:`repro.configs.cells` that a run on one card
reads: ``LM_ACCUM``, ``OPT_CFG``, ``_gnn_model``, ``gnn_shape_config``,
``_pad_div``).

The reference's module also builds the dry-run cells (arch × shape →
a lowerable step with its shardings, ``gnn_batch_shapes`` among them);
those come with the sharding and launch tooling, ROADMAP A14e.
"""
from __future__ import annotations

import dataclasses

from repro_torch.optim.adamw import AdamWConfig

# microbatch accumulation per LM arch (activation-memory fit)
LM_ACCUM = {
    "glm4-9b": 8,
    "qwen2-7b": 8,
    "qwen3-0.6b": 2,
    "granite-moe-3b-a800m": 4,
    "olmoe-1b-7b": 4,
}

OPT_CFG = AdamWConfig(lr=3e-4)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_model(arch):
    if arch.name == "gcn-cora":
        from repro_torch.models.gnn import gcn as mod
    elif arch.name == "pna":
        from repro_torch.models.gnn import pna as mod
    elif arch.name == "nequip":
        from repro_torch.models.gnn import nequip as mod
    else:
        from repro_torch.models.gnn import equiformer_v2 as mod
    return mod


def gnn_shape_config(arch, sspec):
    """Adapt the arch config to a cell: io dims + task come from the shape."""
    cfg = arch.config
    d = sspec.dims
    geometric = arch.name in ("nequip", "equiformer-v2")
    if sspec.name == "molecule":
        task = "graph_reg"
        n_classes = 1
        d_in = 16
    else:
        task = "node_class"
        n_classes = d["n_classes"]
        d_in = d.get("d_feat", 16)
    if geometric:
        return dataclasses.replace(cfg, n_classes=n_classes, task=task)
    return dataclasses.replace(cfg, d_in=d_in, n_classes=n_classes, task=task)


def _pad_div(x: int, mult: int = 32) -> int:
    """Pad a sharded dim to the mesh-divisibility multiple (pod·data = 32
    covers both production meshes); padding rows/edges are mask-zeroed by
    the data pipeline, exactly like sampler padding."""
    return ((x + mult - 1) // mult) * mult
