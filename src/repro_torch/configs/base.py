"""ArchDef container + per-family shape tables (from the assignment)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | pipeline
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str  # lm | gnn | recsys | spectral
    config: Any
    smoke_config: Any
    sub_quadratic: bool = False  # long_500k applicability (LM family)
    notes: str = ""

    @property
    def shapes(self) -> Dict[str, ShapeSpec]:
        return SHAPES[self.family]


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg",
        "train",
        {
            "n_nodes": 232965,
            "n_edges": 114615892,
            "batch_nodes": 1024,
            "fanout0": 15,
            "fanout1": 10,
            "d_feat": 602,  # reddit-scale features (assignment leaves d_feat to the dataset)
            "n_classes": 41,
        },
    ),
    "ogb_products": ShapeSpec(
        "ogb_products",
        "train",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100, "n_classes": 47},
    ),
    "molecule": ShapeSpec(
        "molecule", "train", {"n_nodes": 30, "n_edges": 64, "batch": 128}
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
}

# the paper's own datasets (Table II) as shapes for the spectral pipeline
SPECTRAL_SHAPES = {
    "dti": ShapeSpec("dti", "pipeline", {"n_nodes": 142541, "n_edges": 2 * 3992290, "k": 500}),
    "fb": ShapeSpec("fb", "pipeline", {"n_nodes": 4039, "n_edges": 2 * 88234, "k": 10}),
    "dblp": ShapeSpec("dblp", "pipeline", {"n_nodes": 317080, "n_edges": 2 * 1049866, "k": 500}),
    "syn200": ShapeSpec("syn200", "pipeline", {"n_nodes": 20000, "n_edges": 2 * 773388, "k": 200}),
}

SHAPES = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
    "spectral": SPECTRAL_SHAPES,
}
