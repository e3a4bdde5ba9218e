"""GCN (Kipf & Welling, arXiv:1609.02907) — gcn-cora assigned config
(mirrors :mod:`repro.models.gnn.gcn`).

H' = σ( D̃^{-1/2}(A+I)D̃^{-1/2} H W )  with symmetric normalization computed
from the edge index on the fly (the same normalize-by-degree op as the
paper's Laplacian stage — the substrates are shared).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import _random
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.common import dense_init
from repro_torch.models.gnn import graph as G

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    dtype: Any = torch.float32
    task: str = "node_class"  # "node_class" | "graph_reg"


def init_params(cfg: GCNConfig, gen: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, drawn on ``device`` (the card unless
    the caller asks for the CPU) from the counter-based stream keyed by one
    draw of ``gen``."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {
        "w": [dense_init(stream, dims[i], dims[i + 1], cfg.dtype, device=dev)
              for i in range(cfg.n_layers)],
        "b": [torch.zeros((dims[i + 1],), dtype=cfg.dtype, device=dev)
              for i in range(cfg.n_layers)],
        "readout": dense_init(stream, cfg.n_classes, 1, cfg.dtype, device=dev),
    }


def logical_specs(cfg: GCNConfig):
    return {
        "w": [L((None, None)) for _ in range(cfg.n_layers)],
        "b": [L((None,)) for _ in range(cfg.n_layers)],
        "readout": L((None, None)),
    }


def forward(params, batch: G.GraphBatch, cfg: GCNConfig) -> Tensor:
    n = batch.n_nodes
    src, dst, mask = batch.edge_src, batch.edge_dst, batch.edge_mask.float()
    # sym normalization with self loops folded in analytically
    deg = G.degree(dst, n, mask) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    ew = mask * inv_sqrt.index_select(0, src) * inv_sqrt.index_select(0, dst)  # [E]
    self_w = inv_sqrt * inv_sqrt  # A+I diagonal term

    h = batch.node_feat.to(cfg.dtype)
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        hw = h @ w + b
        agg = G.scatter_sum(hw.index_select(0, src) * ew[:, None], dst, n) + hw * self_w[:, None]
        agg = constrain(agg, "nodes", None)
        h = torch.relu(agg) if i < cfg.n_layers - 1 else agg
    return h


def loss(params, batch: G.GraphBatch, cfg: GCNConfig) -> Tensor:
    out = forward(params, batch, cfg)
    if cfg.task == "graph_reg":
        pred = G.graph_readout(out, batch.graph_id, batch.n_graphs) @ params["readout"]
        err = (pred[:, 0] - batch.labels.float()) * batch.label_mask
        return (err ** 2).sum() / torch.clamp(batch.label_mask.sum(), min=1.0)
    return G.masked_node_ce(out, batch.labels, batch.label_mask)
