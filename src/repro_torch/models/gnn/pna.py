"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718; mirrors
:mod:`repro.models.gnn.pna`).

Assigned config: 4 layers, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation.  Messages are
``MLP([h_src, h_dst])`` per edge; the 4×3 aggregator×scaler products are
concatenated and projected back — the multi-segment-reduce regime.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import _random
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.common import dense_init
from repro_torch.models.gnn import graph as G

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_in: int = 1433
    d_hidden: int = 75
    n_classes: int = 7
    avg_degree: float = 4.0  # dataset statistic for the scalers
    dtype: Any = torch.float32
    task: str = "node_class"


def init_params(cfg: PNAConfig, gen: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, drawn on ``device`` (the card unless
    the caller asks for the CPU) from the counter-based stream keyed by one
    draw of ``gen``.  As in the reference, ``w_out`` and ``readout`` share
    one key: here ``readout`` is its own draw."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    d, dt = cfg.d_hidden, cfg.dtype
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                # message MLP on [h_src ; h_dst]
                "w_msg1": dense_init(stream, 2 * d, d, dt, device=dev),
                "w_msg2": dense_init(stream, d, d, dt, device=dev),
                # post-aggregation projection: 12 aggregator×scaler channels + self
                "w_post": dense_init(stream, 13 * d, d, dt, device=dev),
                "b_post": torch.zeros((d,), dtype=dt, device=dev),
            }
        )
    return {
        "w_in": dense_init(stream, cfg.d_in, d, dt, device=dev),
        "layers": layers,
        "w_out": dense_init(stream, d, cfg.n_classes, dt, device=dev),
        "readout": dense_init(stream, cfg.n_classes, 1, dt, device=dev),
    }


def logical_specs(cfg: PNAConfig):
    layer = {
        "w_msg1": L((None, None)),
        "w_msg2": L((None, None)),
        "w_post": L((None, None)),
        "b_post": L((None,)),
    }
    return {
        "w_in": L((None, None)),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "w_out": L((None, None)),
        "readout": L((None, None)),
    }


def _pna_aggregate(msg: Tensor, dst: Tensor, n: int, mask: Tensor, avg_degree: float):
    """4 aggregators × 3 degree scalers → [n, 12·d]."""
    m = msg * mask[:, None]
    mean = G.scatter_mean(m, dst, n)
    live = mask[:, None] > 0
    mx = G.scatter_max(torch.where(live, msg, -math.inf), dst, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mn = -G.scatter_max(torch.where(live, -msg, -math.inf), dst, n)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    sq = G.scatter_mean(m * msg, dst, n)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-8))
    aggs = torch.cat([mean, mx, mn, std], dim=-1)  # [n, 4d]

    deg = G.degree(dst, n, mask)
    log_deg = torch.log(deg + 1.0)
    delta = math.log(avg_degree + 1.0)
    amp = (log_deg / delta)[:, None]
    att = (delta / torch.clamp(log_deg, min=1e-6))[:, None]
    return torch.cat([aggs, aggs * amp, aggs * att], dim=-1)  # [n, 12d]


def forward(params, batch: G.GraphBatch, cfg: PNAConfig) -> Tensor:
    n = batch.n_nodes
    src, dst = batch.edge_src, batch.edge_dst
    mask = batch.edge_mask.float()
    h = batch.node_feat.to(cfg.dtype) @ params["w_in"]
    for lp in params["layers"]:
        pair = torch.cat([h.index_select(0, src), h.index_select(0, dst)], dim=-1)  # [E, 2d]
        msg = torch.relu(pair @ lp["w_msg1"]) @ lp["w_msg2"]  # [E, d]
        msg = constrain(msg, "edges", None)
        agg = _pna_aggregate(msg, dst, n, mask, cfg.avg_degree)  # [n, 12d]
        h = h + torch.relu(torch.cat([h, agg], dim=-1) @ lp["w_post"] + lp["b_post"])
        h = constrain(h, "nodes", None)
    return h @ params["w_out"]


def loss(params, batch: G.GraphBatch, cfg: PNAConfig) -> Tensor:
    out = forward(params, batch, cfg)
    if cfg.task == "graph_reg":
        pred = G.graph_readout(out, batch.graph_id, batch.n_graphs) @ params["readout"]
        err = (pred[:, 0] - batch.labels.float()) * batch.label_mask
        return (err ** 2).sum() / torch.clamp(batch.label_mask.sum(), min=1.0)
    return G.masked_node_ce(out, batch.labels, batch.label_mask)
