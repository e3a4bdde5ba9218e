"""Graph batch container + segment-op message-passing helpers (mirrors
:mod:`repro.models.gnn.graph`).

Static-shape graph batches: edges are index pairs (src, dst) with a
validity mask (padding edges point at node 0 with mask 0).  Batched small
graphs (the ``molecule`` shape) carry a per-node graph id for readout.

Sums are ``index_add`` (atomics on the card: the order of a sum is not
fixed there); maxima are ``scatter_reduce(..., "amax", include_self=False)``
from a −inf base, so an empty segment stays at −inf as
``jax.ops.segment_max`` leaves it, and a tie splits the gradient evenly, as
``jax.grad`` of ``segment_max`` does.  The reference's sharding hints
(``constrain``) drop out on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """The reference's fields in its order; ``n_graphs`` a plain int."""

    node_feat: Tensor  # [N, F] float  (or species codes via input builders)
    edge_src: Tensor  # [E] integer
    edge_dst: Tensor  # [E] integer
    edge_mask: Tensor  # [E] bool/float
    labels: Tensor  # [N] integer node labels or [G] float graph targets
    label_mask: Tensor  # [N] or [G]
    positions: Optional[Tensor] = None  # [N, 3] (geometric models)
    species: Optional[Tensor] = None  # [N] integer (geometric models)
    graph_id: Optional[Tensor] = None  # [N] integer (batched small graphs)
    n_graphs: int = 1  # static

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]


def scatter_sum(msg: Tensor, dst: Tensor, n: int) -> Tensor:
    return msg.new_zeros((n,) + tuple(msg.shape[1:])).index_add(0, dst, msg)


def scatter_mean(msg: Tensor, dst: Tensor, n: int, eps: float = 1e-9) -> Tensor:
    s = scatter_sum(msg, dst, n)
    c = scatter_sum(msg.new_ones((msg.shape[0], 1)), dst, n)
    return s / torch.clamp(c, min=eps)


def scatter_max(msg: Tensor, dst: Tensor, n: int) -> Tensor:
    idx = dst.long().reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
    base = msg.new_full((n,) + tuple(msg.shape[1:]), -math.inf)
    return base.scatter_reduce(0, idx, msg, "amax", include_self=False)


def scatter_min(msg: Tensor, dst: Tensor, n: int) -> Tensor:
    return -scatter_max(-msg, dst, n)


def scatter_softmax(logits: Tensor, dst: Tensor, n: int) -> Tensor:
    """Edge-softmax over incoming edges per destination node (GAT-style).
    Fully-masked destinations (all logits -inf) yield zeros, not NaNs."""
    mx = scatter_max(logits, dst, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(logits - mx.index_select(0, dst))
    ex = torch.where(torch.isfinite(logits), ex, 0.0)
    den = scatter_sum(ex, dst, n)
    return ex / torch.clamp(den.index_select(0, dst), min=1e-30)


def degree(dst: Tensor, n: int, mask: Optional[Tensor] = None) -> Tensor:
    ones = (torch.ones(dst.shape, dtype=torch.float32, device=dst.device) if mask is None
            else mask.float())
    return scatter_sum(ones, dst, n)


def graph_readout(node_vals: Tensor, graph_id: Optional[Tensor], n_graphs: int, how="mean"):
    if graph_id is None:
        return (node_vals.mean(0, keepdim=True) if how == "mean"
                else node_vals.sum(0, keepdim=True))
    s = scatter_sum(node_vals, graph_id, n_graphs)
    if how == "sum":
        return s
    c = scatter_sum(node_vals.new_ones((node_vals.shape[0], 1)), graph_id, n_graphs)
    return s / torch.clamp(c, min=1.0)


def masked_node_ce(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.long()[:, None], dim=-1)[:, 0]
    m = mask.float()
    per = (lse - ll) * m
    return per.sum() / torch.clamp(m.sum(), min=1.0)
