"""AutoInt (arXiv:1810.11921) and the sparse-embedding substrate (mirrors
:mod:`repro.models.recsys`).

:func:`embedding_bag` is torch-style EmbeddingBag over rectangular bags
(gather, then a reduction a bag); :func:`embedding_bag_ragged` the ragged
case through a segment sum (``index_add_``).

Model: 39 categorical fields → 16-dim embeddings → 3 self-attention layers
(2 heads, d_attn = 32) over the field axis → flatten → logit.  Serving
paths: :func:`forward_logits` (ranking) and :func:`retrieval_scores` (a
query against N candidates, the cell the paper's k-means IVF
accelerates).  The sharding hints (``constrain``) are the identity off a
mesh; ``logical_specs`` tags the parameters for one.

All fields' lookups are one gather from the stacked ``[n_fields, rows,
d]`` tables (the single-hot ids and the multi-hot bags together), so the
backward pass scatters into one zero tensor the size of the tables: the
tables' gradient is dense, as the reference's is, and AdamW with weight
decay touches every row.  The gathers are ``embedding``s, whose backward
sums each row's gradient in a fixed order: a step is reproducible bit for
bit on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.nn.functional import embedding

from repro_torch import _random
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.common import dense_init, embedding_rows, normal_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_fields: int = 39
    rows_per_table: int = 1_000_000  # hashed vocabulary per field
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    n_multihot: int = 4  # last fields are multi-hot bags (exercise EmbeddingBag)
    hot_per_field: int = 8  # bag size for multi-hot fields
    dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def _combine(emb: Tensor, weights: Optional[Tensor], combine: str) -> Tensor:
    """Reduce gathered rows ``emb`` [..., bag, d] over the bag axis."""
    if weights is not None:
        emb = emb * weights[..., None]
    if combine == "sum":
        return emb.sum(dim=-2)
    if combine == "mean":
        den = (emb.shape[-2] if weights is None
               else torch.clamp(weights.sum(-1, keepdim=True), min=1e-9))
        return emb.sum(dim=-2) / den
    if combine == "max":
        return emb.amax(dim=-2)
    raise ValueError(combine)


def embedding_bag(
    table: Tensor,  # [rows, d]
    ids: Tensor,  # [n_bags, bag] integer
    weights: Optional[Tensor] = None,  # [n_bags, bag]
    *,
    combine: str = "mean",
) -> Tensor:
    """torch-style EmbeddingBag: gather rows, reduce per bag (``sum``,
    ``mean`` — by the bag size, or by the weights' sum —, ``max``)."""
    return _combine(embedding(ids, table), weights, combine)


def embedding_bag_ragged(
    table: Tensor, flat_ids: Tensor, bag_ids: Tensor, n_bags: int, *, combine: str = "sum"
) -> Tensor:
    """Ragged EmbeddingBag: gather + segment reduction by bag id."""
    emb = table[flat_ids]
    s = torch.zeros((n_bags, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    s = s.index_add(0, bag_ids, emb)
    if combine == "sum":
        return s
    c = torch.zeros((n_bags, 1), dtype=emb.dtype, device=emb.device).index_add(
        0, bag_ids, torch.ones((flat_ids.shape[0], 1), dtype=emb.dtype, device=emb.device))
    return s / torch.clamp(c, min=1.0)


# ---------------------------------------------------------------------------
# AutoInt
# ---------------------------------------------------------------------------

def init_params(cfg: AutoIntConfig, gen: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, drawn on ``device`` (the card unless
    the caller asks for the CPU) from the counter-based stream keyed by one
    draw of ``gen``; the 2.5 GB tables of the full config in row chunks,
    none of it on the host."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    d, da, H, dt = cfg.embed_dim, cfg.d_attn, cfg.n_heads, cfg.dtype
    tables = normal_init(stream, (cfg.n_fields, cfg.rows_per_table, d), dt, 0.01, dev)
    layers = []
    d_in = d
    for _ in range(cfg.n_attn_layers):
        layers.append({name: dense_init(stream, d_in, H * da, dt, device=dev)
                       for name in ("wq", "wk", "wv", "w_res")})
        d_in = H * da
    return {
        "tables": tables,
        "layers": layers,
        "w_out": dense_init(stream, cfg.n_fields * d_in, 1, dt, device=dev),
        "b_out": torch.zeros((1,), dtype=dt, device=dev),
        # query tower for retrieval cells: project pooled fields to embed space
        "w_query": dense_init(stream, cfg.n_fields * d_in, 64, dt, device=dev),
    }


def logical_specs(cfg: AutoIntConfig):
    layer = {"wq": L((None, None)), "wk": L((None, None)), "wv": L((None, None)),
             "w_res": L((None, None))}
    return {
        "tables": L((None, "table_rows", None)),
        "layers": [dict(layer) for _ in range(cfg.n_attn_layers)],
        "w_out": L((None, None)),
        "b_out": L((None,)),
        "w_query": L((None, None)),
    }


def _field_embeddings(params, batch: Dict[str, Tensor], cfg: AutoIntConfig) -> Tensor:
    """[B, n_fields, d] from single-hot ids [B, n_single] + multi-hot bags
    [B, n_multihot, hot] (each bag's mean), gathered in one lookup."""
    ids = batch["ids"]
    B = ids.shape[0]
    n_single = cfg.n_fields - cfg.n_multihot
    fields = torch.arange(n_single, device=ids.device)
    cols = [ids]
    if cfg.n_multihot:
        bags = batch["bag_ids"]
        hot = bags.shape[2]
        fields = torch.cat([fields, torch.arange(n_single, cfg.n_fields, device=ids.device)
                            .repeat_interleave(hot)])
        cols.append(bags.reshape(B, -1))
    # each column's row in its field's table: one lookup into the
    # [n_fields·rows, d] view of the stacked tables (row-parallel on a mesh)
    emb = embedding_rows(torch.cat(cols, 1), params["tables"], fields)  # [B, n_single + M·hot, d]
    if cfg.n_multihot:
        bag_emb = emb[:, n_single:].reshape(B, cfg.n_multihot, hot, -1)
        emb = torch.cat([emb[:, :n_single], _combine(bag_emb, None, "mean")], dim=1)
    return constrain(emb, "batch", None, None)


def interact(params, x: Tensor, cfg: AutoIntConfig) -> Tensor:
    """Multi-head self-attention over the field axis (AutoInt §3.3)."""
    B, F, _ = x.shape
    H, da = cfg.n_heads, cfg.d_attn
    for lp in params["layers"]:
        q = (x @ lp["wq"]).reshape(B, F, H, da)
        k = (x @ lp["wk"]).reshape(B, F, H, da)
        v = (x @ lp["wv"]).reshape(B, F, H, da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, H * da)
        x = torch.relu(o + x @ lp["w_res"])
        x = constrain(x, "batch", None, None)
    return x


def forward_logits(params, batch: Dict[str, Tensor], cfg: AutoIntConfig) -> Tensor:
    x = _field_embeddings(params, batch, cfg)
    x = interact(params, x, cfg)
    flat = x.reshape(x.shape[0], -1)
    return (flat @ params["w_out"] + params["b_out"])[:, 0]


def train_loss(params, batch: Dict[str, Tensor], cfg: AutoIntConfig) -> Tensor:
    logits = forward_logits(params, batch, cfg)
    y = batch["labels"].float()
    lf = logits.float()
    # numerically stable BCE-with-logits
    return torch.mean(torch.clamp(lf, min=0) - lf * y + torch.log1p(torch.exp(-torch.abs(lf))))


def query_embedding(params, batch: Dict[str, Tensor], cfg: AutoIntConfig) -> Tensor:
    x = _field_embeddings(params, batch, cfg)
    x = interact(params, x, cfg)
    q = x.reshape(x.shape[0], -1) @ params["w_query"]
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-9)


def retrieval_scores(query: Tensor, candidates: Tensor) -> Tensor:
    """[Q, d] × [N, d] → [Q, N] dot-product scores, fp32."""
    return constrain(query.float() @ candidates.float().T, None, "candidates")
