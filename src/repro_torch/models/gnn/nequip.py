"""NequIP — E(3)-equivariant interatomic potential (arXiv:2101.03164;
mirrors :mod:`repro.models.gnn.nequip`).

Assigned config: 5 layers, 32 channels, l_max=2, 8 Bessel RBFs, 5 Å cutoff.
Features live in a concatenated irrep layout ``[N, (l_max+1)², C]`` (equal
multiplicity per l).  Each interaction block computes, per edge,

    m_ij^{l3} = Σ_{l1,l2 paths}  CG^{l1 l2 l3} · h_j^{l1} ⊗ Y^{l2}(r̂_ij) · R^{path}(|r_ij|)

with the real-basis Clebsch-Gordan tensors from :mod:`.e3` — the O(L⁶)
tensor-product regime.  Edges are processed in chunks (``edge_chunk``)
through :func:`.chunked.sum_over_chunks`, so the per-edge expanded tensors
never exceed a bounded working set, in the backward pass too.

Messages aggregate by ``index_add``; blocks follow conv → self-interaction
→ gate (scalars: SiLU; l>0: sigmoid gate from scalar channels) → residual.
``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant), saving nothing inside it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import _random
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.common import dense_init, normal_init
from repro_torch.models.gnn import e3
from repro_torch.models.gnn import graph as G
from repro_torch.models.gnn.chunked import sum_over_chunks

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32  # d_hidden: multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10
    n_classes: int = 7  # node-classification head (non-molecular cells)
    avg_degree: float = 8.0
    task: str = "graph_reg"  # "graph_reg" (energy) | "node_class"
    edge_chunk: Optional[int] = None
    remat: bool = True  # rematerialize per-layer + per-edge-chunk (full-graph cells)
    dtype: Any = torch.float32


def _paths(l_max: int) -> List[Tuple[int, int, int]]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, l3))
    return out


def init_params(cfg: NequIPConfig, gen: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, drawn on ``device`` (the card unless
    the caller asks for the CPU) from the counter-based stream keyed by one
    draw of ``gen``."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    n_paths = len(_paths(cfg.l_max))
    n_l = cfg.l_max + 1
    C, dt = cfg.channels, cfg.dtype
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                # radial MLP: rbf -> weights for every (path, channel)
                "rad1": dense_init(stream, cfg.n_rbf, 64, dt, device=dev),
                "rad2": dense_init(stream, 64, n_paths * C, dt, device=dev),
                # per-l self interactions (channel mixing), pre and post
                "self_pre": normal_init(stream, (n_l, C, C), dt, 1 / math.sqrt(C), dev),
                "self_post": normal_init(stream, (n_l, C, C), dt, 1 / math.sqrt(C), dev),
                # gate: scalars -> per-l gates
                "w_gate": dense_init(stream, C, n_l * C, dt, device=dev),
                "b_gate": torch.zeros((n_l * C,), dtype=dt, device=dev),
            }
        )
    return {
        "embed": normal_init(stream, (cfg.n_species, C), dt, 0.5, dev),
        "layers": layers,
        "head1": dense_init(stream, C, C, dt, device=dev),
        "head2": dense_init(stream, C, max(cfg.n_classes, 1), dt, device=dev),
    }


def logical_specs(cfg: NequIPConfig):
    layer = {
        "rad1": L((None, None)),
        "rad2": L((None, None)),
        "self_pre": L((None, None, None)),
        "self_post": L((None, None, None)),
        "w_gate": L((None, None)),
        "b_gate": L((None,)),
    }
    return {
        "embed": L((None, None)),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "head1": L((None, None)),
        "head2": L((None, None)),
    }


def bessel_rbf(r: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """sin(nπr/rc)/r basis × smooth polynomial cutoff envelope."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rs = torch.clamp(r, min=1e-6)[:, None]
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rs / cutoff) / rs
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5  # p=3 polynomial cutoff
    return basis * env[:, None]


def _messages(lp, h, src, dst, vec, mask, cfg: NequIPConfig, cg_tensors):
    """Per-edge tensor-product messages, aggregated to nodes. All edges."""
    n = h.shape[0]
    paths = _paths(cfg.l_max)
    sl = e3.irrep_slices(cfg.l_max)
    C = cfg.channels

    r = torch.linalg.vector_norm(vec, dim=-1)
    mask = mask * (r > 1e-6)  # zero-length edges (self loops / padding) have
    # no defined direction and would silently break equivariance
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)  # [E, n_rbf]
    rad = F.silu(rbf @ lp["rad1"]) @ lp["rad2"]  # [E, P*C]
    rad = rad.reshape(-1, len(paths), C) * mask[:, None, None]
    rad = constrain(rad, "edges", None, "channels")
    Y = e3.real_sph_harm(cfg.l_max, vec)  # list per l2: [E, 2l2+1]

    h_src = constrain(h.index_select(0, src), "edges", None, "channels")  # [E, dim, C]
    acc = [None] * (cfg.l_max + 1)  # per l3, summed over its paths in path order
    for pi, (l1, l2, l3) in enumerate(paths):
        cg = cg_tensors[(l1, l2, l3)]  # [2l1+1, 2l2+1, 2l3+1]
        x1 = h_src[:, sl[l1][0]:sl[l1][1], :]  # [E, a, C]
        # CG against Y first ([E, a, c]), then a batched product with the
        # features: no [E, a, b, c, C]-sized intermediate, whatever einsum's
        # contraction order would be
        m = torch.bmm(torch.einsum("abc,eb->eca", cg, Y[l2]), x1)  # [E, 2l3+1, C]
        m = m * rad[:, pi, None, :]
        acc[l3] = m if acc[l3] is None else acc[l3] + m
    out = constrain(torch.cat(acc, dim=1), "edges", None, "channels")  # [E, (l_max+1)², C]
    agg = G.scatter_sum(out, dst, n)
    return constrain(agg, "nodes", None, "channels") / math.sqrt(cfg.avg_degree)


def _messages_chunked(lp, h, src, dst, vec, mask, cfg: NequIPConfig, cg_tensors, chunk: int):
    E = src.shape[0]
    pad = (-E) % chunk
    if pad:  # zero padding: zero-length vectors, masked
        src = F.pad(src, (0, pad))
        dst = F.pad(dst, (0, pad))
        vec = F.pad(vec, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    nc = (E + pad) // chunk
    shape = torch.empty((h.shape[0], (cfg.l_max + 1) ** 2, cfg.channels), dtype=h.dtype,
                        device="meta")

    def f(args, x):
        lp_, h_ = args
        s, d, v, m = x
        return _messages(lp_, h_, s, d, v, m, cfg, cg_tensors)

    def keep_sharded(gargs):
        glp, gh = gargs
        return glp, constrain(gh, "nodes", None, "channels")

    # shard the CHUNK dim; the chunk-count dim is not mesh-divisible
    xs = (constrain(src.reshape(nc, chunk), None, "edges"),
          constrain(dst.reshape(nc, chunk), None, "edges"),
          constrain(vec.reshape(nc, chunk, 3), None, "edges", None),
          constrain(mask.reshape(nc, chunk), None, "edges"))
    return sum_over_chunks(f, (lp, h), xs, shape, args_constrain=keep_sharded)


def remat(layer, cfg, tensors):
    """``layer`` recomputed in the backward pass (non-reentrant
    ``torch.utils.checkpoint``, nothing saved inside it: the reference's
    ``nothing_saveable``) when the config asks for it and a gradient will be
    taken; else ``layer`` itself."""
    if not (cfg.remat and torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return layer
    return lambda *a: checkpoint(layer, *a, use_reentrant=False)


def forward(params, batch: G.GraphBatch, cfg: NequIPConfig) -> Tensor:
    assert batch.positions is not None and batch.species is not None
    n = batch.positions.shape[0]
    src, dst = batch.edge_src, batch.edge_dst
    mask = batch.edge_mask.float()
    pos = batch.positions
    vec = (pos.index_select(0, src) - pos.index_select(0, dst)).float()
    dev = pos.device
    cg_tensors = {p: torch.as_tensor(e3.real_cg(*p), dtype=torch.float32, device=dev)
                  for p in _paths(cfg.l_max)}
    dim = (cfg.l_max + 1) ** 2
    C = cfg.channels

    # the species embedding in the l = 0 slot, zeros in the others
    emb = params["embed"].index_select(0, batch.species).to(cfg.dtype)
    h = torch.cat([emb[:, None, :], torch.zeros((n, dim - 1, C), dtype=cfg.dtype, device=dev)],
                  dim=1)
    h = constrain(h, "nodes", None, "channels")
    from repro_torch.models.gnn.equiformer_v2 import _l_of_slot

    slot = _l_of_slot(cfg.l_max, dev)

    def self_interact(h, w):  # per-l channel mixing, one slot-gathered einsum
        return torch.einsum("nmc,mcd->nmd", h, w.index_select(0, slot))

    def layer(h, lp):
        hi = self_interact(h, lp["self_pre"])
        if cfg.edge_chunk and src.shape[0] > cfg.edge_chunk:
            m = _messages_chunked(lp, hi, src, dst, vec, mask, cfg, cg_tensors, cfg.edge_chunk)
        else:
            m = _messages(lp, hi, src, dst, vec, mask, cfg, cg_tensors)
        m = constrain(self_interact(m, lp["self_post"]), "nodes", None, "channels")
        # gate nonlinearity (slot-gathered)
        gates = torch.sigmoid(h[:, 0, :] @ lp["w_gate"] + lp["b_gate"]).reshape(
            n, cfg.l_max + 1, C)
        upd = m * gates.index_select(1, slot)
        upd = torch.cat([F.silu(m[:, 0:1, :]), upd[:, 1:, :]], dim=1)
        return h + upd

    for lp in params["layers"]:
        h = remat(layer, cfg, [h, *lp.values()])(h, lp)
    return h


def loss(params, batch: G.GraphBatch, cfg: NequIPConfig) -> Tensor:
    h = forward(params, batch, cfg)
    scalars = h[:, 0, :]
    out = F.silu(scalars @ params["head1"]) @ params["head2"]  # [N, n_classes]
    if cfg.task == "graph_reg":
        energy = G.graph_readout(out[:, :1], batch.graph_id, batch.n_graphs, how="sum")
        err = (energy[:, 0] - batch.labels.float()) * batch.label_mask
        return (err ** 2).sum() / torch.clamp(batch.label_mask.sum(), min=1.0)
    return G.masked_node_ce(out, batch.labels, batch.label_mask)
