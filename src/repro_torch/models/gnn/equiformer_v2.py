"""EquiformerV2 — equivariant graph attention via eSCN SO(2) convolutions
(arXiv:2306.12059; mirrors :mod:`repro.models.gnn.equiformer_v2`).
Assigned config: 12 layers, 128 channels, l_max=6, m_max=2, 8 heads.

The eSCN mechanism (the O(L⁶)→O(L³) trick this arch exists for):

1. per edge, rotate source/destination irrep features into the edge frame
   with real Wigner-D matrices (``D_lᵀ f``, edge vector → ẑ) — after which
   an SO(3)-equivariant tensor product reduces to an **SO(2) linear map
   acting per-m**, and truncating to |m| ≤ m_max (=2) keeps only
   1 + Σ_{m≤2} pairs of rows per l instead of all (2l+1);
2. SO(2) linear: m=0 rows mix with a plain matrix; (+m, −m) row pairs mix
   with the rotation-structured pair (W_r, W_i):
        y₊ = W_r x₊ − W_i x₋ ,   y₋ = W_i x₊ + W_r x₋ ;
3. the m=0 (invariant) output drives multi-head attention logits;
   edge-softmax over incoming edges; values are rotated back (``D_l y``)
   and segment-summed.

Blocks: equivariant RMS-norm → eSCN attention → residual → gated FFN →
residual.  Edge chunking (``edge_chunk``) bounds the per-edge Wigner/feature
working set on the 61M-edge cells.

Mixed dtypes: the published config stores parameters and node features in
bf16.  The reference leans on JAX's promotion of bf16 × fp32 to fp32 in
``@`` and ``einsum`` (the norm's fp32 block means, the fp32 radial basis and
Wigner matrices); torch refuses mixed operands, so :func:`_mm` and
:func:`_einsum` promote explicitly, and each layer's output is cast back to
the storage dtype, as the reference's is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _random
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.common import dense_init, normal_init, split_last
from repro_torch.models.gnn import e3
from repro_torch.models.gnn import graph as G
from repro_torch.models.gnn.chunked import sum_over_chunks
from repro_torch.models.gnn.nequip import bessel_rbf, remat

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 10
    n_classes: int = 7
    avg_degree: float = 8.0
    task: str = "graph_reg"
    edge_chunk: Optional[int] = None
    remat: bool = True  # rematerialize per-layer + per-edge-chunk
    # the reference's layout knob (lax.scan over stacked layers); the layer
    # loop here is a Python loop either way, so it changes nothing
    scan_layers: bool = True
    dtype: Any = torch.float32


def _n_l(cfg, m: int) -> int:
    """number of l's carrying an |m| component."""
    return cfg.l_max + 1 - m


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in the promoted dtype (JAX's rule: bf16 × fp32 → fp32)."""
    a, b = _promoted(a, b)
    return a @ b


def _einsum(eq: str, *ops: Tensor) -> Tensor:
    return torch.einsum(eq, *_promoted(*ops))


def init_params(cfg: EquiformerV2Config, gen: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree, drawn on ``device`` (the card unless
    the caller asks for the CPU) from the counter-based stream keyed by one
    draw of ``gen``."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    C, H, dt = cfg.channels, cfg.n_heads, cfg.dtype

    def dense(d_in, d_out):
        return dense_init(stream, d_in, d_out, dt, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "norm_scale": torch.ones((cfg.l_max + 1, C), dtype=dt, device=dev),
            "rad1": dense(cfg.n_rbf, 64),
            "rad2": dense(64, C),
            # SO(2) linear weights; inputs concat (src, dst) -> 2C channels
            "w_m0": dense(_n_l(cfg, 0) * 2 * C, _n_l(cfg, 0) * C),
            "w_attn1": dense(C, C),
            "w_attn2": dense(C, H),
            "w_out": normal_init(stream, (cfg.l_max + 1, C, C), dt, 1 / math.sqrt(C), dev),
            # FFN
            "ffn_gate": dense(C, (cfg.l_max + 1) * C),
            "ffn_s1": dense(C, 2 * C),
            "ffn_s2": dense(2 * C, C),
            "ffn_mix": normal_init(stream, (cfg.l_max + 1, C, C), dt, 1 / math.sqrt(C), dev),
        }
        for m in range(1, cfg.m_max + 1):
            lp[f"w_m{m}r"] = dense(_n_l(cfg, m) * 2 * C, _n_l(cfg, m) * C)
            lp[f"w_m{m}i"] = dense(_n_l(cfg, m) * 2 * C, _n_l(cfg, m) * C)
        layers.append(lp)
    return {
        "embed": normal_init(stream, (cfg.n_species, C), dt, 0.5, dev),
        "layers": layers,
        "head1": dense(C, C),
        "head2": dense(C, max(cfg.n_classes, 1)),
    }


def logical_specs(cfg: EquiformerV2Config):
    def layer():
        lp = {
            "norm_scale": L((None, None)),
            "rad1": L((None, None)),
            "rad2": L((None, None)),
            "w_m0": L((None, "mlp")),
            "w_attn1": L((None, None)),
            "w_attn2": L((None, None)),
            "w_out": L((None, None, None)),
            "ffn_gate": L((None, None)),
            "ffn_s1": L((None, "mlp")),
            "ffn_s2": L(("mlp", None)),
            "ffn_mix": L((None, None, None)),
        }
        for m in range(1, cfg.m_max + 1):
            lp[f"w_m{m}r"] = L((None, "mlp"))
            lp[f"w_m{m}i"] = L((None, "mlp"))
        return lp

    return {
        "embed": L((None, None)),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "head1": L((None, None)),
        "head2": L((None, None)),
    }


def _l_of_slot(l_max: int, device=None) -> Tensor:
    """Static map irrep-slot index -> l (length (l_max+1)²)."""
    out = np.concatenate([np.full(2 * l + 1, l) for l in range(l_max + 1)])
    return torch.as_tensor(out, dtype=torch.int64, device=device)


def _equiv_norm(h, scale, sl, eps=1e-6):
    """RMS over (m) per l, per channel; learnable per-(l, channel) scale.
    The per-l block means are means over one split of the m axis each,
    then one gather; fp32 out whatever ``h``'s dtype (the block means are
    fp32, as the reference's are).  The split cuts only the m axis, which
    no spec shards, and its backward is one concatenation: a node-sharded
    ``h`` needs no view, expand or product batched over its (possibly
    uneven) node shard, none of which DTensor takes where GSPMD pads (the
    reference's block-mean einsum reshapes through one)."""
    l_max = len(sl) - 1
    parts = (h * h).float().split([e - s for s, e in sl], dim=1)
    means = torch.stack([p.mean(1) for p in parts], 1)  # [N, L+1, C]
    rms = torch.sqrt(means + eps)
    slot = _l_of_slot(l_max, h.device)
    out = h / rms.index_select(1, slot) * scale.index_select(0, slot)[None, :, :]
    return constrain(out, "nodes", None, "channels")


def _attention_edges(lp, h, src, dst, vec, mask, cfg: EquiformerV2Config):
    """eSCN attention messages for one edge set → node aggregation."""
    n = h.shape[0]
    E = src.shape[0]
    C, H = cfg.channels, cfg.n_heads
    sl = e3.irrep_slices(cfg.l_max)

    r = torch.linalg.vector_norm(vec, dim=-1)
    mask = mask * (r > 1e-6)  # zero-length edges have no frame (equivariance)
    rad = _mm(F.silu(_mm(bessel_rbf(r, cfg.n_rbf, cfg.cutoff), lp["rad1"])), lp["rad2"])  # [E, C]
    alpha_ang, beta_ang = e3.edge_alignment_angles(vec)
    D = [e3.real_wigner_D(l, alpha_ang, beta_ang) for l in range(cfg.l_max + 1)]

    # rotate src/dst features into the edge frame, keep |m| <= m_max rows
    x_src = constrain(h.index_select(0, src), "edges", None, "channels")
    x_dst = constrain(h.index_select(0, dst), "edges", None, "channels")
    rows = {m: {"p": [], "n": []} for m in range(cfg.m_max + 1)}
    for l, (s, e) in enumerate(sl):
        fs = _einsum("enm,enc->emc", D[l], x_src[:, s:e, :])  # D^T f
        fd = _einsum("enm,enc->emc", D[l], x_dst[:, s:e, :])
        both = torch.cat([fs, fd], dim=-1)  # [E, 2l+1, 2C]
        for m in range(0, min(l, cfg.m_max) + 1):
            rows[m]["p"].append(both[:, l + m, :])
            if m > 0:
                rows[m]["n"].append(both[:, l - m, :])

    # SO(2) linear per m
    y = {}
    x0 = torch.stack(rows[0]["p"], dim=1).reshape(E, -1)  # [E, n_l0*2C]
    y[0] = split_last(_mm(x0, lp["w_m0"]), _n_l(cfg, 0), C)
    for m in range(1, cfg.m_max + 1):
        xp = torch.stack(rows[m]["p"], dim=1).reshape(E, -1)
        xn = torch.stack(rows[m]["n"], dim=1).reshape(E, -1)
        yr = split_last(_mm(xp, lp[f"w_m{m}r"]) - _mm(xn, lp[f"w_m{m}i"]), _n_l(cfg, m), C)
        yn = split_last(_mm(xp, lp[f"w_m{m}i"]) + _mm(xn, lp[f"w_m{m}r"]), _n_l(cfg, m), C)
        y[m] = (yr, yn)

    # radial modulation + attention logits from the invariant (m=0, l=0) slot
    inv = F.silu(y[0][:, 0, :] * rad)  # [E, C]
    logits = _mm(F.silu(_mm(inv, lp["w_attn1"])), lp["w_attn2"])  # [E, H]
    live = mask[:, None] > 0
    logits = torch.where(live, logits, -math.inf)
    att = G.scatter_softmax(logits, dst, n)  # [E, H]
    att = torch.where(live, att, 0.0)

    # rebuild edge-frame value tensor, rotate back, aggregate with attention
    blocks = []
    for l, (s, e) in enumerate(sl):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            if am > cfg.m_max:
                cols.append(torch.zeros((E, C), dtype=h.dtype, device=h.device))
            elif m == 0:
                cols.append(y[0][:, l, :] * rad)
            elif m > 0:
                cols.append(y[am][0][:, l - am, :] * rad)
            else:
                cols.append(y[am][1][:, l - am, :] * rad)
        blk = torch.stack(cols, dim=1)  # [E, 2l+1, C]
        blocks.append(_einsum("emn,enc->emc", D[l], blk))
    val = constrain(torch.cat(blocks, dim=1), "edges", None, "channels")  # [E, (l_max+1)², C]
    # each head's weight on its C/H channels, as a product with the 0/1
    # head → channel map: no view splits the (on a mesh, sharded) channels,
    # forward or backward
    heads = (torch.arange(C, device=att.device) // (C // H) ==
             torch.arange(H, device=att.device)[:, None]).to(att.dtype)  # [H, C]
    vh = val * (att @ heads)[:, None, :]
    agg = constrain(G.scatter_sum(vh, dst, n), "nodes", None, "channels")
    return agg / math.sqrt(cfg.avg_degree)


def _attention(lp, h, batch: G.GraphBatch, cfg: EquiformerV2Config):
    src, dst = batch.edge_src, batch.edge_dst
    mask = batch.edge_mask.float()
    pos = batch.positions
    vec = (pos.index_select(0, src) - pos.index_select(0, dst)).float()
    if not cfg.edge_chunk or src.shape[0] <= cfg.edge_chunk:
        return _attention_edges(lp, h, src, dst, vec, mask, cfg)
    # chunked: the softmax is normalized within each chunk and each chunk's
    # aggregate divided by the chunk count — the reference's approximation
    # for the huge full-graph cells (exact for single-chunk graphs), ported
    # as it is; padding edges get the vector (1, 1, 1) and mask 0
    E = src.shape[0]
    chunk = cfg.edge_chunk
    pad = (-E) % chunk
    srcp = F.pad(src, (0, pad))
    dstp = F.pad(dst, (0, pad))
    vecp = F.pad(vec, (0, 0, 0, pad), value=1.0)
    maskp = F.pad(mask, (0, pad))
    nc = (E + pad) // chunk

    def f(args, x):
        lp_, h_ = args
        s, d, v, m = x
        return _attention_edges(lp_, h_, s, d, v, m, cfg) / nc

    def keep_sharded(gargs):
        glp, gh = gargs
        return glp, constrain(gh, "nodes", None, "channels")

    # shard the CHUNK dim; the chunk-count dim is not mesh-divisible
    xs = (constrain(srcp.reshape(nc, chunk), None, "edges"),
          constrain(dstp.reshape(nc, chunk), None, "edges"),
          constrain(vecp.reshape(nc, chunk, 3), None, "edges", None),
          constrain(maskp.reshape(nc, chunk), None, "edges"))
    out = torch.empty((h.shape[0], (cfg.l_max + 1) ** 2, cfg.channels), dtype=h.dtype,
                      device="meta")
    return sum_over_chunks(f, (lp, h), xs, out, args_constrain=keep_sharded)


def forward(params, batch: G.GraphBatch, cfg: EquiformerV2Config) -> Tensor:
    assert batch.positions is not None and batch.species is not None
    n = batch.positions.shape[0]
    dev = batch.positions.device
    sl = e3.irrep_slices(cfg.l_max)
    dim = (cfg.l_max + 1) ** 2
    C = cfg.channels

    # the species embedding in the l = 0 slot, zeros in the others
    emb = params["embed"].index_select(0, batch.species).to(cfg.dtype)
    h = torch.cat([emb[:, None, :], torch.zeros((n, dim - 1, C), dtype=cfg.dtype, device=dev)],
                  dim=1)
    h = constrain(h, "nodes", None, "channels")
    slot = _l_of_slot(cfg.l_max, dev)

    def mix(x, w):  # per-l channel mixing as one slot-gathered einsum
        return constrain(_einsum("nmc,mcd->nmd", x, w.index_select(0, slot)),
                         "nodes", None, "channels")

    def layer(h, lp):
        hn = _equiv_norm(h, lp["norm_scale"], sl)
        attn = _attention(lp, hn, batch, cfg)
        h = constrain(h + mix(attn, lp["w_out"]), "nodes", None, "channels")
        # gated FFN
        hn = _equiv_norm(h, lp["norm_scale"], sl)
        scal = _mm(F.silu(_mm(hn[:, 0, :], lp["ffn_s1"])), lp["ffn_s2"])  # [N, C]
        # the gates' cotangent comes back channel-sharded: the constraint
        # gathers it before the reshape's backward flattens (l, channels),
        # a view DTensor does not take over a sharded inner dim on every
        # release
        gates = constrain(torch.sigmoid(_mm(hn[:, 0, :], lp["ffn_gate"])).reshape(
            n, cfg.l_max + 1, C), "nodes", None, "channels")
        up = mix(hn, lp["ffn_mix"]) * gates.index_select(1, slot)
        up = torch.cat([scal[:, None, :].to(up.dtype), up[:, 1:, :]], dim=1)
        return (h + up).to(cfg.dtype)  # fp32 internals -> storage dtype

    for lp in params["layers"]:
        h = remat(layer, cfg, [h, *lp.values()])(h, lp)
    return h


def loss(params, batch: G.GraphBatch, cfg: EquiformerV2Config) -> Tensor:
    h = forward(params, batch, cfg)
    out = F.silu(h[:, 0, :] @ params["head1"]) @ params["head2"]
    if cfg.task == "graph_reg":
        energy = G.graph_readout(out[:, :1], batch.graph_id, batch.n_graphs, how="sum")
        err = (energy[:, 0] - batch.labels.float()) * batch.label_mask
        return (err ** 2).sum() / torch.clamp(batch.label_mask.sum(), min=1.0)
    return G.masked_node_ce(out, batch.labels, batch.label_mask)
