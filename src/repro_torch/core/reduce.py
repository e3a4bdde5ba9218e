"""Stage 1.5 — spectrum-preserving graph reduction (mirrors
:mod:`repro.core.reduce`).

``sparsify``
    Gumbel top-m sampling of undirected edges by the effective-resistance
    proxy ``w_e · (1/d_u + 1/d_v)``, Horvitz–Thompson reweighting, and a
    backbone of every vertex's heaviest edge kept exactly.  Exactly
    ``2 · target_upper_count(nnz, ratio)`` entries survive.

``coarsen`` + ``refine``
    Multilevel heavy-edge matching; the coarse graph is the Galerkin product
    ``Pᵀ W P`` of the partition prolongation ``P``.  ``refine`` lifts the
    coarse embedding through ``P``, smooths it with a few products of the
    fine normalized adjacency and rotates it by one Rayleigh–Ritz step.

Everything runs on the graph's device, the reference's host compaction of
the coarse ids included: the only values read back are the sizes that set
shapes (the coarse node count, the stall test).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import _random
from repro_torch.core.lanczos import _eigh
from repro_torch.sparse.formats import COO, coo_from_edges
from repro_torch.sparse.ops import degrees, sort_coo_rows


# ---------------------------------------------------------------------------
# Configs (field for field the reference's, so its JSON loads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparsifyConfig:
    """Stage-1.5 edge-sampling knobs: ``target_nnz_ratio`` of the directed
    nnz kept, ``seed`` of the Gumbel keys, ``backbone`` (keep every vertex's
    heaviest edge exactly)."""

    target_nnz_ratio: float = 0.4
    seed: int = 0
    backbone: bool = True

    def __post_init__(self):
        if not 0.0 < self.target_nnz_ratio <= 1.0:
            raise ValueError(
                f"SparsifyConfig.target_nnz_ratio must be in (0, 1], got "
                f"{self.target_nnz_ratio}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CoarsenConfig:
    """Stage-1.5 multilevel coarsening knobs: ``levels`` of heavy-edge
    matching (stopping below ``min_nodes`` or when a level removes < 5 % of
    the nodes), ``rounds`` of handshakes a level, ``refine_steps`` smoothing
    products in ``refine``."""

    levels: int = 1
    rounds: int = 2
    refine_steps: int = 2
    min_nodes: int = 64

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError(f"CoarsenConfig.levels must be >= 1, got {self.levels}")
        if self.rounds < 1:
            raise ValueError(f"CoarsenConfig.rounds must be >= 1, got {self.rounds}")
        if self.refine_steps < 0:
            raise ValueError(
                f"CoarsenConfig.refine_steps must be >= 0, got {self.refine_steps}")
        if self.min_nodes < 2:
            raise ValueError(
                f"CoarsenConfig.min_nodes must be >= 2, got {self.min_nodes}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ReduceInfo(NamedTuple):
    """Provenance numbers a reduction stage leaves in the pipeline state."""

    kind: str  # "sparsify" | "coarsen"
    n_before: int
    n_after: int
    nnz_before: int
    nnz_after: int


class ReductionState(NamedTuple):
    """What ``refine`` needs to lift a coarse embedding back to the fine
    graph: the fine-level Stage-1 state and the fine → coarse partition map
    (``None`` for reductions that keep the node set)."""

    fine_graph: object  # repro_torch.core.spectral.GraphState (import cycle)
    prolong: Optional[torch.Tensor]  # [n_fine] int64 coarse id per fine node
    info: ReduceInfo


# ---------------------------------------------------------------------------
# Sparsify
# ---------------------------------------------------------------------------

def draw_gumbel(seed: int, nnz: int, device) -> torch.Tensor:
    """The sparsifier's [nnz] float32 Gumbel keys: draw 0 of the counter-based
    stream keyed by ``seed``'s two 32-bit words (low, high), made on
    ``device``.  (The reference draws ``jax.random.gumbel(PRNGKey(seed))``;
    parity tests put that draw here.)"""
    key = (seed & _random.MASK32, (seed >> 32) & _random.MASK32)
    return _random.gumbel(key, 0, nnz, device)


def sparsify_coo(w: COO, cfg: SparsifyConfig) -> COO:
    """Sample a spectrum-preserving subgraph of the symmetric raw-weight
    graph ``w``: Gumbel top-m over the upper-triangle entries scored by
    ``w_e · (1/d_u + 1/d_v)``, reweighted ``w_e / min(1, m'·p_e)``, backbone
    edges kept exactly.  Returns both orientations of the ``m`` kept edges,
    row-sorted.  Duplicate coordinates count as parallel edges."""
    nnz = w.nnz
    m = target_upper_count(nnz, cfg.target_nnz_ratio)
    f32 = torch.float32

    deg = degrees(w).to(f32)
    d = torch.clamp(deg, min=1e-30)
    val = w.val.to(f32)
    upper = (w.row < w.col) & (val > 0)
    zero = torch.zeros((), dtype=f32, device=val.device)
    score = torch.where(upper, val * (1.0 / d[w.row] + 1.0 / d[w.col]), zero)

    if cfg.backbone:
        # a vertex's heaviest incident edge: symmetric storage puts every
        # incident edge in the vertex's own rows; empty rows stay -inf
        rowmax = torch.full((w.shape[0],), -torch.inf, dtype=f32, device=val.device) \
            .scatter_reduce(0, w.row, val, "amax")
        backbone = upper & ((val >= rowmax[w.row]) | (val >= rowmax[w.col]))
    else:
        backbone = torch.zeros_like(upper)

    s_nb = torch.where(backbone, zero, score)
    p_nb = s_nb / torch.clamp(s_nb.sum(), min=1e-30)
    m_sample = torch.clamp(float(m) - backbone.sum().to(f32), min=1.0)

    g = draw_gumbel(cfg.seed, nnz, val.device)
    logp = torch.where(s_nb > 0, torch.log(torch.clamp(p_nb, min=1e-38)), -torch.inf)
    keys = torch.where(backbone, torch.inf, logp + g)
    # lax.top_k's order: descending, ties (every backbone key is +inf, every
    # unscored one -inf) lowest index first — a stable descending sort;
    # torch.topk leaves the order of ties unspecified
    sel = torch.sort(keys, descending=True, stable=True).indices[:m]

    pi = torch.where(backbone, 1.0, torch.clamp(m_sample * p_nb, 1e-12, 1.0))
    val_new = torch.where(score + backbone.to(f32) > 0, val / pi, zero)

    r, c, v = w.row[sel], w.col[sel], val_new[sel]
    out = COO(row=torch.cat([r, c]), col=torch.cat([c, r]),
              val=torch.cat([v, v]).to(w.val.dtype), shape=w.shape, sorted_rows=False)
    return sort_coo_rows(out)


def target_upper_count(nnz: int, ratio: float) -> int:
    """Number of undirected edges a sparsify pass keeps (the output COO holds
    both orientations: ``2 ·`` this)."""
    return max(1, min(nnz // 2, int(ratio * nnz) // 2))


# ---------------------------------------------------------------------------
# Coarsen
# ---------------------------------------------------------------------------

def heavy_edge_matching(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, n: int,
                        *, rounds: int = 2) -> torch.Tensor:
    """Handshake heavy-edge matching: each round every unmatched vertex
    proposes to its heaviest unmatched neighbour (ties toward the lowest
    column id), and mutual proposals match.  Returns ``match[u]`` (int64, on
    the edges' device): the partner, or ``u`` itself when unmatched."""
    dev = row.device
    idx = torch.arange(n, device=dev)
    match = idx
    unmatched = torch.ones(n, dtype=torch.bool, device=dev)
    valf = val.to(torch.float32)
    neg = torch.full((n,), -torch.inf, device=dev)
    none = torch.full((n,), n, dtype=torch.int64, device=dev)

    for _ in range(rounds):
        ok = unmatched[row] & unmatched[col] & (row != col) & (valf > 0)
        ev = torch.where(ok, valf, -torch.inf)
        best = neg.scatter_reduce(0, row, ev, "amax")
        is_best = ok & (ev >= best[row])
        cand = torch.where(is_best, col, n)
        best_col = none.scatter_reduce(0, row, cand, "amin")  # n if none
        prop = torch.where(best_col < n, best_col, idx)
        newly = (prop[prop] == idx) & (prop != idx) & unmatched
        match = torch.where(newly, prop, match)
        unmatched = unmatched & ~newly
    return match


def coarsen_coo(w: COO, cfg: CoarsenConfig) -> Tuple[COO, torch.Tensor]:
    """Multilevel heavy-edge-matching coarsening of a symmetric raw-weight
    graph: ``(w_coarse, prolong)`` with ``prolong[u]`` the coarse id of fine
    node ``u`` (int64) and ``w_coarse = Pᵀ w P``, duplicates summed (pairs'
    inner edges become coarse self-loops).  Weights go back to the graph's
    dtype after each level, as in the reference."""
    dev = w.device
    row, col, val = w.row, w.col, w.val.double()
    n = w.shape[0]
    prolong = torch.arange(n, device=dev)

    for _ in range(cfg.levels):
        if n <= cfg.min_nodes:
            break
        match = heavy_edge_matching(row, col, val.float(), n, rounds=cfg.rounds)
        rep = torch.minimum(torch.arange(n, device=dev), match)  # pair representative
        uniq, dense = torch.unique(rep, sorted=True, return_inverse=True)
        nc = uniq.numel()
        if nc >= int(0.95 * n):  # stalled: nothing left worth matching
            break
        prolong = dense[prolong]
        merged = coo_from_edges(dense[row], dense[col], val, (nc, nc),
                                sum_duplicates=True, dtype=w.val.dtype)
        row, col, val = merged.row, merged.col, merged.val.double()
        n = nc

    wc = coo_from_edges(row, col, val, (n, n), dtype=w.val.dtype)
    return wc, prolong


# ---------------------------------------------------------------------------
# Refine
# ---------------------------------------------------------------------------

def lift_and_smooth(op, u0: torch.Tensor, *, steps: int = 2
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Smooth the lifted coarse basis with ``steps`` products of the fine
    operator, orthonormalize, and rotate by one Rayleigh–Ritz step.

    Returns ``(u, theta, residuals)``: an [n, k] orthonormal Ritz basis
    (columns descending by Ritz value), the [k] Ritz values and the residual
    norms ``‖A u − θ u‖``.  The k × k eigenproblem is solved in float64 (a
    float32 ``eigh`` on an H100 put eigenvalues ~5.5e-5 low; see
    :func:`repro_torch.core.lanczos._eigh`).  Under an operator with
    ``rows`` (a mesh's), ``u0`` and ``u`` are this rank's rows: the QR is
    tall-skinny and the Gram and the norms are all-reduced."""
    from repro_torch.core.operator import row_block

    f32 = torch.float32
    rows = row_block(op, op.shape[0])
    u = u0.to(f32)
    for _ in range(max(0, steps)):
        u = op.mm(u).to(f32)
    q, _ = rows.qr(u)
    aq = op.mm(q).to(f32)  # the Rayleigh–Ritz stream
    b = rows.psum(q.T @ aq)
    theta, s = _eigh(b)  # ascending
    sel = s.flip(1)  # descending
    u = q @ sel
    vals = theta.flip(0)
    resid = rows.norm(aq @ sel - u * vals[None, :], dim=0)
    return u, vals, resid


# ---------------------------------------------------------------------------
# Quality diagnostic
# ---------------------------------------------------------------------------

def topk_eigenvalue_drift(vals_ref, vals_red, k: int) -> float:
    """Max relative drift of the top-k Laplacian eigenvalues between an
    unreduced and a reduced run, scaled by the largest reference magnitude."""
    a = np.asarray(torch.as_tensor(vals_ref).cpu(), np.float64)[:k]
    b = np.asarray(torch.as_tensor(vals_red).cpu(), np.float64)[:k]
    kk = min(a.size, b.size)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-12)
    return float(np.abs(a[:kk] - b[:kk]).max(initial=0.0) / scale)
