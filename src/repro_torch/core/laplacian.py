"""Stage 2a — normalized graph Laplacian operators (paper Alg. 2; mirrors
:mod:`repro.core.laplacian`).

The symmetric form ``A = D^{-1/2} W D^{-1/2}`` has the spectrum of the
paper's ``D⁻¹W``; eigenvectors map by ``u_rw = D^{-1/2} u_sym``.  Isolated
vertices (D_ii = 0) get zero rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sparse.formats import COO
from repro_torch.sparse.ops import degrees, normalize_rw, normalize_sym


@dataclasses.dataclass(frozen=True)
class NormalizedGraph:
    """Pre-normalized operator bundle consumed by the eigensolver."""

    adj_sym: COO  # D^{-1/2} W D^{-1/2}
    deg: torch.Tensor  # D_ii
    inv_sqrt_deg: torch.Tensor  # D_ii^{-1/2} (0 where isolated)


def normalized_graph(w: COO) -> NormalizedGraph:
    d = degrees(w)
    d32 = d.float()
    isd = torch.where(d32 > 0, torch.rsqrt(torch.clamp(d32, min=1e-30)),
                      torch.zeros_like(d32))
    return NormalizedGraph(adj_sym=normalize_sym(w, d), deg=d,
                           inv_sqrt_deg=isd.to(w.val.dtype))


def random_walk_matrix(w: COO) -> COO:
    """The paper's exact operator D⁻¹W (kept for parity tests)."""
    return normalize_rw(w)


def smallest_laplacian_eigs_from_adj(theta: torch.Tensor) -> torch.Tensor:
    """Largest-k eigenvalues θ of A ↔ smallest-k eigenvalues 1-θ of L_sym."""
    return 1.0 - theta


def embed_rows(v_sym: torch.Tensor, inv_sqrt_deg: torch.Tensor, *,
               row_normalize: bool = True) -> torch.Tensor:
    """Map symmetric-form eigenvectors to D⁻¹W eigenvectors and
    row-normalize (Ng-Jordan-Weiss) for Stage 3 k-means."""
    h = v_sym * inv_sqrt_deg[:, None]
    if row_normalize:
        nrm = torch.sqrt((h * h).sum(dim=1, keepdim=True))
        h = h / torch.clamp(nrm, min=1e-12)
    return h
