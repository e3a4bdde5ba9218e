"""Stage 1 — sparse similarity-graph construction (paper Alg. 1; mirrors
:mod:`repro.core.similarity`).

Given data points ``X ∈ R^{n×d}`` and a neighbourhood edge list, compute
the per-edge similarity and emit a COO graph.  Two builders coexist, as in
the reference:

* :func:`build_knn_graph` — on the device: the neighbour search (exact:
  the ``knn_topk`` CUDA kernel on the card; ``method="lsh"``: LSH
  candidates, hashed by the ``hash_codes`` CUDA kernel, then an exact
  rerank) → edge similarity → symmetrization → row-sorted COO with
  nnz = 2·n·k;
* :func:`eps_neighbors` / :func:`knn_edges` — host-side numpy builders
  (blocked brute force), copied from the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_rerank
from repro_torch.kernels.lsh_candidates.ops import (DEFAULT_N_BITS, DEFAULT_N_TABLES,
                                                    default_candidates, lsh_candidates)
from repro_torch.sparse.formats import COO, coo_from_edges
from repro_torch.sparse.ops import sort_coo_rows, symmetrize_coo

MEASURES = ("cosine", "cross_correlation", "exp_decay")


def _center_and_norms(x: torch.Tensor, measure: str):
    """Paper Alg. 1 steps 4-5: per-point mean removal + L2 norms."""
    if measure == "cross_correlation":
        x = x - x.mean(dim=1, keepdim=True)
    return x, torch.sqrt((x * x).sum(dim=1))


def edge_similarities(
    x: torch.Tensor,
    edges: torch.Tensor,
    *,
    measure: str = "cross_correlation",
    sigma: float = 1.0,
    chunk: int = 65536,
) -> torch.Tensor:
    """Similarity value per edge (paper Alg. 1 step 6).

    x     : [n, d] data points.
    edges : [nnz, 2] integer endpoint indices.
    chunk : edges per step (bounds the [chunk, d] gather working set).
    """
    x = x.float()
    if measure in ("cosine", "cross_correlation"):
        xc, norm = _center_and_norms(x, measure)

        def body(e):
            num = (xc[e[:, 0]] * xc[e[:, 1]]).sum(dim=1)
            den = norm[e[:, 0]] * norm[e[:, 1]]
            return num / torch.clamp(den, min=1e-12)

    elif measure == "exp_decay":

        def body(e):
            diff = x[e[:, 0]] - x[e[:, 1]]
            return torch.exp(-(diff * diff).sum(dim=1) / (2.0 * sigma ** 2))

    else:
        raise ValueError(f"unknown measure {measure}")

    edges = edges.long()
    return torch.cat([body(edges[s:s + chunk]) for s in range(0, edges.shape[0], chunk)]
                     or [torch.zeros(0, device=x.device)])


def build_similarity_graph(
    x,
    edges,
    n: Optional[int] = None,
    *,
    measure: str = "cross_correlation",
    sigma: float = 1.0,
    symmetrize: bool = True,
    clip_negative: bool = True,
) -> COO:
    """Edge similarities → row-sorted COO (host assembly, as in the
    reference); the result lives where ``x`` does."""
    x = torch.as_tensor(x)
    n = int(x.shape[0]) if n is None else n
    edges = np.asarray(edges.cpu() if isinstance(edges, torch.Tensor) else edges, np.int32)
    vals = edge_similarities(x, torch.as_tensor(edges, device=x.device),
                             measure=measure, sigma=sigma).cpu().numpy()
    if clip_negative:
        keep = vals > 0
        edges, vals = edges[keep], vals[keep]
    r, c = edges[:, 0], edges[:, 1]
    if symmetrize:
        mask = r != c  # never duplicate self loops
        r = np.concatenate([r, c[mask]])
        c2 = np.concatenate([c, edges[:, 0][mask]])
        vals = np.concatenate([vals, vals[mask]])
        c = c2
    return coo_from_edges(r, c, vals, (n, n), sort=True, sum_duplicates=True,
                          device=x.device)


# ---------------------------------------------------------------------------
# Device Stage 1
# ---------------------------------------------------------------------------

def graph_from_knn(
    x: torch.Tensor,
    dist2: torch.Tensor,  # [n, k] squared neighbour distances (+inf on invalid slots)
    idx: torch.Tensor,  # [n, k] neighbour ids (-1 on invalid slots)
    *,
    measure: str = "exp_decay",
    sigma: float = 1.0,
    eps=None,
    clip_negative: bool = True,
    sim_chunk: int = 65536,
    dist2_in_x_space: bool = True,
) -> COO:
    """kNN search results → symmetric row-sorted COO.

    Static nnz = 2·n·k, as in the reference: invalid slots (masked
    neighbours, clipped similarities) become zero-valued self edges, and the
    symmetrization is the duplicate-coordinate ``(W + Wᵀ)/2``.
    ``dist2_in_x_space=False`` declares that ``dist2`` was measured in
    another space than ``x`` (search on positions, weights from features),
    so exp_decay distances are recomputed from ``x``.
    """
    n, k = idx.shape
    dev = idx.device
    row = torch.arange(n, device=dev).repeat_interleave(k)
    valid = (idx >= 0).reshape(-1)
    if eps is not None:
        valid &= (dist2 <= torch.as_tensor(eps, dtype=torch.float32, device=dev) ** 2).reshape(-1)
    col = torch.where(valid, idx.reshape(-1).long(), row)
    if measure == "exp_decay" and dist2_in_x_space:
        vals = torch.exp(-dist2.reshape(-1) / (2.0 * sigma ** 2))
    else:
        edges = torch.stack([row, col], dim=1)
        vals = edge_similarities(x, edges, measure=measure, sigma=sigma, chunk=sim_chunk)
    if clip_negative:
        vals = torch.clamp(vals, min=0.0)
    vals = torch.where(valid, vals, 0.0).float()
    w = symmetrize_coo(COO(row, col, vals, (n, n)))
    return sort_coo_rows(w)


def build_knn_graph(
    x: torch.Tensor,
    k: int,
    *,
    points: Optional[torch.Tensor] = None,
    measure: str = "exp_decay",
    sigma: float = 1.0,
    eps=None,
    clip_negative: bool = True,
    method: str = "exact",
    n_tables: int = DEFAULT_N_TABLES,
    n_bits: int = DEFAULT_N_BITS,
    candidates: Optional[int] = None,
    lsh_seed: int = 0,
    block_q: Optional[int] = None,
) -> COO:
    """kNN search → similarity → symmetric row-sorted COO, on the device of
    ``x`` (static nnz = 2·n·k).

    ``method="exact"`` is the O(n²d) ``knn_topk`` search; ``"lsh"`` hashes
    the points into ``n_tables`` tables of ``n_bits``-bit random-hyperplane
    codes, takes ``candidates = m`` ids per point from windows around it
    (``None`` → ``default_candidates(k, n_tables)``) and reranks them
    exactly with ``knn_topk_rerank`` in chunks of ``block_q`` (1024 by
    default) — O(n·m·d).  A low-recall row degrades to fewer than k
    neighbours, never to wrong distances.

    ``points`` separates the neighbour-search space from the similarity
    features (the paper's DTI workflow: spatial neighbours, cross-correlation
    of connectivity profiles as weights).  ``eps`` drops neighbours beyond
    the radius (applied in :func:`graph_from_knn`, as in the reference).
    """
    p = x if points is None else points
    if points is not None and points.shape[0] != x.shape[0]:
        raise ValueError(
            f"points rows ({points.shape[0]}) must match feature rows "
            f"({x.shape[0]}) — one search point per feature row")
    if method == "lsh":
        m = default_candidates(k, n_tables) if candidates is None else candidates
        cand = lsh_candidates(p, m=m, n_tables=n_tables, n_bits=n_bits, seed=lsh_seed)
        dist2, idx = knn_topk_rerank(p, cand, k, block_q=block_q or 1024)
    elif method == "exact":
        dist2, idx = knn_topk(p, k)
    else:
        raise ValueError(f"unknown method {method!r} (expected 'exact'|'lsh')")
    return graph_from_knn(x, dist2, idx, measure=measure, sigma=sigma, eps=eps,
                          clip_negative=clip_negative,
                          dist2_in_x_space=points is None)


# ---------------------------------------------------------------------------
# Neighbourhood builders (host-side numpy, copied from the reference)
# ---------------------------------------------------------------------------

def eps_neighbors(points: np.ndarray, eps: float, *, block: int = 2048) -> np.ndarray:
    """All pairs (i < j) with ‖p_i − p_j‖ ≤ eps, by blocked brute force."""
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    out = []
    for i0 in range(0, n, block):
        pi = pts[i0 : i0 + block]
        for j0 in range(i0, n, block):
            pj = pts[j0 : j0 + block]
            d2 = ((pi[:, None, :] - pj[None, :, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= eps * eps)
            gi, gj = ii + i0, jj + j0
            keep = gi < gj
            out.append(np.stack([gi[keep], gj[keep]], axis=1))
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2), np.int64)


def knn_edges(points: np.ndarray, k: int, *, block: int = 2048) -> np.ndarray:
    """Directed kNN pairs (i, j) — j among the k nearest of i (i ≠ j).

    Exactly ``min(k, n-1)`` edges per source row: the self distance is
    pinned to −inf so the self index is always among the k+1 candidates.
    """
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    nrm = (pts * pts).sum(1)
    kk = min(k, n - 1)
    out = []
    for i0 in range(0, n, block):
        pi = pts[i0 : i0 + block]
        bsz = pi.shape[0]
        d2 = nrm[i0 : i0 + bsz, None] + nrm[None, :] - 2.0 * pi @ pts.T
        d2[np.arange(bsz), np.arange(i0, i0 + bsz)] = -np.inf
        idx = np.argpartition(d2, kth=kk, axis=1)[:, : kk + 1]
        src = np.broadcast_to(
            np.arange(i0, i0 + bsz, dtype=np.int64)[:, None], idx.shape
        )
        keep = idx != src
        out.append(np.stack([src[keep], idx[keep].astype(np.int64)], axis=1))
    return (
        np.concatenate(out, axis=0) if out else np.zeros((0, 2), np.int64)
    )
