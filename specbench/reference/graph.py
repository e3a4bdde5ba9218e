"""Stage 1 of the reference: the kNN similarity graph, built again from the
points (paper Alg. 1).

The graph is the one the configuration defines: the ``k`` nearest
neighbours of every point in the search space (self excluded, ties to the
lower id), weighted by the cross-correlation of the two points' feature
rows (mean removed, cosine; negative values clipped to 0), made symmetric as
``(W + Wᵀ)/2`` with both orientations of every listed pair kept, and
normalised as ``D^{-1/2} W D^{-1/2}``.  :func:`layout` fixes the order of
the entries: the rows ascending, in a row first its own ``k`` list in
order, then the entries its neighbours' lists contribute, by source row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from specbench.reference.precision import dtype_of, operand


def exact_knn(points: torch.Tensor, k: int, *, block: int = 512) -> torch.Tensor:
    """[n, k] int64 ids of each point's ``k`` nearest other points, ascending
    by squared distance (float64), ties to the lower id."""
    x = points.double()
    n = x.shape[0]
    sq = (x * x).sum(1)
    out = torch.empty((n, k), dtype=torch.int64, device=x.device)
    cols = torch.arange(n, device=x.device)
    for s in range(0, n, block):
        q = x[s:s + block]
        rows = torch.arange(s, s + q.shape[0], device=x.device)
        d2 = torch.clamp(sq[s:s + block, None] + sq[None, :] - 2.0 * (q @ x.T), min=0.0)
        d2[torch.arange(q.shape[0], device=x.device), rows] = float("inf")
        kth = torch.kthvalue(d2, k, dim=1).values[:, None]
        less = d2 < kth
        tied = d2 == kth
        need = k - less.sum(1, keepdim=True)
        take = less | (tied & (torch.cumsum(tied.int(), 1) <= need))
        ids = cols.expand_as(d2)[take].view(-1, k)  # ascending ids
        order = torch.sort(d2.gather(1, ids), dim=1, stable=True).indices
        out[s:s + block] = ids.gather(1, order)
    return out


def knn_sq_dist(points: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[n, k] float64 squared distances of each point to its listed
    neighbours (+inf on a −1 slot)."""
    x = points.double()
    safe = ids.clamp(min=0)
    d2 = ((x[:, None, :] - x[safe]) ** 2).sum(-1)
    return torch.where(ids >= 0, d2, float("inf"))


def edge_weights(features: torch.Tensor, ids: torch.Tensor, precision: str,
                 *, block: int = 65536) -> torch.Tensor:
    """[n·k] cross-correlation weights of the listed pairs, row-major,
    clipped at 0; 0 on a −1 slot."""
    dt = dtype_of(precision)
    x = features.to(dt)
    xc = x - x.mean(dim=1, keepdim=True)
    xo = operand(xc, precision)
    norm = torch.sqrt((xo * xo).sum(1))
    n, k = ids.shape
    src = torch.arange(n, device=ids.device).repeat_interleave(k)
    dst = ids.reshape(-1)
    out = torch.zeros(n * k, dtype=dt, device=ids.device)
    for s in range(0, n * k, block):
        i, j = src[s:s + block], dst[s:s + block].clamp(min=0)
        num = (xo[i] * xo[j]).sum(1)
        w = num / torch.clamp(norm[i] * norm[j], min=1e-12)
        out[s:s + block] = torch.where(dst[s:s + block] >= 0, torch.clamp(w, min=0.0), 0.0)
    return out


class Graph(NamedTuple):
    row: torch.Tensor  # [2·n·k] int64
    col: torch.Tensor  # [2·n·k] int64
    val: torch.Tensor  # [2·n·k] D^{-1/2} W D^{-1/2}, the precision's dtype
    deg: torch.Tensor  # [n] row sums of W
    n: int


def layout(ids: torch.Tensor):
    """(row, col, edge) of the symmetric layout of the lists ``ids``
    ([n, k], −1 on an empty slot, which becomes a self entry): ``edge`` names
    the listed pair (row-major, ``i·k + s``) each entry carries."""
    n, k = ids.shape
    src = torch.arange(n, device=ids.device).repeat_interleave(k)
    dst = torch.where(ids.reshape(-1) >= 0, ids.reshape(-1), src)
    edge = torch.arange(n * k, device=ids.device)
    row = torch.cat([src, dst])
    col = torch.cat([dst, src])
    order = torch.argsort(row, stable=True)
    return row[order], col[order], torch.cat([edge, edge])[order]


def normalized(ids: torch.Tensor, w: torch.Tensor) -> Graph:
    """The graph of the lists ``ids`` with pair weights ``w``, laid out and
    normalised."""
    n = ids.shape[0]
    row, col, edge = layout(ids)
    half = 0.5 * w[edge]
    deg = torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(0, row, half)
    isd = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-300)), 0.0)
    return Graph(row, col, half * (isd[row] * isd[col]), deg, n)


def build(points: torch.Tensor, features: torch.Tensor, k: int, precision: str) -> Graph:
    """The exact kNN graph of the configuration, in ``precision``."""
    ids = exact_knn(points, k)
    return normalized(ids, edge_weights(features, ids, precision))


def operator(g: Graph) -> torch.Tensor:
    """The normalised adjacency as a sparse CSR matrix (duplicates summed)."""
    a = torch.sparse_coo_tensor(torch.stack([g.row, g.col]), g.val, (g.n, g.n),
                                check_invariants=False).coalesce()
    return a.to_sparse_csr()


def lists_of(row: torch.Tensor, col: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The ``k`` lists a graph in :func:`layout`'s order was built from: the
    first ``k`` entries of each row (a self entry read as an empty slot).
    Raises if a row holds fewer than ``k`` entries."""
    counts = torch.bincount(row, minlength=n)
    if bool((counts < k).any()):
        raise ValueError("a row holds fewer entries than its own list")
    start = torch.cumsum(counts, 0) - counts
    pos = start[:, None] + torch.arange(k, device=row.device)[None, :]
    ids = col[pos]
    return torch.where(ids == torch.arange(n, device=row.device)[:, None], -1, ids)
