"""Stage 3 of the reference: k-means with k-means++ seeding and Lloyd
iterations until no label changes (paper Alg. 4-5), and the spectral
embedding's rows (Ng-Jordan-Weiss)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from specbench.reference.precision import dtype_of, mm


def embed_rows(vectors: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``D^{-1/2} U`` with each row scaled to unit length (a zero row stays
    zero)."""
    isd = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-300)), 0.0)
    h = vectors * isd.to(vectors.dtype)[:, None]
    return h / torch.clamp(torch.linalg.norm(h, dim=1, keepdim=True), min=1e-12)


def sq_dist(x: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    """[n, k] squared distances ‖x‖² + ‖c‖² − 2x·c, the product in
    ``precision``."""
    xn = (x * x).sum(1)
    cn = (c * c).sum(1)
    return torch.clamp(xn[:, None] + cn[None, :] - 2.0 * mm(x, c.T, precision), min=0.0)


def assign(x: torch.Tensor, c: torch.Tensor, precision: str, *, block: int = 16384):
    """(labels [n] int64, squared distance to the nearest centroid [n]),
    ties to the lower centroid."""
    labels, dmin = [], []
    for s in range(0, x.shape[0], block):
        d = sq_dist(x[s:s + block], c, precision)
        v, i = torch.min(d, dim=1)
        labels.append(i)
        dmin.append(v)
    return torch.cat(labels), torch.cat(dmin)


class KMeans(NamedTuple):
    labels: torch.Tensor
    centroids: torch.Tensor
    inertia: torch.Tensor
    iterations: int


FAULTS = ("unchanged", "half", "label")


def kmeans(x: torch.Tensor, k: int, precision: str, *, seed: int = 0,
           max_iters: int = 1000, fault: Optional[str] = None) -> KMeans:
    """k-means++ seeding (D² sampling from a CPU generator), then Lloyd
    iterations until no label changes; an empty cluster keeps its centroid.
    ``fault`` breaks it for the check's fault readings: ``"unchanged"`` (a
    Lloyd step returns its centroids unchanged), ``"half"`` (each step's
    means over the first half of the points), ``"label"`` (one point's label
    moved to the next cluster at the end)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    x = x.to(dtype_of(precision))
    n = x.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    first = int(torch.randint(n, (1,), generator=gen))
    c = x[first:first + 1].clone()
    d2 = sq_dist(x, c, precision)[:, 0]
    for _ in range(1, k):
        p = (d2.double() / torch.clamp(d2.double().sum(), min=1e-300)).cpu()
        nxt = int(torch.multinomial(p, 1, generator=gen)) if float(p.sum()) > 0 else 0
        c = torch.cat([c, x[nxt:nxt + 1]])
        d2 = torch.minimum(d2, sq_dist(x, x[nxt:nxt + 1], precision)[:, 0])
    labels = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    it = 0
    while it < max_iters:
        new, dmin = assign(x, c, precision)
        it += 1
        m = n // 2 if fault == "half" else n
        sums = torch.zeros_like(c).index_add_(0, new[:m], x[:m])
        counts = torch.bincount(new[:m], minlength=k).to(x.dtype)
        if fault != "unchanged":
            c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1)[:, None], c)
        if torch.equal(new, labels):
            break
        labels = new
    if fault == "label":
        labels = labels.clone()
        labels[7] = (labels[7] + 1) % k
    return KMeans(labels, c, dmin.sum(), it)
