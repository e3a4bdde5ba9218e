"""The comparison that decides ``correct``.

It takes what the timed path produced (:class:`Outputs`: the normalised
graph as laid out, the eigensolver's pairs and claimed residuals, the
labels of each clustering judged), the points and features the benchmark
made, and the configuration's pipeline, and works everything else out
again in float64:

* Stage 1, ``graph_layout``: entries whose row or column differ from the
  layout of the reference's exact kNN lists; an exact comparison.
  ``graph_values``: the widest gap of a normalised weight to the
  reference's, over the largest weight.
* Stage 2, on the reference's operator: ``eig_count`` how far the number of
  pairs is from the configured ``n_eigvecs`` (or ``n_clusters``), an exact
  comparison; ``eig_spectrum`` the widest gap between the reported
  eigenvalues, in descending order, and the reference's own top
  eigenvalues (:mod:`.eigen`, float64), so pairs from another part of the
  spectrum, or a pair missed, read the spectrum's gap there;
  ``eig_residual`` the largest ``‖A u − θ u‖`` over ``max|θ|``,
  ``eig_claim`` the widest gap between those residuals and the ones the
  solver reported, ``eig_orth`` the largest entry of ``UᵀU − I``,
  ``eig_value`` the widest gap between a reported eigenvalue and its
  vector's Rayleigh quotient.
* Stage 3, ``kmeans_gap``: on the embedding rows of the judged vectors and
  the centroids that are the means of the labels, the largest amount by
  which a point's distance to its own centroid exceeds its distance to the
  nearest (Lloyd's fixed point, independent of the seeding's draws); a
  label outside [0, k) reads infinite.  ``kmeans_inertia``, the gap of the
  reported inertia to the labels' own, is printed beside it, not compared:
  the port's fp32 distances read up to ~6e-6 and a TF32 k-means as little
  as ~4e-6 (PERF.md).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from specbench.reference import eigen, graph as rgraph
from specbench.reference.kmeans import embed_rows
from specbench.reference.precision import no_tf32


# the reference's own top eigenvalues: residuals at most this, so that each
# eigenvalue is within it (and within its square over the gap to the next)
SPECTRUM_TOL = 1e-7
STAGE23 = ("eig_count", "eig_spectrum", "eig_residual", "eig_claim", "eig_orth",
           "eig_value", "kmeans_inertia", "kmeans_gap")


class Outputs(NamedTuple):
    row: torch.Tensor  # [E] the normalised graph's entries, in its order
    col: torch.Tensor
    val: torch.Tensor
    values: torch.Tensor  # [k] the adjacency's eigenvalues, descending
    vectors: torch.Tensor  # [n, k]
    residuals: torch.Tensor  # [k] as the solver reported them
    labels: List[Tuple[torch.Tensor, int, float]]  # (labels [n], k, reported inertia) judged


def _stage1(out: Outputs, points, features, knn_k: int, dev) -> tuple:
    row, col = out.row.to(dev).long(), out.col.to(dev).long()
    ids = rgraph.exact_knn(points, knn_k)
    g = rgraph.normalized(ids, rgraph.edge_weights(features, ids, "fp64"))
    if row.shape != g.row.shape:
        return {"graph_layout": math.inf, "graph_values": math.inf}, g
    nums = {"graph_layout": float(((row != g.row) | (col != g.col)).sum())}
    gap = (out.val.to(dev).double() - g.val).abs().max()
    nums["graph_values"] = float(gap / g.val.abs().max())
    return nums, g


def _stage2(out: Outputs, g, k: int, dev) -> Dict[str, float]:
    a = rgraph.operator(g)
    u = out.vectors.to(dev).double()
    theta = out.values.to(dev).double()
    scale = float(theta.abs().max())
    au = a @ u
    res = torch.linalg.norm(au - u * theta, dim=0)
    rayleigh = (u * au).sum(0) / torch.clamp((u * u).sum(0), min=1e-300)
    orth = float((u.T @ u - torch.eye(u.shape[1], dtype=u.dtype, device=dev)).abs().max())
    del au
    ref = eigen.top_eigenpairs(a, k, "fp64", tol=SPECTRUM_TOL)
    want = ref.values
    m = min(k, theta.shape[0])
    got = torch.sort(theta, descending=True).values[:m]
    return {
        "eig_ref_residual": float(ref.residuals.max()),  # printed, not compared
        "eig_ref_iterations": float(ref.iterations),
        "eig_count": float(abs(theta.shape[0] - k)),
        "eig_spectrum": float((got - want[:m]).abs().max()) if m else math.inf,
        "eig_residual": float(res.max()) / scale,
        "eig_claim": float((res - out.residuals.to(dev).double()).abs().max()) / scale,
        "eig_orth": orth,
        "eig_value": float((theta - rayleigh).abs().max()),
    }


def kmeans_numbers(emb: torch.Tensor, labels: torch.Tensor, k: int, inertia: float, *,
                   block: int = 16384) -> Tuple[float, float]:
    """(inertia gap, fixed-point gap) of ``labels`` on ``emb`` (float64):
    the relative gap of the reported ``inertia`` to the labels' inertia
    about their means, and the largest amount by which a point's distance
    to its own centroid exceeds its distance to the nearest."""
    lab = labels.to(emb.device).long()
    if lab.shape[0] != emb.shape[0] or bool(((lab < 0) | (lab >= k)).any()):
        return math.inf, math.inf
    counts = torch.bincount(lab, minlength=k)
    live = counts > 0
    cen = torch.zeros((k, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    cen.index_add_(0, lab, emb)
    cen = cen[live] / counts[live, None].to(emb.dtype)
    own = torch.cumsum(live.long(), 0) - 1  # a live cluster's row in cen
    cn = (cen * cen).sum(1)
    worst, total = 0.0, 0.0
    for s in range(0, emb.shape[0], block):
        e = emb[s:s + block]
        d = torch.clamp((e * e).sum(1)[:, None] + cn[None, :] - 2.0 * (e @ cen.T), min=0.0)
        mine = d.gather(1, own[lab[s:s + block]][:, None])[:, 0]
        worst = max(worst, float((mine - d.min(1).values).max()))
        total += float(mine.sum())
    return abs(float(inertia) - total) / max(total, 1e-300), worst


def judge(out: Outputs, points: torch.Tensor, features: torch.Tensor, pipeline: dict,
          device: Optional[torch.device] = None) -> Dict[str, float]:
    """Every number the configuration's check compares, by name;
    ``pipeline`` is the configuration's plan (``knn_k``, ``n_clusters``,
    ``eig.n_eigvecs``)."""
    no_tf32()
    dev = device or points.device
    points, features = points.to(dev), features.to(dev)
    k = pipeline["eig"].get("n_eigvecs") or pipeline["n_clusters"]
    nums, g = _stage1(out, points, features, pipeline["graph"]["knn_k"], dev)
    if math.isinf(nums["graph_layout"]):
        return dict(nums, **{name: math.inf for name in STAGE23})
    nums.update(_stage2(out, g, k, dev))
    emb = embed_rows(out.vectors.to(dev).double(), g.deg)
    stage3 = [kmeans_numbers(emb, lab, kc, inertia) for lab, kc, inertia in out.labels]
    nums["kmeans_inertia"] = max(x[0] for x in stage3)
    nums["kmeans_gap"] = max(x[1] for x in stage3)
    return nums


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, list]]:
    """(correct, {name: [number, limit]}): correct iff every number the
    limits name is there, finite and at most its limit."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = nums.get(name, math.nan)
        shown[name] = [v, limit]
        ok &= math.isfinite(v) and v <= limit
    return ok, shown
