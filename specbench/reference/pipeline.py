"""The whole reference pipeline, in the place of the program: the
configuration's exact kNN graph, its top eigenpairs (:mod:`.eigen`),
the embedding rows and k-means (:mod:`.kmeans`), every product in one
precision.  In float32 it is a stand-in for the program that the check
passes; in TF32 it is the control, which the check must fail."""
from __future__ import annotations

from typing import Optional

import torch

from specbench.reference import eigen, graph
from specbench.reference.judge import Outputs
from specbench.reference.kmeans import FAULTS as KMEANS_FAULTS, embed_rows, kmeans
from specbench.reference.precision import no_tf32


FAULTS = KMEANS_FAULTS + ("drop_pair",)


def run(points: torch.Tensor, features: torch.Tensor, cfg: dict, precision: str, *,
        seed: int = 0, fault: Optional[str] = None) -> Outputs:
    """The reference pipeline's outputs, as the check reads the program's.
    ``fault`` breaks it: ``"drop_pair"`` solves for one pair more and drops
    the middle one of the wanted pairs (the pairs stay orthonormal
    eigenpairs, not the top ones); the others break its k-means
    (:func:`.kmeans.kmeans`)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    no_tf32()
    pipe = cfg["pipeline"]
    k = pipe["n_clusters"]
    g = graph.build(points, features, pipe["graph"]["knn_k"], precision)
    want = pipe["eig"].get("n_eigvecs") or k
    drop = fault == "drop_pair"
    eig = eigen.top_eigenpairs(graph.operator(g), want + drop, precision, seed=seed)
    if drop:
        keep = torch.arange(want + 1, device=eig.values.device) != want // 2
        eig = eigen.Eigen(eig.values[keep], eig.vectors[:, keep], eig.residuals[keep],
                          eig.iterations)
    emb = embed_rows(eig.vectors, g.deg)
    km = kmeans(emb, k, precision, seed=seed, fault=None if drop else fault)
    return Outputs(g.row, g.col, g.val, eig.values, eig.vectors, eig.residuals,
                   [(km.labels, k, float(km.inertia))])
