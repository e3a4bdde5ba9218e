"""Quickstart on the PyTorch/CUDA port: spectral clustering of a stochastic
block model graph.

    PYTHONPATH=src python examples/quickstart_torch.py [--clusters 8] [--n-per 200] \
        [--device cpu]

The port's counterpart of ``examples/quickstart.py``, with the same flags and
the same printed lines: an SBM graph (the paper's Syn200 family) through one
``repro_torch`` ``SpectralPipeline`` (normalized Laplacian → restarted
Lanczos → k-means++), then the cached spectral embedding re-clustered at 2×k
without re-entering the eigensolver.  Runs on the card unless ``--device
cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.reduce import CoarsenConfig, SparsifyConfig
from repro_torch.core.spectral import EigConfig, SpectralPipeline
from repro_torch.data.sbm import sbm_graph


def purity(labels, truth) -> float:
    from collections import Counter

    return sum(Counter(truth[labels == i]).most_common(1)[0][1]
               for i in np.unique(labels)) / len(truth)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--n-per", type=int, default=200)
    ap.add_argument("--p-in", type=float, default=0.3)
    ap.add_argument("--p-out", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=1,
                    help="Lanczos Krylov block width b (>1: multi-vector SpMM mode)")
    ap.add_argument("--solver", default="lanczos", choices=("lanczos", "chebyshev"),
                    help="Stage-2 engine: thick-restart Lanczos (exact eigenpairs) or the "
                         "Chebyshev polynomial filter (fixed operator-stream cost — the "
                         "large-k path)")
    ap.add_argument("--sparsify", type=float, default=None, metavar="RATIO",
                    help="insert the Stage-1.5 sparsify stage at this target nnz ratio "
                         "(e.g. 0.4 keeps 40%% of the edges, spectrum-preserving sampling)")
    ap.add_argument("--coarsen", type=int, default=None, metavar="LEVELS",
                    help="insert Stage-1.5 heavy-edge-matching coarsening (this many "
                         "levels) + the paired refine lift")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless cpu is asked for)")
    args = ap.parse_args()

    coo, truth = sbm_graph(args.n_per, args.clusters, args.p_in, args.p_out, seed=args.seed,
                           device=args.device)
    truth = truth.cpu().numpy()
    print(f"graph: {coo.shape[0]} nodes, {coo.nnz} directed edges")

    # Stage 1.5: optional reduction stages interpose in the stage DAG
    stages = ["prepare", "embed", "cluster"]
    kw = {}
    if args.sparsify is not None:
        stages.insert(1, "sparsify")
        kw["sparsify"] = SparsifyConfig(target_nnz_ratio=args.sparsify)
    if args.coarsen is not None:
        stages.insert(stages.index("embed"), "coarsen")
        stages.insert(stages.index("embed") + 1, "refine")
        kw["coarsen"] = CoarsenConfig(levels=args.coarsen)
    pipe = SpectralPipeline(n_clusters=args.clusters,
                            eig=EigConfig(block_size=args.block_size, solver=args.solver),
                            stages=tuple(stages), **kw)
    out = pipe.run(coo, torch.Generator().manual_seed(args.seed), device=args.device)

    labels = out.labels.cpu().numpy()
    ev = out.eigenvalues.cpu().numpy()
    print(f"solver: {args.solver}  restarts: {int(out.lanczos_restarts)}  "
          f"k-means iterations: {int(out.kmeans_iterations)}")
    print(f"smallest Laplacian eigenvalues: {np.round(ev[:min(10, len(ev))], 4)}")
    print(f"purity vs planted partition: {purity(labels, truth):.3f}")

    # stage resumability: reuse the cached embedding at a different k —
    # Stage 3 only, no second Lanczos solve
    state = pipe.prepare(coo, device=args.device)
    emb = pipe.embed(state, torch.Generator().manual_seed(args.seed), device=args.device)
    out2 = pipe.cluster(emb, torch.Generator().manual_seed(args.seed + 1),
                        n_clusters=2 * args.clusters, device=args.device)
    print(f"re-clustered cached embedding at k={2 * args.clusters}: "
          f"{len(np.unique(out2.labels.cpu().numpy()))} non-empty clusters "
          f"(no extra restarts: {int(out2.lanczos_restarts)} == {int(emb.restarts)})")


if __name__ == "__main__":
    main()
