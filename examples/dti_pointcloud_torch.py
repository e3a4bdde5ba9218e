"""The paper's DTI workflow end to end on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/dti_pointcloud_torch.py            # scaled-down
    PYTHONPATH=src python examples/dti_pointcloud_torch.py --full     # 142k voxels
    PYTHONPATH=src python examples/dti_pointcloud_torch.py --device-stage1 [--device cpu]

The port's counterpart of ``examples/dti_pointcloud.py``, with its flags
and its printed lines: a 3-D voxel lattice with 90-d connectivity profiles →
a cross-correlation similarity graph → normalized Laplacian eigenvectors →
k-means++, through one ``repro_torch`` ``SpectralPipeline``.  Runs on the
card unless ``--device cpu`` is given.

Beyond the reference's flags, ``--block-size`` and ``--representation`` set
the eigensolver's Krylov block and operator layout, so the four DTI
configurations of PERF.md §4 come from flags alone (with ``--full
--device-stage1``):

* first path:    ``--block-size 4 --representation blockell``
* scalable path: ``--graph-method lsh --solver chebyshev --kmeans-iter two_pass
                   --representation blockell``
* sparsify path: the first path with ``--sparsify 0.4``
* coarsen path:  the scalable path with ``--coarsen 1``
"""
import argparse
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.core.reduce import CoarsenConfig, SparsifyConfig
from repro_torch.core.similarity import build_similarity_graph
from repro_torch.core.spectral import EigConfig, GraphConfig, KMeansConfig, SpectralPipeline
from repro_torch.data.pointcloud import dti_like_pointcloud


def build_pipeline(args, k: int) -> SpectralPipeline:
    """The pipeline the flags describe."""
    stages = ["prepare", "embed", "cluster"]
    reduce_kw = {}
    if args.sparsify is not None:
        stages.insert(1, "sparsify")
        reduce_kw["sparsify"] = SparsifyConfig(target_nnz_ratio=args.sparsify)
    if args.coarsen is not None:
        stages.insert(stages.index("embed"), "coarsen")
        stages.insert(stages.index("embed") + 1, "refine")
        reduce_kw["coarsen"] = CoarsenConfig(levels=args.coarsen)
    return SpectralPipeline(
        n_clusters=k,
        graph=GraphConfig(knn_k=args.knn, measure="cross_correlation", method=args.graph_method),
        eig=EigConfig(tol=1e-4, solver=args.solver, block_size=args.block_size,
                      representation=args.representation),
        kmeans=KMeansConfig(iter=args.kmeans_iter),
        stages=tuple(stages), **reduce_kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-scale: 142k voxels, k=500")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--clusters", type=int, default=12)
    ap.add_argument("--device-stage1", action="store_true",
                    help="device Stage 1 (the knn_topk kernel), points→labels in one run")
    ap.add_argument("--knn", type=int, default=16, help="neighbors per voxel (device Stage 1)")
    ap.add_argument("--graph-method", choices=("exact", "lsh"), default="exact",
                    help="device Stage-1 neighbor search: exact O(n²d) kernel "
                         "or LSH candidates + exact rerank (n ≫ 100k)")
    ap.add_argument("--kmeans-iter", choices=("fused", "two_pass"), default="fused",
                    help="Stage-3 Lloyd engine (fused = one data stream/iter)")
    ap.add_argument("--solver", default="lanczos", choices=("lanczos", "chebyshev"),
                    help="Stage-2 engine: thick-restart Lanczos or the Chebyshev "
                         "polynomial filter")
    ap.add_argument("--sparsify", type=float, default=None, metavar="RATIO",
                    help="Stage 1.5: spectrum-preserving edge sampling at this target "
                         "nnz ratio before the eigensolve")
    ap.add_argument("--coarsen", type=int, default=None, metavar="LEVELS",
                    help="Stage 1.5: heavy-edge-matching coarsening (this many levels) "
                         "+ the refine lift back to the voxel graph")
    ap.add_argument("--block-size", type=int, default=1,
                    help="Lanczos Krylov block width b (>1: multi-vector SpMM mode)")
    ap.add_argument("--representation", choices=("coo", "blockell"), default="coo",
                    help="Stage-2 operator layout (blockell: the ell_spmm kernels)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless cpu is asked for)")
    args = ap.parse_args()
    if args.graph_method == "lsh" and not args.device_stage1:
        ap.error("--graph-method lsh requires --device-stage1 (the host "
                 "ε-edge path has no LSH front-end)")
    n = 142541 if args.full else args.n
    k = 500 if args.full else args.clusters
    dev = torch.device(args.device)

    t0 = time.perf_counter()
    pos, profiles, edges, region = dti_like_pointcloud(
        n, d_profile=90, n_regions=max(k // 2, 4), eps=1.8, seed=0,
        neighbors="none" if args.device_stage1 else "eps", device=dev)
    print(f"[data] {len(pos)} voxels, {len(edges)} ε-pairs "
          f"({time.perf_counter()-t0:.2f}s)")

    pipe = build_pipeline(args, k)
    gen = torch.Generator().manual_seed(0)
    if args.device_stage1:
        t0 = time.perf_counter()
        out = pipe.run(profiles, gen, points=pos, device=dev)
        labels = out.labels.cpu().numpy()  # waits for the device
        t_solve = time.perf_counter() - t0
        print(f"[stages 1-3, device] points→labels: {t_solve:.3f}s "
              f"(nnz={2 * n * args.knn}, restarts={int(out.lanczos_restarts)}, "
              f"km_iters={int(out.kmeans_iterations)})")
    else:
        t0 = time.perf_counter()
        w = build_similarity_graph(profiles, edges, measure="cross_correlation")
        t_sim = time.perf_counter() - t0
        print(f"[stage 1] similarity graph: nnz={w.nnz} ({t_sim:.3f}s)")

        t0 = time.perf_counter()
        out = pipe.run(w, gen, device=dev)
        labels = out.labels.cpu().numpy()
        t_solve = time.perf_counter() - t0
        print(f"[stages 2+3] eigensolver+kmeans: {t_solve:.3f}s "
              f"(restarts={int(out.lanczos_restarts)}, km_iters={int(out.kmeans_iterations)})")

    region = region.cpu().numpy()
    sizes = np.bincount(labels, minlength=k)
    print(f"[result] {int((sizes > 0).sum())}/{k} non-empty clusters; "
          f"largest={sizes.max()}, median={int(np.median(sizes[sizes > 0]))}")
    purity = sum(Counter(region[labels == i]).most_common(1)[0][1]
                 for i in np.unique(labels)) / len(region)
    print(f"[result] purity vs latent regions: {purity:.3f}")


if __name__ == "__main__":
    main()
