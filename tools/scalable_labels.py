"""Labels of a full-size DTI path, from the ``repro_torch`` package of a
given source tree, and their ARI against saved labels — to compare two trees
of the port on one card.

    python3 tools/scalable_labels.py [--path scalable|main] SRC_DIR OUT.npy [AGAINST.npy ...]

Runs the configuration of one of ``chip_smoke.py``'s paths (142,541 voxels,
500 clusters, seed 0) — the scalable path (LSH kNN graph, Chebyshev
filter, two-pass k-means; the default) or the first path (exact kNN graph,
block Lanczos, fused k-means) — with ``SRC_DIR`` first on ``sys.path``,
saves the labels to ``OUT.npy``, and prints purity, Lloyd iterations and the
adjusted Rand index against each ``AGAINST.npy`` (for example the
``scalable_labels.npy`` or ``main_labels.npy`` that ``chip_smoke.py`` writes
to ``chiprun_out/``).  Needs a GPU.
"""
import sys
import time

import numpy as np
import torch


def main(argv) -> int:
    path = "scalable"
    if argv[:1] == ["--path"]:
        path, argv = argv[1], argv[2:]
    if len(argv) < 2 or path not in ("scalable", "main"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scalable_labels: this script needs a GPU", file=sys.stderr)
        return 1
    src, out, against = argv[0], argv[1], argv[2:]
    sys.path.insert(0, src)
    from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,
                                           SpectralPipeline)
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.serve.metrics import adjusted_rand_index

    pos, prof, _, region = dti_like_pointcloud(142541, 90, 250, eps=1.8, seed=0,
                                               neighbors="none")
    if path == "scalable":
        pipe = SpectralPipeline(
            n_clusters=500,
            graph=GraphConfig(knn_k=16, measure="cross_correlation", method="lsh"),
            eig=EigConfig(tol=1e-4, solver="chebyshev", representation="blockell"),
            kmeans=KMeansConfig(iter="two_pass"))
    else:
        pipe = SpectralPipeline(
            n_clusters=500, graph=GraphConfig(knn_k=16, measure="cross_correlation"),
            eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
            kmeans=KMeansConfig(iter="fused"))
    t0 = time.perf_counter()
    res = pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos).result
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    labels = res.labels.cpu().numpy()
    np.save(out, labels)
    _, ti = np.unique(region.cpu().numpy(), return_inverse=True)
    table = np.zeros((labels.max() + 1, ti.max() + 1), np.int64)
    np.add.at(table, (labels, ti), 1)
    print(f"[labels] {path} path, {src}: points→labels {wall:.2f} s, kmeans iterations="
          f"{res.kmeans_iterations}, purity={table.max(1).sum() / labels.size:.4f}")
    for path in against:
        ari = adjusted_rand_index(torch.as_tensor(labels), torch.as_tensor(np.load(path)))
        print(f"[labels] ARI against {path}: {float(ari):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
