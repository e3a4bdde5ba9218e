"""IVF candidate retrieval with the port's k-means, on the card.

    PYTHONPATH=src python examples/ann_retrieval_torch.py [--kmeans-iter two_pass] \
        [--device cpu]

The port's counterpart of ``examples/ann_retrieval.py``, with its flags and
its printed lines: cluster the candidate embeddings with k-means (the fused
iteration, the ``kmeans_iter`` kernel, or the two-pass one, the
``kmeans_assign`` kernel), then at query time score only the candidates of
the top-``nprobe`` clusters.  The index and the probes run on the card
unless ``--device cpu`` is given; the data are the reference's, from the
same numpy seed.  Reports recall@10 against exact search and the share of
candidates scored.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.kmeans import KMeansConfig, kmeans


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--kmeans-iter", choices=("fused", "two_pass"), default="fused",
                    help="Lloyd engine: one-pass fused iteration (default) or "
                         "the two-pass assignment+update baseline")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless cpu is asked for)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False "
                         "(pass --device cpu)")

    rng = np.random.default_rng(0)
    # clustered candidate distribution (realistic embedding geometry)
    centers = rng.normal(size=(64, args.dim)).astype(np.float32) * 2
    cand = (centers[rng.integers(0, 64, args.candidates)]
            + rng.normal(size=(args.candidates, args.dim)).astype(np.float32) * 0.7)
    cand /= np.linalg.norm(cand, axis=1, keepdims=True)
    q = cand[rng.integers(0, args.candidates, args.queries)] + \
        rng.normal(size=(args.queries, args.dim)).astype(np.float32) * 0.05
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cand_t = torch.as_tensor(cand, device=dev)
    q_t = torch.as_tensor(q, device=dev)

    t0 = time.perf_counter()
    res = kmeans(cand_t, KMeansConfig(k=args.clusters, max_iters=15, iter=args.kmeans_iter),
                 torch.Generator().manual_seed(0))
    C = res.centroids
    C.cpu()  # waits for the device
    print(f"[build] k-means IVF index: k={args.clusters} ({args.kmeans_iter}) "
          f"in {time.perf_counter()-t0:.2f}s ({int(res.iterations)} Lloyd iters)")

    labels = res.labels.long()
    # exact top-10
    exact = torch.argsort(-(q_t @ cand_t.T), dim=1, stable=True)[:, :10].cpu().numpy()

    # IVF probe
    t0 = time.perf_counter()
    probe = torch.argsort(-(q_t @ C.T), dim=1, stable=True)[:, : args.nprobe]
    recall, scored = 0.0, 0
    for i in range(args.queries):
        idx = torch.nonzero(torch.isin(labels, probe[i])).squeeze(1)
        scored += int(idx.numel())
        top = idx[torch.argsort(-(cand_t[idx] @ q_t[i]), stable=True)[:10]].cpu().numpy()
        recall += len(set(top.tolist()) & set(exact[i].tolist())) / 10
    dt = time.perf_counter() - t0
    recall /= args.queries
    frac = scored / (args.queries * args.candidates)
    print(f"[query] recall@10={recall:.3f}  scored {frac*100:.1f}% of candidates "
          f"({dt/args.queries*1e3:.2f} ms/query on {dev})")


if __name__ == "__main__":
    main()
