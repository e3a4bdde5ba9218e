"""Whole jobs back to back from one client, closed loop: each job runs the
port's ``SpectralPipeline.run_state`` on the configuration's plan, from a
dataset's points and features to its labels, and the next job starts when
it has returned.

Traffic parameters:

* ``datasets``: the run draws this many datasets from ``--seed`` in
  set-up, on the host; job ``j`` clusters dataset ``j mod datasets``, copied
  to the device at the job's start;
* ``judge_among`` / ``judge_count``: the check judges ``judge_count`` jobs
  drawn from the seed among the window's first ``judge_among``.

Job ``j`` takes a CPU generator seeded from (``--seed``, j).  The set-up
runs one job on dataset 0 with a generator of its own, so that every kernel
and library handle the window uses is loaded.  From the program the loop
reads what it reports (the stage reports' ``wall_s``,
``kmeans_iterations``); of a judged job it keeps the normalised graph, the
eigensolver's pairs (a wrapper on ``repro_torch.core.lanczos.eigsh`` holds
its last result) and the labels, which :mod:`specbench.reference.judge`
judges after the window.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Any, Dict, List

import torch

from specbench import harness
from specbench.reference import judge as rj
from specbench.runner import sync


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def graph_pairs(adj) -> int:
    """Distinct unordered pairs (a self entry counts once) with a nonzero
    weight: the matrix's true entries, one triangle."""
    keep = adj.val != 0
    r, c = adj.row[keep].long(), adj.col[keep].long()
    n = adj.shape[0]
    return int(torch.unique(torch.minimum(r, c) * n + torch.maximum(r, c)).numel())


class Loop:
    def __init__(self, ctx):
        self.ctx, self.dev = ctx, ctx.device
        self.eig = None
        self.kept: Dict[int, tuple] = {}
        self._saved = None

    def setup(self) -> None:
        import repro_torch.core.lanczos as lz
        from repro_torch.core.spectral import SpectralPipeline

        def eigsh(*a, **kw):  # the last pairs, for a judged job
            self.eig = orig(*a, **kw)
            return self.eig

        orig = lz.eigsh
        self._saved = (lz, orig)
        lz.eigsh = eigsh
        ctx = self.ctx
        self.pipe = SpectralPipeline.from_dict(ctx.cfg["pipeline"])
        self.data = [ctx.dataset(i) for i in range(ctx.traffic["datasets"])]
        self.judged = set(harness.judged(ctx.seed, ctx.traffic["judge_among"],
                                         ctx.traffic["judge_count"]))
        gen = torch.Generator().manual_seed(harness.job_seed(ctx.seed, harness.SETUP_JOB))
        t0 = time.perf_counter()
        st = self._job(0, gen)
        sync(self.dev)
        print(f"set-up job: {time.perf_counter() - t0:.2f} s; stages "
              + ", ".join(f"{r.stage} {r.wall_s:.2f} s" for r in st.reports), file=sys.stderr)
        points = self.data[0]["points"]
        ctx.run.sizes = dict(n=points.shape[0], d_points=points.shape[1],
                             knn_k=self.pipe.graph.knn_k, graph_pairs=graph_pairs(st.graph.adj))
        self.eig = None

    def _job(self, j: int, gen: torch.Generator):
        d = self.data[j % len(self.data)]
        points, features = d["points"].to(self.dev), d["features"].to(self.dev)
        return self.pipe.run_state(features, gen, points=points, device=self.dev)

    def window(self, seconds: float, jobs: List[Dict[str, Any]]) -> None:
        w0 = time.perf_counter()
        j = 0
        while True:
            gen = torch.Generator().manual_seed(harness.job_seed(self.ctx.seed, j))
            t0 = time.perf_counter()
            rec: Dict[str, Any] = {}
            try:
                st = self._job(j, gen)
                res = st.result
                sync(self.dev)
                rec["stages"] = {r.stage: r.wall_s for r in res.reports}
                rec["kmeans_iterations"] = res.kmeans_iterations
                if j in self.judged:
                    a = st.graph.adj
                    e = self.eig
                    self.kept[j] = rj.Outputs(
                        _host(a.row), _host(a.col), _host(a.val), _host(e.eigenvalues),
                        _host(e.eigenvectors), _host(e.residuals),
                        [(_host(res.labels), self.pipe.n_clusters,
                          float(res.kmeans_inertia))])
                del st, res
            except Exception as e:  # a failed job counts, the loop goes on
                sync(self.dev)
                rec["error"] = f"{type(e).__name__}: {e}"
                print(f"job {j} failed: {rec['error']}", file=sys.stderr)
            self.eig = None
            t1 = time.perf_counter()
            rec["wall_s"] = t1 - t0
            jobs.append(rec)
            print(f"job {j}: data {j % len(self.data)}, {rec['wall_s']:.3f} s ("
                  + ", ".join(f"{k} {v:.3f}" for k, v in rec.get("stages", {}).items())
                  + f"), k-means iterations {rec.get('kmeans_iterations')}", file=sys.stderr)
            j += 1
            if t1 - w0 >= seconds and j > max(self.judged):  # every judged job in it
                return

    def check(self) -> Dict[str, float]:
        """Every number of the check, the worst over the judged jobs."""
        worst: Dict[str, float] = {}
        for j in sorted(self.kept):
            d = self.data[j % len(self.data)]
            nums = rj.judge(self.kept[j], d["points"].to(self.dev), d["features"].to(self.dev),
                            self.ctx.cfg["pipeline"])
            for name, v in nums.items():
                worst[name] = max(worst.get(name, -math.inf), v)
        return worst

    def close(self) -> None:
        if self._saved is not None:
            lz, orig = self._saved
            lz.eigsh = orig
            self._saved = None
