"""Host-clock breakdown of the two DTI paths' stage walls: where the host
spends a full-size ``SpectralPipeline.run_state`` on one card.

    python3 tools/host_clock.py [SRC_DIR]

Runs the paths of ``chip_smoke.py`` (142,541 voxels, 500 clusters; the
first path exact kNN → block Lanczos → fused k-means, the scalable path
LSH → Chebyshev → two-pass k-means) with the port imported from ``SRC_DIR``
(default: this tree's ``src``; give another tree's, unpacked with ``git
archive``, to compare in turns).  After a warm-up run of each path, one run
with these host clocks:

* **draws** — ``chebyshev.draw_signals`` (the filter's signals),
  ``kmeans.kmeanspp_init`` (k-means++ seeding: its draws and its n·k·d
  distance updates) and the Lanczos normal draws (start block, breakdown
  directions), each between
  ``torch.cuda.synchronize()`` calls, so the time is the host's and the
  device's both;
* **host assembly** — the input guard ``health.check_points`` and
  ``SpectralPipeline.operator`` (the BlockELL layout), also between
  synchronisations (both run on the card and read back only counts; on a
  tree from before that, the guard copies the points to the host and the
  layout is built in numpy);
* **host reads** — every ``Tensor.__int__``, ``__bool__``, ``__float__``,
  ``item``, ``tolist`` and ``cpu`` outside those: the time the host waits
  for the device to drain before it reads a value (k-means's changed-label
  count, Lanczos's cycle flags, the ladders' checks).

Prints one line a path and writes the records to
``chiprun_out/host_clock_<name>.json`` (``<name>``: ``SRC_DIR``'s parent
directory, or ``this`` by default).  The synchronisations change the run
they time: its wall is printed beside the timed run's.  Needs a GPU.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

N_FULL, D_PROFILE, N_REGIONS, K_FULL, KNN_K = 142541, 90, 250, 500, 16
READS = ("__int__", "__bool__", "__float__", "item", "tolist", "cpu")


class HostClock:
    """Patches the timed functions for the length of a ``with`` block; nested
    timed calls count once, at the outermost."""

    def __init__(self):
        import torch

        import repro_torch.core.chebyshev as cheb
        import repro_torch.core.health as health
        import repro_torch.core.kmeans as km
        import repro_torch.core.lanczos as lz
        import repro_torch.core.spectral as sp

        self.torch = torch
        synced = [(cheb, "draw_signals", "draw_signals"),
                  (km, "kmeanspp_init", "kmeanspp_init"),
                  (health, "check_points", "check_points"),
                  (sp.SpectralPipeline, "operator", "blockell_build")]
        if hasattr(lz, "randn"):  # a tree that draws on the host
            synced.append((lz, "randn", "lanczos_draws"))
        else:  # draw_signals's normal draw is nested, so counted there
            from repro_torch import _random

            synced.append((_random.Stream, "normal", "lanczos_draws"))
        self.synced = synced
        self.reads = [(torch.Tensor, name, f"read {name}") for name in READS]
        self.depth = 0
        self.totals = {}

    def _add(self, label, dt):
        s, c = self.totals.get(label, (0.0, 0))
        self.totals[label] = (s + dt, c + 1)

    def _wrap(self, fn, label, sync):
        clock = self

        def timed(*a, **kw):
            if clock.depth:
                return fn(*a, **kw)
            clock.depth += 1
            try:
                if sync:
                    clock.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if sync:
                    clock.torch.cuda.synchronize()
                clock._add(label, time.perf_counter() - t0)
                return out
            finally:
                clock.depth -= 1

        return timed

    def __enter__(self):
        self.saved = []
        for owner, name, label in self.synced + self.reads:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn, name in vars(owner)))
            setattr(owner, name, self._wrap(fn, label, sync=(owner, name, label) in self.synced))
        return self

    def __exit__(self, *exc):
        for owner, name, fn, own in reversed(self.saved):
            if own:
                setattr(owner, name, fn)
            else:  # inherited (the tensor methods): drop the patch
                delattr(owner, name)


def breakdown(run) -> dict:
    """``run()`` once under the host clocks: ``{label: (seconds, calls)}``,
    the run's wall, and what the host clocks leave."""
    import torch

    clock = HostClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with clock:
        state = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parts = dict(clock.totals)
    reports = {r.stage: r.wall_s for r in state.result.reports}
    return dict(wall_s=wall, stage_wall_s=reports,
                parts={k: dict(seconds=v[0], calls=v[1]) for k, v in sorted(parts.items())},
                unattributed_s=wall - sum(v[0] for v in parts.values()))


def describe(tag: str, rec: dict) -> str:
    parts = "; ".join(f"{k} {v['seconds']:.3f} s ({v['calls']}×)" for k, v in rec["parts"].items())
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in rec["stage_wall_s"].items())
    return (f"[host-clock] {tag}: wall {rec['wall_s']:.2f} s (stages {stages}); {parts}; "
            f"outside these {rec['unattributed_s']:.3f} s")


def main() -> int:
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    name = src.parent.name if len(sys.argv) > 1 else "this"
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("host_clock: this script needs a GPU", file=sys.stderr)
        return 1
    import subprocess

    from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,
                                           SpectralPipeline)
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"[host-clock] port imported from {src}")
    _build.build()
    pos, prof, _, _ = dti_like_pointcloud(N_FULL, D_PROFILE, N_REGIONS, eps=1.8, seed=0,
                                          neighbors="none")
    pipes = dict(
        main=SpectralPipeline(n_clusters=K_FULL,
                              graph=GraphConfig(knn_k=KNN_K, measure="cross_correlation"),
                              eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
                              kmeans=KMeansConfig(iter="fused")),
        scalable=SpectralPipeline(n_clusters=K_FULL,
                                  graph=GraphConfig(knn_k=KNN_K, measure="cross_correlation",
                                                    method="lsh"),
                                  eig=EigConfig(tol=1e-4, solver="chebyshev",
                                                representation="blockell"),
                                  kmeans=KMeansConfig(iter="two_pass")))
    out = {}
    for tag, pipe in pipes.items():
        def run():
            return pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        rec = breakdown(run)
        rec["untimed_wall_s"] = plain
        print(describe(tag, rec) + f"; the same run without host clocks {plain:.2f} s")
        out[tag] = rec
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"host_clock_{name}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
