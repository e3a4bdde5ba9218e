"""The roofline table of the port's dry-run reports (mirrors
:mod:`repro.launch.report`), with a column that says whether the rank's
total fits one H100's 80 GB and one with the dry-run's host seconds for
the cell (both passes).

    PYTHONPATH=src python -m repro_torch.launch.report [--out build/dryrun] [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

HBM_GB = 80.0  # one H100 SXM5's memory (GB = 2**30 bytes here, as the reports' sizes)


def load(out_dir: str, mesh: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, mesh, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_row(r) -> str:
    cell = r["cell"]
    if "skip" in r:
        return f"| {cell} | — | — | — | — | SKIP | {r['skip'].split(':')[0]} | — | — | — |"
    if "error" in r:
        return f"| {cell} | — | — | — | — | ERROR | {r['error'][:60]} | — | — | — |"
    bt = {"compute": "**C**", "memory": "**M**", "collective": "**X**"}[r["bottleneck"]]
    gb = r["memory_per_device_gb"]
    fits = "yes" if gb <= HBM_GB else "**no**"
    return (
        f"| {cell} | {r['compute_s']:.4f} | {r['memory_s']:.4f} | {r['collective_s']:.4f} "
        f"| {bt} | {r['useful_ratio']:.3f} | {gb:.1f} | "
        f"{r['coll_bytes_dev']/1e9:.2f} | {fits} | {r['compile_s']:.1f} |"
    )


HEADER = (
    "| cell | compute s | memory s | collective s | bottleneck | useful ratio "
    "| GB/rank | coll GB/rank | fits 80 GB | host s |\n|---|---|---|---|---|---|---|---|---|---|"
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = load(args.out, args.mesh)
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    ok = sum(1 for r in rows if "error" not in r and "skip" not in r)
    sk = sum(1 for r in rows if "skip" in r)
    er = sum(1 for r in rows if "error" in r)
    over = sum(1 for r in rows if "memory_per_device_gb" in r and r["memory_per_device_gb"] > HBM_GB)
    print(f"\n{ok} ran, {sk} skipped (assignment rule), {er} errors; "
          f"{over} over {HBM_GB:.0f} GB a rank")


if __name__ == "__main__":
    main()
