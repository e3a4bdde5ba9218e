"""A benchmark root at a tiny size for the CPU tests: the repository's
``specbench`` files and manifest, with a tiny copy of each configuration
(the same plan at 512 points, 16-d profiles, 6 regions, 8 clusters), a tiny
traffic mix (two datasets) and a tiny cell, and the port's sources linked
in."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_DATA = {"maker": "dti_points", "n_points": 512, "d_profile": 16, "n_regions": 6}
TINY_CELL = "tiny-exact.serial"


def tiny_config(name: str = "dti-exact", clusters: int = 8) -> dict:
    cfg = json.loads((REPO / "specbench" / "configs" / f"{name}.json").read_text())
    cfg["name"] = f"tiny-{name.split('-', 1)[1]}"
    cfg["data"] = dict(TINY_DATA)
    cfg["pipeline"]["n_clusters"] = clusters
    return cfg


def add_cell(root: Path, name: str, config: str, traffic: str, metrics=()) -> None:
    """``name`` in ``root``'s manifest, and in the per-layer ``metrics``'
    cells."""
    path = Path(root) / "BENCHMARK.json"
    man = json.loads(path.read_text())
    man["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                             "why": "a tiny cell for the CPU tests"})
    for m in man["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    path.write_text(json.dumps(man, indent=1))


def make_root(tmp: Path) -> Path:
    """A root at ``tmp`` holding the tiny cell beside the real ones; it
    reports every metric of ``dti-exact.serial``."""
    root = Path(tmp)
    shutil.copytree(REPO / "specbench", root / "specbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(REPO / "src")
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = tiny_config()
    (root / "specbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": cfg["name"], "source": cfg["source"][:200],
                           "file": f"specbench/configs/{cfg['name']}.json", "reduced": [],
                           "why": "a tiny copy for the CPU tests"})
    traffic = json.loads((REPO / "specbench" / "traffic" / "serial.json").read_text())
    traffic["datasets"] = 2
    (root / "specbench" / "traffic" / "tiny-serial.json").write_text(json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    add_cell(root, TINY_CELL, cfg["name"], "tiny-serial",
             [m["name"] for m in man["per_layer"] if "dti-exact.serial" in m["workloads"]])
    return root
