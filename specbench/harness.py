"""The manifest, the files found by name, and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; every piece is a file of its own, looked up by name:

* ``configs/<config>.json``: the deployment: its data (``data.maker``
  names ``datasets/<maker>.py``, the rest are that maker's parameters), the
  pipeline as the port's ``SpectralPipeline.from_dict`` reads it, the
  guarantees, and the check's limits;
* ``traffic/<mix>.json``: the mix's parameters; ``loop`` names
  ``loops/<loop>.py``, the job loop that drives the program's entry and
  keeps what the check judges;
* ``metrics/<metric>.py``: a reader, ``read(run)`` → a number or None, and
  what it needs recorded (``COUNTERS``, ``CALLS``: :mod:`specbench.runner`).

A name that is not 1 to 64 of ``[A-Za-z0-9_.-]``, starting with a letter, a
digit or ``_``, is refused before any file is looked up.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
JAX_MODULES = ("jax", "jaxlib", "flax", "repro")
PARTS = {"traffic": ".json", "loops": ".py", "datasets": ".py", "metrics": ".py"}


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(man: dict, workload: str) -> dict:
    check_name(workload)
    for c in man["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_path(root: Path, man: dict, name: str) -> Path:
    check_name(name)
    for c in man["configs"]:
        if c["name"] == name:
            return Path(root) / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def part_path(root: Path, kind: str, name: str) -> Path:
    """``specbench/<kind>/<name>`` with the kind's suffix (:data:`PARTS`)."""
    return Path(root) / "specbench" / kind / f"{check_name(name)}{PARTS[kind]}"


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"specbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones; an entry with ``workloads``
    only in those cells, a per-layer one without it in every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    shown = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in shown)]


SETUP_JOB = 2**32 + 1  # the set-up's job, apart from the window's


def job_seed(seed: int, j: int) -> int:
    """The seed of job ``j`` (≥ 0) of a run of ``seed`` (any whole number):
    63 bits."""
    return int(np.random.SeedSequence([int(seed) % 2**64, j]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def data_seed(seed: int, i: int) -> int:
    """The seed of dataset ``i`` of a run of ``seed``: 63 bits, apart from
    every job's."""
    return int(np.random.SeedSequence([int(seed) % 2**64, 2**33, i]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def judged(seed: int, among: int, count: int) -> List[int]:
    """``count`` distinct jobs of the window's first ``among``, drawn from
    the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 2**32]))
    return sorted(int(j) for j in rng.choice(among, size=min(count, among), replace=False))


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_MODULES))


class Run:
    """What a run measured, for the metric readers: the cell, its
    configuration and traffic, the device, the jobs of the window (each a
    dict the loop fills: ``wall_s`` and what it reads from the program), the
    window's seconds, the set-up seconds, the peak bytes, the launches in
    the window of each counter a metric names (``launches[name]``), the
    calls each metric records (``calls[name]``: one shape tuple a call), the
    problem's sizes the loop states (``sizes``) and, in a traced run, the
    reduced trace."""

    def __init__(self, workload: dict, config: dict, traffic: dict, device: str):
        self.workload, self.config, self.traffic, self.device = workload, config, traffic, device
        self.jobs: List[Dict[str, Any]] = []
        self.window_s = math.nan
        self.setup_s = math.nan
        self.peak_bytes = 0
        self.launches: Dict[str, int] = {}
        self.calls: Dict[str, list] = {}
        self.sizes: Dict[str, int] = {}
        self.trace = None

    def mean(self, key: str, sub: Optional[str] = None):
        vals = [(j.get(key) if sub is None else j.get(key, {}).get(sub)) for j in self.jobs]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                breakdown: Optional[dict], check: dict) -> str:
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check  # last: each number compared beside its limit
    return json.dumps(_finite(out), allow_nan=False)


def _finite(v):
    """``v`` with every non-finite float as its name (JSON has none)."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    return v
