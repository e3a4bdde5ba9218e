"""One run of one cell: set-up, the measured window, the readers and the
check.  The runner times, reads and checks; what a cell does lives in the
files its names lead to (:mod:`specbench.harness`).

The traffic's loop, ``loops/<loop>.py``, defines ``Loop(ctx)`` with

* ``setup()``: builds the program's entry, makes the data (``ctx.dataset``)
  and runs every shape the window will use once; states ``ctx.run.sizes``;
* ``window(seconds, jobs)``: drives the program until ``seconds`` have
  passed and every job the check judges has run, appending a record a job
  (``wall_s``, what it read from the program, ``error`` if it failed);
* ``check()``: after the window, each number the configuration's check
  compares, by name, from the plain reference's reading of what it kept;
* ``close()``: takes off whatever it wrapped.

``ctx`` holds ``root``, ``cfg``, ``traffic``, ``seed``, ``device``, ``run``
and ``dataset(i)``: dataset ``i`` of the run, drawn from (``--seed``, i) by
the configuration's maker (``datasets/<maker>.py``: ``make(params, seed)``).

Besides ``read(run)``, a metric file may name what it needs recorded:

* ``COUNTERS = {name: "module:attr"}``: a function of the port whose
  ``.launches`` counter is read before and after the window
  (``run.launches[name]``, the launches in the window);
* ``CALLS = {name: ("module:attr.path", shape)}``: a function or method of
  the port wrapped for a traced run, which appends ``shape(*args, **kwargs)``
  of each call in the window to ``run.calls[name]``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from specbench import harness, trace as tr
from specbench.reference.judge import verdict


class Context(NamedTuple):
    root: Path
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    run: harness.Run
    dataset: Callable[[int], Dict[str, torch.Tensor]]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _resolve(target: str):
    """(owner, attribute) of ``"module:attr.path"``."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, name = path.split(".")
    for a in outer:
        owner = getattr(owner, a)
    return owner, name


class Recorder:
    """The metrics' counters, and in a traced run their call wrappers
    (installed for the run, recording only inside the window)."""

    def __init__(self, readers: List[Any], traced: bool):
        self.readers, self.traced = readers, traced
        self.counters: Dict[str, Any] = {}
        self.calls: Dict[str, list] = {}
        self.recording = False
        self._saved: List[tuple] = []

    def __enter__(self):
        for reader in self.readers:
            for name, target in getattr(reader, "COUNTERS", {}).items():
                self.counters[name] = getattr(*_resolve(target))
            if not self.traced:
                continue
            for name, (target, shape) in getattr(reader, "CALLS", {}).items():
                owner, attr = _resolve(target)
                orig = getattr(owner, attr)
                self._saved.append((owner, attr, orig))
                setattr(owner, attr, self._wrap(name, orig, shape))
        return self

    def _wrap(self, name: str, orig, shape):
        def wrapped(*a, **kw):
            if self.recording:
                self.calls.setdefault(name, []).append(shape(*a, **kw))
            return orig(*a, **kw)
        return wrapped

    def launches(self) -> Dict[str, int]:
        return {name: fn.launches for name, fn in self.counters.items()}

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> Dict[str, Any]:
    """One run of ``workload``.  Returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``check``) and the ``run``."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    man = harness.manifest(root)
    wl = harness.cell(man, workload)
    cfg = json.loads(harness.config_path(root, man, wl["config"]).read_text())
    traffic = json.loads(harness.part_path(root, "traffic", wl["traffic"]).read_text())
    maker = harness.load_module(harness.part_path(root, "datasets", cfg["data"]["maker"]))
    loop_mod = harness.load_module(harness.part_path(root, "loops", traffic["loop"]))
    readers = [(m, harness.load_module(harness.part_path(root, "metrics", m["name"])))
               for m in harness.metrics_for(man, workload, traced)]
    src = str(root / "src")  # the port, ``src/repro_torch`` of the checkout
    if src not in sys.path:
        sys.path.insert(0, src)

    dev = torch.device(device)
    run = harness.Run(wl, cfg, traffic, device)
    ctx = Context(root, cfg, traffic, seed, dev, run,
                  lambda i: maker.make(cfg["data"], harness.data_seed(seed, i)))
    loop = loop_mod.Loop(ctx)
    try:
        with Recorder([r for _, r in readers], traced) as rec:
            loop.setup()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            run.setup_s = time.perf_counter() - t_start
            print(f"set-up: {run.setup_s:.2f} s", file=sys.stderr)

            prof_ctx = contextlib.nullcontext()
            if traced:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof_ctx = profile(activities=acts)
            before = rec.launches()
            rec.recording = True
            with prof_ctx as profiler:
                w0 = time.perf_counter()
                loop.window(seconds, run.jobs)
                run.window_s = time.perf_counter() - w0
            rec.recording = False
            run.launches = {k: v - before[k] for k, v in rec.launches().items()}
            run.calls = rec.calls
            if dev.type == "cuda":
                run.peak_bytes = torch.cuda.max_memory_allocated(dev)

        breakdown = None
        if traced:
            t_trace = time.perf_counter()
            run.trace = tr.reduce(profiler)
            print(f"trace: {len(run.trace.device)} device and {len(run.trace.host)} host "
                  f"operations read in {time.perf_counter() - t_trace:.2f} s", file=sys.stderr)
            breakdown = {"device_ops": tr.top_ops(run.trace),
                         "idle_gaps": tr.idle_gaps(run.trace)}
            del profiler

        metrics = {}
        for m, reader in readers:
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        # -- the check, after the window and the peak ------------------------
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        nums = loop.check()
        print(f"check: {time.perf_counter() - t_check:.2f} s: {json.dumps(nums)}",
              file=sys.stderr)
    finally:
        loop.close()
    failed = sum(1 for j in run.jobs if "error" in j)
    correct, shown = verdict(nums, cfg["check"]["limits"])
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if traced:
        info.update(busy_s=run.trace.busy_s, window_s=run.window_s)
    return dict(correct=correct and failed == 0 and bool(nums), attempted=len(run.jobs),
                failed=failed, metrics=metrics, device=info, breakdown=breakdown, check=shown,
                run=run)
