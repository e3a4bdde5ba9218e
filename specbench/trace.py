"""Reduction of a ``torch.profiler`` trace of the measured window to what the
per-layer metrics and the result's ``breakdown`` read: each device
operation's name and interval, the device's busy seconds (the union of those
intervals), and the idle gaps named by what the host was doing then."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple



class Trace(NamedTuple):
    device: List[Tuple[str, float, float]]  # (name, start_s, end_s), device operations
    host: List[Tuple[str, float, float]]  # (name, start_s, end_s), host operations
    busy_s: float


def _events(prof):
    """(name, is_device, start_s, end_s) of every event of ``prof``, read
    from the profiler's raw records (building its event tree takes minutes
    for the millions of records of a window)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    base = None  # times from the first record, so a double keeps every nanosecond
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        base = s if base is None else base
        yield e.name(), e.device_type() == cuda, (s - base) * 1e-9, (s - base + d) * 1e-9


def reduce(prof) -> Trace:
    device, host = [], []
    for name, is_dev, s, t in _events(prof):
        (device if is_dev else host).append((name, s, t))
    device.sort(key=lambda e: e[1])
    host.sort(key=lambda e: e[1])
    busy, end = 0.0, None
    for _, s, t in device:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return Trace(device, host, busy)


def kernel_seconds(trace: Trace, patterns) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds one of
    ``patterns``."""
    sel = [t - s for name, s, t in trace.device if any(p in name for p in patterns)]
    return sum(sel), len(sel)


def top_ops(trace: Trace, n: int = 10) -> List[list]:
    """The ``n`` device operations that took the most time, by name."""
    tot: Dict[str, float] = defaultdict(float)
    for name, s, t in trace.device:
        tot[name[:120]] += t - s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10, longest: int = 2000) -> List[list]:
    """The ``longest`` gaps between device operations, named by the
    innermost host operation running at the gap's start and summed by that
    name; the ``n`` names with the most idle seconds."""
    gaps, end = [], None
    for _, s, t in trace.device:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = t if end is None else max(end, t)
    gaps.sort(reverse=True)
    starts = [h[1] for h in trace.host]
    tot: Dict[str, float] = defaultdict(float)
    for length, at in gaps[:longest]:
        i = bisect.bisect_right(starts, at)
        name = "no host operation"
        # the innermost host operation covering `at`: the latest-starting one
        for j in range(i - 1, max(-1, i - 400), -1):
            hname, hs, ht = trace.host[j]
            if ht >= at:
                name = hname
                break
        tot[name[:120]] += length
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
