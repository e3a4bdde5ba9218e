"""Device idle seconds a job inside Stage 2: in the trace of the window, each
``spectral.embed`` host range (the program's stage span, from the stage's
start through its closing synchronisation) less the union of the device
operations clipped to it, summed and divided by the jobs.  Each stage span
ends in a synchronisation, as the one before it did, so the stage's device
work lies inside its range.  Silent where the trace holds no such range."""
import bisect


def stage_idle_s(run, name):
    """The device's idle seconds inside the host ranges ``name``, a job."""
    if run.trace is None or not run.jobs:
        return None
    ranges = sorted((s, t) for n, s, t in run.trace.host if n == name)
    if not ranges:
        return None
    dev = run.trace.device  # sorted by start
    starts = [s for _, s, _ in dev]
    reach, end = [], float("-inf")  # the latest end among the operations so far
    for _, _, t in dev:
        end = max(end, t)
        reach.append(end)
    idle = 0.0
    for s, t in ranges:
        i = bisect.bisect_left(starts, s)
        # an operation started before the range covers it from its start
        covered = min(max(reach[i - 1], s), t) if i else s
        busy = covered - s
        while i < len(dev) and dev[i][1] < t:
            a, b = max(dev[i][1], covered), min(dev[i][2], t)
            if b > a:
                busy += b - a
                covered = b
            i += 1
        idle += (t - s) - busy
    return idle / len(run.jobs)


def read(run):
    return stage_idle_s(run, "spectral.embed")
