"""Seconds from a job's points to its labels: the window's wall time, from
the first job's start to the last job's end (host clock, each job ending in
a device synchronisation), over the number of whole jobs."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs else None
