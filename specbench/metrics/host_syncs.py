"""Points a job where the host waited for the device: the program's
``host.sync`` spans (each a read of a device value, or a stage's closing
synchronisation) in the traced window, over its jobs."""
from specbench.metrics.lanczos_orth_s import spans_named


def read(run):
    kept = spans_named("host.sync")
    return len(kept) / len(run.jobs) if kept and run.jobs else None
