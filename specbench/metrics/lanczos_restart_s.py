"""Device seconds a job of the block-Lanczos restarts: the program's
``lanczos.restart`` spans (the end of each cycle: the float64 ``eigh`` of
T and the residuals, the cycle's flag read, a careful replay if any, the
Ritz rotation), as :mod:`lanczos_orth_s` reads its spans."""
from specbench.metrics.lanczos_orth_s import seconds_a_job


def read(run):
    return seconds_a_job(run, "lanczos.restart")
