"""Device seconds a job of the block-Lanczos QRs: the program's
``lanczos.qr`` spans (two [n × b] QRs a block step), as
:mod:`lanczos_orth_s` reads its spans."""
from specbench.metrics.lanczos_orth_s import seconds_a_job


def read(run):
    return seconds_a_job(run, "lanczos.qr")
