"""Device idle seconds a job inside Stage 3: the ``spectral.cluster`` host
ranges of the trace less the device operations in them, as
:mod:`embed_idle_s` reads Stage 2's."""
from specbench.metrics.embed_idle_s import stage_idle_s


def read(run):
    return stage_idle_s(run, "spectral.cluster")
