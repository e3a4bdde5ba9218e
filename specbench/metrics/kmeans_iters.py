"""Lloyd iterations a job (``SpectralResult.kmeans_iterations``), the mean
over the window's jobs."""


def read(run):
    return run.mean("kmeans_iterations")
