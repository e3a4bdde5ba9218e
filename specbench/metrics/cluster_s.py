"""Stage 3's seconds a job: the ``cluster`` stage report's ``wall_s``, the
mean over the window's jobs."""


def read(run):
    return run.mean("stages", "cluster")
