"""Stage 1's seconds a job: the ``prepare`` stage report's ``wall_s`` (the
port's host clock, synchronised), the mean over the window's jobs."""


def read(run):
    return run.mean("stages", "prepare")
