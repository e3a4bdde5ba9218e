"""Stage 2's seconds a job: the ``embed`` stage report's ``wall_s``, the
mean over the window's jobs."""


def read(run):
    return run.mean("stages", "embed")
