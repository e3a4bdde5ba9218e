"""Device seconds a job of the block-Lanczos Gram–Schmidt passes: the
program's ``lanczos.orth`` spans (``repro_torch.spans``: two a block step,
the two passes against the basis and the cleanup pass), each the time
between its two CUDA events on the stream, summed over the traced window
and divided by its jobs.  Silent where the program keeps no such spans (a
program without ``repro_torch.spans``, an untraced run).  The other span
metrics read their spans through :func:`spans_named`."""


def spans_named(name):
    """The window's kept spans of ``name`` (``repro_torch.spans.records()``),
    or an empty list where the program has none."""
    try:
        from repro_torch import spans
    except ImportError:  # a program without spans
        return []
    return [r for r in spans.records() if r.name == name]


def seconds_a_job(run, name):
    """The device seconds of the spans of ``name`` over the window's jobs."""
    kept = spans_named(name)
    if not kept or not run.jobs:
        return None
    return sum(r.device_s for r in kept) / len(run.jobs)


def read(run):
    return seconds_a_job(run, "lanczos.orth")
