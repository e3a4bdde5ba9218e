"""Peak device memory over the window, in GB (1e9 bytes): the allocator's
``max_memory_allocated`` after a reset just before the first timed job."""


def read(run):
    return run.peak_bytes / 1e9 if run.device != "cpu" else None
