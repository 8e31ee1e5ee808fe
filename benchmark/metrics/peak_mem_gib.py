"""Peak device memory over the window, in GiB: max_memory_allocated, reset
when set-up ends and read when the window ends, before any check."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
