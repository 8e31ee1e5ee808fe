"""Seconds per transition: the window's wall over the transitions completed
in it (the one in flight at the end finishes and counts)."""


def read(run):
    return run.window_s / len(run.records) if run.records else None
