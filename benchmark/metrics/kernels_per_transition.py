"""Device kernels per traced transition, library and port alike."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    return len(run.trace.kernels()) / run.traced
