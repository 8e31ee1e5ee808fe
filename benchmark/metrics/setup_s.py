"""Set-up seconds: from the process's start (imports, building the program,
making its weights, the kernels' build or load, one warm-up transition) to
the window."""


def read(run):
    return run.setup_s
