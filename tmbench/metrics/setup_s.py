"""setup_s: seconds from the start of run.py to the window (imports, the
kernels' build or cached build, the cell's inputs, warm-up)."""


def read(run):
    return run["setup_s"]
