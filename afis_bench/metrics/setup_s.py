"""setup_s: process start to the window's first submission (host clock):
imports, the kernels' build or load, the gallery drawn and stored, the
pool packed and the cell's shapes warmed up."""


def read(run):
    return run.setup_s
