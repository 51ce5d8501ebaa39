"""Set-up seconds: process start to the window's start (imports, CUDA
start, the kernels' load or first build, the corpus, the cell's own
set-up and warm-up)."""


def read(run):
    return run["setup_s"]
