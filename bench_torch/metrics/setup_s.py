"""`setup_s`: seconds from the process's start (the first line of run.py)
to the window's first call: imports, the card's start, the kernels' build
or load, the frames made from the seed and the warm-up call."""


def read(run):
    return run.setup_s
