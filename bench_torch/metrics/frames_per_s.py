"""`frames_per_s`: frames of every call completed in the window over the
time from the window's start to the last completion (host clock)."""

from bench_torch.core.window import frames_per_s


def read(run):
    return frames_per_s(run.window)
