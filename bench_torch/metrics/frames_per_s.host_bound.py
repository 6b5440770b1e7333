"""`frames_per_s.host_bound`: `frames_per_s` (frames of every call completed
in the window over the time from the window's start to the last completion,
host clock) in the cells where it is a per-layer metric: those whose calls
wait on the host so much that the rate follows the speed of the machine's
shared CPU cores from run to run by more than any end-to-end bound allows.
There the cell's end-to-end metric besides `setup_s` is `memory_peak_mib`."""

from bench_torch.core.window import frames_per_s


def read(run):
    return frames_per_s(run.window)
