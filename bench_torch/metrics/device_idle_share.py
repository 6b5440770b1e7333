"""`device_idle_share`: percent of the profiled calls' span in which no
kernel, copy or memset ran on the card: 1 - busy / span, from
torch.profiler (core/trace.py)."""


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * run.profile.idle_share
