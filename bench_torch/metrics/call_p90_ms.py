"""`call_p90_ms`: the 90th percentile of the walls of all the window's
calls, in ms (host clock)."""

from bench_torch.core.window import percentile_ms


def read(run):
    return percentile_ms(run.window, 90)
