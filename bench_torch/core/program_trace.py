"""The window's calls as the program's own tracer recorded them.

In a traced run each call of the window runs inside the program's
`stage_times()` block (waterorderlib_tpu_torch/core/clock.py), which also
records the call as a tree of spans with the counts added in each:
`topology`, `gather` (`gather_bytes`), `h2d` (`h2d_bytes`, device time from
CUDA events), `dispatch:*`, `kernel:*`, the stages, and the call's totals
(`voronoi:escalation:*`). `calls(run)` takes the recorded calls from the
program once and keeps them on the run for every reader. A program without
the tracer gives None, and its readers report nothing."""

from __future__ import annotations


def calls(run) -> list | None:
    """The recorded driver calls of the window (root spans `call:*`), or
    None where the program records none."""
    if not hasattr(run, "program_calls"):
        from waterorderlib_tpu_torch.core import clock

        take = getattr(clock, "recorded_calls", None)
        got = [c for c in take() if c.root.name.startswith("call:")] if take else []
        run.program_calls = got or None
    return run.program_calls


def spans(run, name: str) -> list | None:
    """[(call, span)] of every span `name` in the window's calls, or None
    where there is none."""
    got = calls(run)
    pairs = [(c, s) for c in got or () for s in c.named(name)]
    return pairs or None
