"""Arithmetic over a measured window of closed-loop calls.

A window starts at t = 0 and holds every call started before it closed;
each call records its start and end in seconds from the window's start and
the frames it analysed."""

from __future__ import annotations

import statistics
from typing import NamedTuple


class Call(NamedTuple):
    start: float
    end: float
    frames: int


def frames_per_s(calls: list[Call]) -> float | None:
    """Frames of every completed call over the time from the window's start
    to the last completion."""
    if not calls:
        return None
    return sum(c.frames for c in calls) / max(c.end for c in calls)


def percentile_ms(calls: list[Call], pct: int) -> float | None:
    """The pct-th percentile of the calls' walls in ms, by Python's
    `statistics.quantiles(n=100)` (the exclusive method); None with fewer
    than two calls."""
    walls = [(c.end - c.start) * 1e3 for c in calls]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100)[pct - 1]

