"""Roofline shares of the dispatch stages, from work counted on the data.

A share is the least time the card could take for the stage's work, at
the published peaks (core/peaks.py), over the device time of every
operation launched inside the dispatch entry point during the profiled
calls (core/trace.py). The work is counted from the cell's inputs and the
definition the stage computes, never from the windows, tiles, tiers or
launches the program chose, so a later kernel that does the same work
reads the same count:

- operations: one squared distance (DSQ_FLOPS) for each pair the result
  depends on, counted from the data, plus the epilogue per center that the
  definition needs;
- bytes: the coordinates and boxes read once, the outputs written once.

Each metric file (metrics/roofline.*.py) holds its count."""

from __future__ import annotations

import torch

from bench_torch.core.peaks import least_time

# a squared minimum-image distance: 3 subtractions, 3 products, 2 sums (the
# minimum image's corrections are not counted, so the count is a floor)
DSQ_FLOPS = 8


def min_image(d, box):
    return d - box * torch.round(d / box)


def pair_dsq(x: torch.Tensor, box: torch.Tensor, row_block: int = 4096):
    """Yield (r0, dsq (B, N)) float32: the squared minimum-image distances
    from rows r0:r0+B of one frame's x (N, 3) to all of it."""
    for r0 in range(0, x.shape[0], row_block):
        d = min_image(x[None, :, :] - x[r0:r0 + row_block, None, :], box)
        yield r0, (d * d).sum(-1)


def share(run, count) -> float | None:
    """Percent of the least time in the dispatch stage's device time over
    the profiled calls; `count(record) -> (flops, bytes)` counts the work of
    one call. None where nothing was profiled."""
    if run.profile is None or run.profile.dispatch_s <= 0 or not run.profiled:
        return None
    flops = nbytes = 0.0
    for rec in run.profiled:
        f, b = count(rec)
        flops, nbytes = flops + f, nbytes + b
    t, bound = least_time(flops, nbytes)
    run.note(f"roofline: {flops:.6e} flops, {nbytes:.6e} bytes over {len(run.profiled)} calls, "
             f"bound by {bound}: least {t:.9f} s against {run.profile.dispatch_s:.9f} s")
    return 100.0 * t / run.profile.dispatch_s
