"""Output check of the `hex_order_calc` cells, in three layers: the
dispatch's psi6 and shell count per center, the driver's histogram file,
and the two population means it returns, each against the plain reference
(reference/hex.py) on the same frames.

The dispatch (`psi6_certified`) returns (psi (F, N), count (F, N)) over
the chain ends, every other oxygen of the box. The traffic has no
population: the driver's only population is every end (slot 0)."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.reference.hex import ends, population_stats, psi6_frames

NAMES = ("psi_gap", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.ops.cuda.psi6", "psi6_window")


def capture(out):
    """What is kept of one dispatch (psi6_certified): (psi (F, N), count
    (F, N))."""
    return out[0], out[1]


def program_answers(call) -> dict:
    psi = torch.cat([c[0] for c in call.captured], 0)
    count = torch.cat([c[1] for c in call.captured], 0).to(torch.int64)
    avg, var = call.result
    return {"psi": psi, "count": count,
            "hist_printed": [cmp.read_hist(os.path.join(call.out_dir, "psiDistribution_0.txt"))],
            "means": (np.asarray(avg[0]), np.asarray(var[0]))}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    psi, count, amb = psi6_frames(ends(pos), boxes, kw.get("low_cut", 0.0),
                                  kw.get("high_cut", 7.0), precision)
    every_end = torch.ones((psi.shape[0], 1, psi.shape[1]), dtype=torch.bool, device=psi.device)
    hist, means = population_stats(psi, every_end)
    return {"psi": psi, "count": count, "ambiguous": amb, "hist": list(hist),
            "hist_printed": [cmp.as_printed(h) for h in hist], "means": means}


def compare(prog: dict, ref: dict) -> dict:
    """psi_gap: over the rows that are not ambiguous, the largest gap of
    psi6 to the reference's; a row whose shell count differs, or whose
    psi6 is NaN, is an infinite gap. hist_excess: the printed file's
    counts beyond `%.3e` rounding, as a share of the reference's.
    mean_gap: the largest relative gap of the two returned means (avgPsi,
    varPsi), each relative to the reference's."""
    keep = ~ref["ambiguous"]
    gap = (prog["psi"].to(torch.float64) - ref["psi"]).abs()
    gap = torch.where(torch.isnan(gap) | (prog["count"] != ref["count"]), torch.inf, gap)
    return {
        "psi_gap": float(gap[keep].max()) if bool(keep.any()) else 0.0,
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": cmp.rel_gap(np.concatenate(prog["means"]), np.concatenate(ref["means"])),
    }
