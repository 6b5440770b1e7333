"""Output check of the `tet_order_calc` cells, in three layers: the
dispatch's per-center q, the driver's histogram files, and the population
means it returns, each against the plain reference (reference/q.py) on the
same frames and populations."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.reference.q import q_frames

N_BINS, LO, HI = 500, 0.0, 1.0
NAMES = ("q_gap", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.ops.cuda.qtet2", "q_window")


def capture(out):
    """What is kept of one dispatch (order_param_q_certified): q (F, N)."""
    return out


def program_answers(call) -> dict:
    q = torch.cat([c for c in call.captured], 0)
    hist = [cmp.read_hist(os.path.join(call.out_dir, f"qDistribution_{j}.txt")) for j in (0, 1)]
    avg, var = call.result
    return {"values": q, "hist_printed": hist,
            "means": (np.asarray(avg[0]), np.asarray(var[0]))}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    q, amb = q_frames(pos[:, 0::3], boxes, kw.get("low_cut", 0.0), kw.get("high_cut", 10.0),
                      precision)
    masks = cmp.masks_of(call.sub_inds, q.shape[0], q.shape[1], q.device)
    hist = [cmp.histogram(q[masks[:, j]].cpu().numpy(), N_BINS, LO, HI) for j in (0, 1)]
    return {"values": q, "ambiguous": amb, "hist": hist,
            "hist_printed": [cmp.as_printed(h) for h in hist],
            "means": cmp.pop_mean_var(q, masks)}


def compare(prog: dict, ref: dict) -> dict:
    keep = ~ref["ambiguous"]
    gap = (prog["values"].to(torch.float64) - ref["values"].to(torch.float64)).abs()
    gap = torch.where(torch.isnan(gap), torch.inf, gap)
    return {
        "q_gap": float(gap[keep].max()) if bool(keep.any()) else 0.0,
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": max(cmp.max_gap(p, r) for p, r in zip(prog["means"], ref["means"])),
    }
