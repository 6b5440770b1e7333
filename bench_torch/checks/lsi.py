"""Output check of the `lsi_calc` cells, in three layers: the dispatch's
per-center LSI and validity, the driver's histogram files, and the
population means it returns, each against the plain reference
(reference/lsi.py) on the same frames and populations."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.reference.lsi import lsi_frames

N_BINS, LO, HI = 500, 0.0, 0.3
NAMES = ("lsi_gap", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.ops.cuda.lsi", "lsi_window")
# the split tier, which lsi_certified takes at the cell's 16,384 waters, has
# a launch of its own that FAULT_AT's K = 24 kernel does not reach; the
# tests take it at the CPU's tiny size by holding `split_tier` true
TIER_FAULTS = {"slab-split": {"at": ("waterorderlib_tpu_torch.ops.cuda.lsi", "lsi_split_window"),
                              "force": ("waterorderlib_tpu_torch.ops.cuda.lsi", "split_tier")}}


def capture(out):
    """What is kept of one dispatch (lsi_certified): (lsi, valid)."""
    return out[0], out[1]


def program_answers(call) -> dict:
    lsi = torch.cat([c[0] for c in call.captured], 0)
    valid = torch.cat([c[1] for c in call.captured], 0)
    hist = [cmp.read_hist(os.path.join(call.out_dir, f"lsiDistribution_{j}.txt"))
            for j in (0, 1)]
    avg, var = call.result
    return {"values": lsi, "valid": valid, "hist_printed": hist,
            "means": (np.asarray(avg[0]), np.asarray(var[0]))}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    lsi, valid, amb = lsi_frames(pos[:, 0::3], boxes, kw.get("low_cut", 0.0),
                                 kw.get("high_cut", 3.7), precision)
    masks = cmp.masks_of(call.sub_inds, lsi.shape[0], lsi.shape[1], lsi.device)
    masks = masks & valid[:, None, :]
    hist = [cmp.histogram(lsi[masks[:, j]].cpu().numpy(), N_BINS, LO, HI) for j in (0, 1)]
    return {"values": lsi, "valid": valid, "ambiguous": amb, "hist": hist,
            "hist_printed": [cmp.as_printed(h) for h in hist],
            "means": cmp.pop_mean_var(lsi, masks)}


def compare(prog: dict, ref: dict) -> dict:
    """lsi_gap: the largest |LSI - reference| over the rows that are not
    ambiguous and valid on either side; a row valid on one side only is an
    infinite gap."""
    rows = ~ref["ambiguous"] & (ref["valid"] | prog["valid"])
    gap = (prog["values"].to(torch.float64) - ref["values"].to(torch.float64)).abs()
    gap = torch.where(torch.isnan(gap) | (prog["valid"] != ref["valid"]), torch.inf, gap)
    return {
        "lsi_gap": float(gap[rows].max()) if bool(rows.any()) else 0.0,
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": max(cmp.max_gap(p, r) for p, r in zip(prog["means"], ref["means"])),
    }
