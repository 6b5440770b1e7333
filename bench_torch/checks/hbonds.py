"""Output check of the `hb_calc` cells, in three layers: the dispatch's
per-frame counts of each water's accepted and donated bonds, the driver's
histogram files, and the mean it returns, each against the plain
reference (reference/hbonds.py) on the same frames."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.reference.hbonds import counts_frames

N_BINS = 10
NAMES = ("count_out", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.ops.cuda.hbond", "hbond_dense")


def capture(out):
    """What is kept of one dispatch (hbond_counts_certified): (acceptor
    counts (F, n), donor-entry counts (F, 2 n))."""
    return out[0], out[1]


def _donated(don: torch.Tensor) -> torch.Tensor:
    """Donor entries (F, 2 n), a water's two hydrogens side by side -> (F, n)."""
    return don.reshape(don.shape[0], -1, 2).sum(-1)


def program_answers(call) -> dict:
    acc = torch.cat([c[0] for c in call.captured], 0).to(torch.int64)
    don = _donated(torch.cat([c[1] for c in call.captured], 0)).to(torch.int64)
    hist = [cmp.read_hist(os.path.join(call.out_dir, f"hbDistribution_{k}.txt"))
            for k in ("water", "cosolv")]
    return {"acc": acc, "don": don, "hist_printed": hist, "mean": float(call.result[0])}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    c = counts_frames(pos, boxes, kw.get("dist_cut", 3.5), kw.get("ang_cut", 120.0), precision)
    tot = (c["acc_lo"] + c["don_lo"]).cpu().numpy()
    hist = [cmp.histogram(tot.ravel(), N_BINS, 0.0, float(N_BINS)),
            np.bincount([0], minlength=N_BINS) * tot.shape[0]]
    return {"acc": c["acc_lo"], "don": c["don_lo"], "bounds": c, "hist": hist,
            "hist_printed": [cmp.as_printed(h) for h in hist], "mean": float(tot.mean())}


def compare(prog: dict, ref: dict) -> dict:
    b = ref["bounds"]
    out = ((prog["acc"] < b["acc_lo"]) | (prog["acc"] > b["acc_hi"])
           | (prog["don"] < b["don_lo"]) | (prog["don"] > b["don_hi"]))
    return {
        "count_out": int(out.sum()),
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": abs(prog["mean"] - ref["mean"]),
    }
