"""Output check of the `hb_calc` cells whose box is too large for
checks/hbonds.py's reference blocks: the same three numbers, limits' names
and fault point (it reuses that check), with the plain reference
(reference/hbonds.py) computed one frame at a time. Its default block of 8
frames holds (8, n, n, 3) float64 displacements: 51.5 GB at 16,384
waters, 6.4 GB a frame."""

from __future__ import annotations

import numpy as np

from bench_torch.checks.hbonds import FAULT_AT, N_BINS, NAMES, capture, compare, program_answers
from bench_torch.core import compare as cmp
from bench_torch.reference.hbonds import counts_frames

__all__ = ["FAULT_AT", "NAMES", "capture", "compare", "program_answers", "reference_answers"]


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    c = counts_frames(pos, boxes, kw.get("dist_cut", 3.5), kw.get("ang_cut", 120.0), precision,
                      frame_block=1)
    tot = (c["acc_lo"] + c["don_lo"]).cpu().numpy()
    hist = [cmp.histogram(tot.ravel(), N_BINS, 0.0, float(N_BINS)),
            np.bincount([0], minlength=N_BINS) * tot.shape[0]]
    return {"acc": c["acc_lo"], "don": c["don_lo"], "bounds": c, "hist": hist,
            "hist_printed": [cmp.as_printed(h) for h in hist], "mean": float(tot.mean())}
