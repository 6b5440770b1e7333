"""Output check of the `three_body_calc` cells, in three layers: the
dispatch's pair angles and shell counts per center, the driver's histogram
files, and the five population means it returns, each against the plain
reference (reference/three_body.py) on the same frames and populations.

The dispatch returns (ang (F, N, 128), count (F, N)): slot p holds the
angle of the pair (a, b) of the K = 16 nearest shell neighbors, a < b in
the order a runs over 0..15 and b over a+1..15, and is an answer iff
b < min(count, 16). A row's answers are compared as a sorted set, so the
order in which the program picks its neighbors does not matter."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.reference.three_body import K, N_PAIRS, PAIR_B, angles_frames, population_stats

NAMES = ("angle_gap", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.ops.cuda.angles", "angles_window")


def capture(out):
    """What is kept of one dispatch (neighbor_pair_angles_certified):
    (ang (F, N, 128), count (F, N))."""
    return out[0], out[1]


def _sorted_answers(ang, count, frame_block: int = 64) -> torch.Tensor:
    """The program's (F, N, 128) angles -> (F, N, 120) float32, each row's
    answers ascending and +inf after them."""
    pb = PAIR_B.to(ang.device)
    out = torch.empty(ang.shape[:2] + (N_PAIRS,), dtype=torch.float32, device=ang.device)
    for f0 in range(0, ang.shape[0], frame_block):
        a = ang[f0:f0 + frame_block, :, :N_PAIRS]
        ok = pb < count[f0:f0 + frame_block].to(torch.int64).clamp(max=K)[..., None]
        out[f0:f0 + frame_block] = torch.sort(torch.where(ok, a, torch.inf), dim=-1).values
    return out


def program_answers(call) -> dict:
    count = torch.cat([c[1] for c in call.captured], 0).to(torch.int64)
    angles = _sorted_answers(torch.cat([c[0] for c in call.captured], 0), count)
    hist = [cmp.read_hist(os.path.join(call.out_dir, f"3bDistribution_{j}.txt"))
            for j in (0, 1)]
    return {"angles": angles, "count": count, "hist_printed": hist,
            "means": tuple(np.asarray(r[0]) for r in call.result)}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    angles, count, amb = angles_frames(pos[:, 0::3], boxes, kw.get("low_cut", 0.0),
                                       kw.get("high_cut", 3.413), precision)
    masks = cmp.masks_of(call.sub_inds, angles.shape[0], angles.shape[1], angles.device)
    hist, means = population_stats(angles, masks)
    return {"angles": angles, "count": count, "ambiguous": amb, "hist": list(hist),
            "hist_printed": [cmp.as_printed(h) for h in hist], "means": means}


def compare(prog: dict, ref: dict, frame_block: int = 64) -> dict:
    """angle_gap: over the rows that are not ambiguous, the largest gap in
    degrees between the program's and the reference's sorted answers; a
    row whose shell count differs is an infinite gap. mean_gap: the
    largest relative gap of the five returned means (pTet, avgCos, varCos,
    entropy, nWats), each relative to the reference's."""
    gap = 0.0
    for f0 in range(0, ref["angles"].shape[0], frame_block):
        sl = slice(f0, f0 + frame_block)
        rows = ~ref["ambiguous"][sl]
        if not bool(rows.any()):
            continue
        pa, ra = prog["angles"][sl].to(torch.float64), ref["angles"][sl]
        fin = torch.isfinite(ra)
        d = torch.where(fin, (pa - ra).abs(), 0.0)
        d = torch.where(fin & torch.isnan(d), torch.inf, d)
        row = d.amax(-1)
        row = torch.where(prog["count"][sl] != ref["count"][sl], torch.inf, row)
        gap = max(gap, float(row[rows].max()))
    return {
        "angle_gap": gap,
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": cmp.rel_gap(np.concatenate(prog["means"]), np.concatenate(ref["means"])),
    }
