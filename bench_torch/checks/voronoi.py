"""Output check of the `voronoi_calc` cells, in three layers: each water's
Voronoi volume and area as the device engine returned them, the driver's
histogram files, and the means it returns, each against the plain
reference (reference/voronoi.py, Qhull in float64) on the same frames.
The reference's frames run on worker processes, one per host core but one."""

from __future__ import annotations

import os

import numpy as np

from bench_torch.core import compare as cmp
from bench_torch.reference.voronoi import cells_frames

NAMES = ("volume_gap", "area_gap", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.surface.voronoi_device", "voronoi_volumes_hybrid_frames")
# the driver's histograms: (file prefix, quantity, range), 500 bins each
HISTS = (("Vol", "vol", (10.0, 60.0)), ("Area", "area", (10.0, 100.0)), ("Eta", "eta", (1.0, 2.5)))


def capture(out):
    """What is kept of one dispatch (voronoi_volumes_hybrid_frames, one
    chunk of frames): (volumes, areas), float64 numpy (chunk, n)."""
    return np.array(out[0]), np.array(out[1])


def _eta(vol, area):
    return np.where(np.isinf(vol) | np.isinf(area), np.inf,
                    area ** 3 / (36.0 * np.pi * np.maximum(vol, 1e-300) ** 2))


def _stats(vol, area):
    """The driver's returned means: per frame the mean and variance of the
    finite values, then their means over frames."""
    out = []
    for v in (vol, area, _eta(vol, area)):
        v = np.where(np.isinf(v), np.nan, v)
        out += [np.nanmean(np.nanmean(v, 1)), np.nanmean(np.nanvar(v, 1))]
    return np.array(out)


def program_answers(call) -> dict:
    vol = np.concatenate([c[0] for c in call.captured])
    area = np.concatenate([c[1] for c in call.captured])
    hist = [cmp.read_hist(os.path.join(call.out_dir, f"{p}Distribution_0.txt")) for p, _, _ in HISTS]
    means = np.array([row[0][0] for row in call.result])
    return {"vol": vol, "area": area, "hist_printed": hist, "means": means}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    oxy = cmp.at_precision(pos[:, 0::3], precision).double().cpu().numpy()
    box_ls = cmp.at_precision(boxes[:, 0], precision).double().cpu().numpy()
    vol, area = cells_frames(list(oxy), list(box_ls), workers=max(1, (os.cpu_count() or 2) - 1))
    vals = {"vol": vol, "area": area, "eta": _eta(vol, area)}
    hist = [cmp.histogram(vals[k][np.isfinite(vals[k])], 500, *rng) for _, k, rng in HISTS]
    return {"vol": vol, "area": area, "hist": hist,
            "hist_printed": [cmp.as_printed(h) for h in hist], "means": _stats(vol, area)}


def compare(prog: dict, ref: dict) -> dict:
    return {
        "volume_gap": cmp.rel_gap(prog["vol"], ref["vol"]),
        "area_gap": cmp.rel_gap(prog["area"], ref["area"]),
        "hist_excess": max(cmp.hist_excess(p, r) for p, r in zip(prog["hist_printed"], ref["hist"])),
        "mean_gap": cmp.rel_gap(prog["means"], ref["means"]),
    }
