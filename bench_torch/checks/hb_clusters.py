"""Output check of the `get_hb_cluster_stats` cells over a water box, every
water one residue, in three layers: the dispatch's cluster sizes of each
frame, the driver's `clusterDistribution.txt`, and the mean cluster size it
returns, each against the plain reference (reference/hb_clusters.py) on the
same frames.

The dispatch (`hb_cluster_block`) returns (sizes (fb, n) int32, bonded
residue pairs); a frame's cluster sizes are its sizes' nonzero entries.
The reference gives each frame's clusters without its ambiguous pairs (lo)
and with them (hi), pairs within float32 reach of a cut that the program
may fairly bond either way. Where lo and hi agree the frame's clusters are
decided and `sizes_out` compares them. Where they differ, the program's
clusters are lo's merged at most len(lo) - len(hi) times: each merge moves
at most 3 counts of the distribution and puts the frame's mean size
between n / len(lo) and n / len(hi), and the file and the mean are held to
those ranges."""

from __future__ import annotations

import os

import numpy as np
import torch

from bench_torch.reference.hb_clusters import clusters_frames

NAMES = ("sizes_out", "hist_excess", "mean_gap")
FAULT_AT = ("waterorderlib_tpu_torch.hbonds.clusters", "hb_cluster_block")
MERGE_COUNTS = 3  # counts of the size distribution one merge of two clusters moves


def capture(out):
    """What is kept of one dispatch (hb_cluster_block): sizes (fb, n)."""
    return out[0]


def _sorted_sizes(sizes: torch.Tensor) -> list:
    return [np.sort(row[row > 0]) for row in sizes.cpu().numpy().astype(np.int64)]


def _distribution(sizes: list, n: int) -> np.ndarray:
    """Clusters of each size 1..n summed over frames, as the driver's file."""
    return sum(np.bincount(s, minlength=n + 1)[1:] for s in sizes)


def _mean_size(sizes: list, n: int) -> float:
    return float(np.mean([n / len(s) for s in sizes]))


def program_answers(call) -> dict:
    sizes = torch.cat(list(call.captured), 0)
    dist = np.loadtxt(os.path.join(call.out_dir, "clusterDistribution.txt"), ndmin=2)[:, 1]
    return {"sizes": _sorted_sizes(sizes), "hist_printed": dist,
            "mean": float(call.result[0])}


def reference_answers(call, precision: str) -> dict:
    pos, boxes = call.inputs()
    kw = call.kwargs
    n = pos.shape[1] // 3
    lo, hi = clusters_frames(pos, boxes, kw.get("dist_cut", 3.0), kw.get("ang_cut", 150.0),
                             precision)
    dist, mean = _distribution(lo, n), _mean_size(lo, n)
    return {"sizes": lo, "ambiguous": np.array([len(a) != len(b) for a, b in zip(lo, hi)]),
            "hist": dist, "hist_printed": dist.astype(np.float64),
            "hist_slack": MERGE_COUNTS * sum(len(a) - len(b) for a, b in zip(lo, hi)),
            "mean": mean, "mean_range": (mean, _mean_size(hi, n))}


def compare(prog: dict, ref: dict) -> dict:
    """sizes_out: the frames whose clusters no ambiguous pair can change and
    whose sorted cluster sizes differ from the reference's (a differing
    number of frames counts every frame). hist_excess: the sum over sizes
    of |file - reference| beyond what the ambiguous frames' merges can
    move, over the reference's clusters (the file holds whole counts).
    mean_gap: how far the returned mean cluster size lies outside the
    range the ambiguous pairs allow, relative to the reference's mean."""
    if len(prog["sizes"]) != len(ref["sizes"]):
        out = len(ref["sizes"])
    else:
        out = sum(1 for p, r, amb in zip(prog["sizes"], ref["sizes"], ref["ambiguous"])
                  if not amb and not np.array_equal(p, r))
    got, want = np.asarray(prog["hist_printed"], np.float64), np.asarray(ref["hist"], np.float64)
    excess = (max(0.0, float(np.abs(got - want).sum()) - ref["hist_slack"]) / max(want.sum(), 1.0)
              if got.shape == want.shape else float("inf"))
    lo, hi = ref["mean_range"]
    gap = max(lo - prog["mean"], prog["mean"] - hi, 0.0) / lo
    return {"sizes_out": int(out), "hist_excess": excess,
            "mean_gap": gap if np.isfinite(prog["mean"]) else float("inf")}
