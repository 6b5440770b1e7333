"""Plain PyTorch reference of the water-water hydrogen-bond counts, written
from the definition (waterlib.f90:1156-1210 of the original library): an
acceptor oxygen A and a donor oxygen D with hydrogen H bond where the
minimum-image D - A distance lies in (0.1, dist_cut] and the angle between
A - H and D - H is at least ang_cut degrees.

For each frame and water it gives the bonds the water accepts and the bonds
its two hydrogens donate, as a range: `lo` counts the bonds that hold with
room to spare, `hi` adds the pairs within float32 rounding of either edge,
which the program may fairly count either way.

It imports nothing of the program. `precision` is "float64" (the reference)
or "tf32" (the control: coordinates and displacements rounded to TF32)."""

from __future__ import annotations

import math

import torch

from bench_torch.core.compare import at_precision, rounded
from bench_torch.reference.q import min_image


def counts_frames(pos, boxes, dist_cut: float = 3.5, ang_cut: float = 120.0,
                  precision: str = "float64", tie_eps_sq: float = 1e-4,
                  tie_eps_cos: float = 1e-5, frame_block: int = 8):
    """pos (F, 3 n, 3) atoms O, H1, H2 of each water; boxes (F, 3) ->
    dict of (F, n) int64 tensors: acc_lo, acc_hi, don_lo, don_hi."""
    x_all, b_all = at_precision(pos, precision), at_precision(boxes, precision)
    cut2, cos_cut = dist_cut * dist_cut, math.cos(math.radians(ang_cut))
    out = {k: [] for k in ("acc_lo", "acc_hi", "don_lo", "don_hi")}
    for f0 in range(0, x_all.shape[0], frame_block):
        x, b = x_all[f0:f0 + frame_block], b_all[f0:f0 + frame_block]
        nb, n = x.shape[0], x.shape[1] // 3
        o, hs = x[:, 0::3], (x[:, 1::3], x[:, 2::3])
        d = rounded(min_image(o[:, None, :, :] - o[:, :, None, :], b[:, None, None, :]),
                    precision)                               # [f, a, d] = O_d - O_a
        dsq = (d * d).sum(-1)
        cand = (dsq > 1e-2) & (dsq <= cut2 + tie_eps_sq)
        f, a, dn = cand.nonzero(as_tuple=True)
        edge_d = (dsq[f, a, dn] - cut2).abs() < tie_eps_sq
        inside = dsq[f, a, dn] <= cut2
        acc_lo = torch.zeros((nb, n), dtype=torch.int64, device=x.device)
        acc_hi, don_lo, don_hi = acc_lo.clone(), acc_lo.clone(), acc_lo.clone()
        for h in hs:
            hp = h[f, dn]
            u = rounded(min_image(o[f, a] - hp, b[f]), precision)    # A - H
            v = rounded(min_image(o[f, dn] - hp, b[f]), precision)   # D - H
            cos = (u * v).sum(-1) / torch.sqrt((u * u).sum(-1) * (v * v).sum(-1))
            edge = edge_d | ((cos - cos_cut).abs() < tie_eps_cos)
            bond = inside & (cos <= cos_cut)
            sure = (bond & ~edge).to(torch.int64)
            maybe = (bond | edge).to(torch.int64)
            for tot, val, idx in ((acc_lo, sure, a), (acc_hi, maybe, a),
                                  (don_lo, sure, dn), (don_hi, maybe, dn)):
                tot.index_put_((f, idx), val, accumulate=True)
        for k, t in zip(out, (acc_lo, acc_hi, don_lo, don_hi)):
            out[k].append(t)
    return {k: torch.cat(v) for k, v in out.items()}
