"""Plain PyTorch reference of the H-bond network's clusters over a water
box, every water one residue, written from the definitions of the original
library: an acceptor oxygen A and a donor oxygen D with hydrogen H bond
where the minimum-image D - A squared distance lies in (0.01, dist_cut^2]
and the D-H...A angle at the hydrogen, between H -> A and H -> D, is at
least ang_cut degrees (generalHbonds, waterlib.f90:1136-1210); two waters
are connected where either donates a bond to the other, and the clusters
are the connected components of that graph, isolated waters clusters of
one (getHBClusterStats and getClusters, orderParam_lib.py:123-237).

The components come from a union-find over each frame's bonded pairs, not
from the program's label propagation. A pair is ambiguous where its squared
distance or angle cosine lies within float32 reach of its cut (`tie_eps_sq`,
`tie_eps_cos`) and the other test passes or lies at its cut too: the
program may fairly bond it either way.
The clusters are found twice, without every ambiguous pair and with every
one; where the two agree, no choice of the ambiguous pairs changes them,
and where they differ, the clusters of any choice lie between them.

It imports nothing of the program. `precision` is "float64" (the reference)
or "tf32" (the control: coordinates and displacements rounded to TF32)."""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch.core.compare import at_precision, rounded
from bench_torch.reference.q import min_image


def bonded_pairs(pos, boxes, dist_cut: float, ang_cut: float, precision: str = "float64",
                 tie_eps_sq: float = 1e-4, tie_eps_cos: float = 1e-5, frame_block: int = 4):
    """pos (F, 3 n, 3) atoms O, H1, H2 of each water; boxes (F, 3) -> per
    frame (sure (k, 2), ambiguous (m, 2)) int64 numpy arrays of (acceptor
    water, donor water) pairs: those bonded with room to spare, and those
    within float32 reach of a cut that the definition bonds or does not."""
    x_all, b_all = at_precision(pos, precision), at_precision(boxes, precision)
    cut2, cos_cut = dist_cut * dist_cut, math.cos(math.radians(ang_cut))
    out = []
    for f0 in range(0, x_all.shape[0], frame_block):
        x, b = x_all[f0:f0 + frame_block], b_all[f0:f0 + frame_block]
        o = x[:, 0::3]
        d = rounded(min_image(o[:, None, :, :] - o[:, :, None, :], b[:, None, None, :]),
                    precision)                               # [f, a, d] = O_d - O_a
        dsq = (d * d).sum(-1)
        cand = (dsq > 1e-2) & (dsq <= cut2 + tie_eps_sq)
        f, a, dn = cand.nonzero(as_tuple=True)
        edge_d = (dsq[f, a, dn] - cut2).abs() < tie_eps_sq
        inside = dsq[f, a, dn] <= cut2
        sure = torch.zeros_like(inside)
        maybe = torch.zeros_like(inside)
        for k in (1, 2):
            hp = x[f, 3 * dn + k]
            u = rounded(min_image(o[f, a] - hp, b[f]), precision)    # H -> A
            v = rounded(min_image(o[f, dn] - hp, b[f]), precision)   # H -> D
            cos = (u * v).sum(-1) / torch.sqrt((u * u).sum(-1) * (v * v).sum(-1))
            angle_ok = torch.rad2deg(torch.acos(cos.clamp(-1.0, 1.0))) >= ang_cut
            edge_a = (cos - cos_cut).abs() < tie_eps_cos
            sure |= inside & angle_ok & ~edge_d & ~edge_a
            # either test at its cut, the other passed or at its cut too
            maybe |= (edge_d | edge_a) & (inside | edge_d) & (angle_ok | edge_a)
        maybe &= ~sure
        pairs = torch.stack([a, dn], 1).cpu().numpy()
        f_np, sure_np, maybe_np = f.cpu().numpy(), sure.cpu().numpy(), maybe.cpu().numpy()
        for i in range(x.shape[0]):
            mine = f_np == i
            out.append((pairs[mine & sure_np], pairs[mine & maybe_np]))
    return out


def component_sizes(n: int, pairs) -> np.ndarray:
    """Sorted sizes of the connected components of n vertices joined by
    `pairs` (k, 2), by union-find with path halving; isolated vertices are
    components of one."""
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in pairs.tolist():
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([find(i) for i in range(n)], dtype=np.int64)
    return np.sort(np.bincount(roots, minlength=n)[np.unique(roots)])


def clusters_frames(pos, boxes, dist_cut: float, ang_cut: float, precision: str = "float64"):
    """(lo, hi): per frame the sorted cluster sizes of the pairs bonded with
    room to spare, and of those with every ambiguous pair bonded as well.
    Any choice of the ambiguous pairs gives clusters that lie between the
    two: lo's clusters merged, at most len(lo) - len(hi) times."""
    n = pos.shape[1] // 3
    lo, hi = [], []
    for sure, maybe in bonded_pairs(pos, boxes, dist_cut, ang_cut, precision):
        lo.append(component_sizes(n, sure))
        hi.append(component_sizes(n, np.concatenate([sure, maybe])) if len(maybe) else lo[-1])
    return lo, hi
