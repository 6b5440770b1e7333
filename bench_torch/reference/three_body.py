"""Plain PyTorch reference of the 3-body angle distribution, written from
the definition (orderParam_lib.py:1269-1424, water_properties.py:210-250
and 314-342 of the original library):

- for each center, its neighbors in (low, high] under the minimum image,
  the shell count, the K = 16 nearest of them (the driver's
  `max_neighbors`), and the angle between the displacement vectors of
  every pair of those, in degrees;
- for each population and frame, the histogram of those angles in 500
  bins over [0, 180] (np.histogram's bins), the share of them in the
  inclusive [100, 120] window, the mean and population variance of their
  cosines within that window, the Shannon entropy of the frame's
  normalised histogram (empty bins skipped), and the number of centers.

It imports nothing of the program. `precision` is "float64" (the
reference) or "tf32" (the control: coordinates and displacements rounded
to TF32)."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.core.compare import at_precision, rounded
from bench_torch.reference.q import min_image

K = 16
N_PAIRS = K * (K - 1) // 2
N_BINS, LO, HI = 500, 0.0, 180.0
TET_LO, TET_HI = 100.0, 120.0
PAIR_A, PAIR_B = (torch.tensor(v) for v in zip(*[(a, b) for a in range(K) for b in range(a + 1, K)]))


def angles_frames(oxy, boxes, low: float, high: float, precision: str = "float64",
                  tie_eps_sq: float = 1e-4, frame_block: int = 4):
    """oxy (F, N, 3), boxes (F, 3) -> (angles (F, N, 120) float64, each
    row's valid angles ascending and +inf after them; count (F, N) int64,
    the full shell count; ambiguous (F, N) bool), on oxy's device.

    A row is ambiguous where the float32 program may fairly choose another
    shell: a squared distance within `tie_eps_sq` of high^2 (or of low^2
    where low > 0), or, with more than K neighbors, the K-th and the next
    squared distances within it of each other."""
    x_all, b_all = at_precision(oxy, precision), at_precision(boxes, precision)
    n = x_all.shape[1]
    dev = x_all.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    pa, pb = PAIR_A.to(dev), PAIR_B.to(dev)
    k = min(K + 1, n - 1)
    angs, counts, ambs = [], [], []
    for f0 in range(0, x_all.shape[0], frame_block):
        x, b = x_all[f0:f0 + frame_block], b_all[f0:f0 + frame_block]
        d = rounded(min_image(x[:, None, :, :] - x[:, :, None, :], b[:, None, None, :]),
                    precision)                      # (B, i, j, 3): j - i
        dsq = (d * d).sum(-1)
        near = (dsq > low * low) & (dsq <= high * high) & ~eye
        c = near.sum(-1)
        vals, idx = torch.topk(torch.where(near, dsq, torch.inf), k, dim=-1, largest=False)
        vec = torch.take_along_dim(d, idx[..., :K, None].expand(*idx.shape[:-1], K, 3), dim=2)
        u, v = vec[..., pa, :], vec[..., pb, :]
        cos = (u * v).sum(-1) / torch.sqrt((u * u).sum(-1) * (v * v).sum(-1))
        ang = torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0))).to(torch.float64)
        ok = pb < c.clamp(max=K)[..., None]
        angs.append(torch.sort(torch.where(ok, ang, torch.inf), dim=-1).values)
        counts.append(c)
        edge = (dsq - high * high).abs() < tie_eps_sq
        if low > 0:
            edge |= (dsq - low * low).abs() < tie_eps_sq
        amb = edge.any(-1)
        if k > K:
            amb |= (c > K) & (vals[..., K] - vals[..., K - 1] < tie_eps_sq)
        ambs.append(amb)
    return torch.cat(angs), torch.cat(counts), torch.cat(ambs)


def _edges(device) -> torch.Tensor:
    return torch.as_tensor(np.linspace(LO, HI, N_BINS + 1), dtype=torch.float64, device=device)


def population_stats(angles, masks, frame_block: int = 32):
    """angles (F, N, P) as `angles_frames` gives them (+inf in no slot),
    masks (F, Q, N) bool -> (hist (Q, 500) int64 numpy; (frac_tet,
    avg_cos, var_cos, entropy, n_wats) each (Q,) float64 numpy, the mean
    over frames of each frame's value)."""
    edges = _edges(angles.device)
    n_f, n_q = angles.shape[0], masks.shape[1]
    hist = torch.zeros((n_q, N_BINS), dtype=torch.int64, device=angles.device)
    sums = torch.zeros((5, n_q), dtype=torch.float64, device=angles.device)
    for f0 in range(0, n_f, frame_block):
        a = angles[f0:f0 + frame_block].to(torch.float64)
        fb = a.shape[0]
        ok = torch.isfinite(a)
        bins = (torch.bucketize(torch.where(ok, a, LO), edges, right=True) - 1).clamp(max=N_BINS - 1)
        tet = ok & (a >= TET_LO) & (a <= TET_HI)
        cos = torch.cos(torch.deg2rad(torch.where(tet, a, 0.0)))
        for q in range(n_q):
            m = masks[f0:f0 + fb, q, :, None]
            sel, t = ok & m, tet & m
            flat = (torch.arange(fb, device=a.device)[:, None, None] * N_BINS + bins)[sel]
            h = torch.bincount(flat, minlength=fb * N_BINS).reshape(fb, N_BINS)
            hist[q] += h.sum(0)
            n_tot = sel.sum((1, 2)).to(torch.float64)
            n_tet = t.sum((1, 2)).to(torch.float64)
            avg = torch.where(t, cos, 0.0).sum((1, 2)) / n_tet.clamp(min=1)
            var = torch.where(t, (cos - avg[:, None, None]) ** 2, 0.0).sum((1, 2)) / n_tet.clamp(min=1)
            dens = h.to(torch.float64) / h.sum(1, keepdim=True).clamp(min=1)
            ent = -torch.where(dens > 0, dens * torch.log(torch.where(dens > 0, dens, 1.0)),
                               0.0).sum(1)
            n_wats = masks[f0:f0 + fb, q].sum(-1).to(torch.float64)
            frac = n_tet / n_tot.clamp(min=1)
            for i, val in enumerate((frac, avg, var, ent, n_wats)):
                sums[i, q] += val.sum()
    return hist.cpu().numpy(), tuple((sums / n_f).cpu().numpy())
