"""Plain PyTorch reference of the psi-6 hexagonal order parameter, written
from the definition (orderParam_lib.py:1505-1584 of the original library,
`hexOrderCalc`):

- the centers are the chain ends, every other heavy atom of the end
  residue (`endInds = watInds[1::2]`); on a water box, every other oxygen;
- for each center, its neighbors among the centers in (low, high] under
  the minimum image, the full shell count, and the K = 24 nearest of them
  (ties to the lowest column);
- psi6 = |mean over every pair (a, b) of those of exp(6 i theta_ab)|, with
  theta_ab = arccos of the unit vectors' dot product, taken through
  torch.cos and torch.sin of 6 theta; psi6 = 0 where the shell holds fewer
  than 2;
- for each population and frame: the histogram of psi6 in 500 bins over
  [0, 1] (np.histogram's bins), and the mean and population variance of
  psi6 over the population's centers, each averaged over frames.

It imports nothing of the program. `precision` is "float64" (the
reference) or "tf32" (the control: coordinates and displacements rounded
to TF32, the rest in float32)."""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.core import compare as cmp
from bench_torch.core.compare import at_precision, rounded
from bench_torch.reference.q import min_image

# float32 matrix products stay float32 on the card: the reference's
# precision is its own, not TF32's
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K = 24
N_BINS, LO, HI = 500, 0.0, 1.0
PAIR_A, PAIR_B = (torch.tensor(v) for v in zip(*[(a, b) for a in range(K) for b in range(a + 1, K)]))


def ends(positions: torch.Tensor) -> torch.Tensor:
    """The centers of a water box (atoms O, H1, H2 of each water): every
    other oxygen, starting from the second. positions (F, atoms, 3)."""
    return positions[:, 3::6]


def psi6_frames(centers, boxes, low: float, high: float, precision: str = "float64",
                tie_eps_sq: float = 1e-4, frame_block: int = 8):
    """centers (F, N, 3), boxes (F, 3) -> (psi (F, N) float64, count (F, N)
    int64, the full shell count; ambiguous (F, N) bool), on centers'
    device. N must exceed K + 1.

    A row is ambiguous where the float32 program may fairly choose another
    shell: a squared distance within `tie_eps_sq` of high^2 (or of low^2
    where low > 0), or, with more than K neighbors, the K-th and the next
    squared distances within it of each other."""
    x_all, b_all = at_precision(centers, precision), at_precision(boxes, precision)
    n = x_all.shape[1]
    if n <= K + 1:
        raise ValueError(f"the reference takes more than {K + 1} centers, got {n}")
    dev = x_all.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    pa, pb = PAIR_A.to(dev), PAIR_B.to(dev)
    psis, counts, ambs = [], [], []
    for f0 in range(0, x_all.shape[0], frame_block):
        x, b = x_all[f0:f0 + frame_block], b_all[f0:f0 + frame_block]
        d = rounded(min_image(x[:, None, :, :] - x[:, :, None, :], b[:, None, None, :]),
                    precision)                      # (B, i, j, 3): j - i
        dsq = (d * d).sum(-1)
        near = (dsq > low * low) & (dsq <= high * high) & ~eye
        c = near.sum(-1)
        # the K + 1 nearest, ties to the lowest column: a stable sort keeps
        # equal distances in column order
        vals, idx = torch.sort(torch.where(near, dsq, torch.inf), dim=-1, stable=True)
        vals, idx = vals[..., :K + 1], idx[..., :K]
        vec = torch.take_along_dim(d, idx[..., None].expand(*idx.shape, 3), dim=2)
        u = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
        kept = c.clamp(max=K)
        ok = pb < kept[..., None]                   # both of the pair are neighbors
        theta = torch.arccos((u[..., pa, :] * u[..., pb, :]).sum(-1).clamp(-1.0, 1.0))
        re = torch.where(ok, torch.cos(6.0 * theta), 0.0).sum(-1)
        im = torch.where(ok, torch.sin(6.0 * theta), 0.0).sum(-1)
        n_pairs = (kept * (kept - 1) // 2).clamp(min=1)
        psi = torch.sqrt(re * re + im * im) / n_pairs
        psis.append(torch.where(c > 1, psi, 0.0).to(torch.float64))
        counts.append(c)
        edge = (dsq - high * high).abs() < tie_eps_sq
        if low > 0:
            edge |= (dsq - low * low).abs() < tie_eps_sq
        tie = (c > K) & (vals[..., K] - vals[..., K - 1] < tie_eps_sq)
        ambs.append(edge.any(-1) | tie)
    return torch.cat(psis), torch.cat(counts), torch.cat(ambs)


def population_stats(psi, masks):
    """psi (F, N) as `psi6_frames` gives it, masks (F, Q, N) bool ->
    (hist (Q, 500) int64 numpy, np.histogram's bins over [0, 1];
    (avg_psi, var_psi) each (Q,) float64 numpy: the mean over frames of
    each frame's mean and population variance of psi over the population),
    as the driver's psiDistribution_j.txt and its returned means."""
    hist = np.stack([cmp.histogram(psi[masks[:, q]].cpu().numpy(), N_BINS, LO, HI)
                     for q in range(masks.shape[1])])
    return hist, cmp.pop_mean_var(psi, masks)
