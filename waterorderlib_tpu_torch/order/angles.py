"""Three-body neighbor angles and tetrahedral metrics (port of
waterorderlib_tpu.order.angles), plain PyTorch.

All angles live in a fixed-shape (Ns, K, K) tensor with a validity mask
instead of the reference's ragged list. Pair cosines are elementwise
products summed over xyz, never a matrix product, so no TF32 path can lower
their precision on the card (`core.fp32.xla_dot3`); the arccos is `torch.acos`, as the JAX
package's XLA path uses `arccos`. This is the independent plain path that
the kernel path (ops/cuda/angles.py) is checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32, xla_dot3 as _dot3
from waterorderlib_tpu_torch.ops import histograms, pairs


class AngleSet(NamedTuple):
    """Fixed-shape set of 3-body angles.

    ang:   (..., Ns, K, K) angles in degrees (upper triangle meaningful).
    valid: (..., Ns, K, K) True for real neighbor pairs (i<j only).
    count: (..., Ns)       neighbors per center (may exceed K).
    """

    ang: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def _unit(rel: torch.Tensor) -> torch.Tensor:
    norm = sqrt_f32(_dot3(rel, rel))
    return rel / torch.where(norm > 0, norm, torch.ones_like(norm))[..., None]


def _pair_degrees(unit: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) unit vectors -> (..., K, K) pair angles in degrees."""
    cosmat = _dot3(unit[..., :, None, :], unit[..., None, :, :])
    return torch.rad2deg(torch.acos(torch.clamp(cosmat, -1.0, 1.0)))


def neighbor_angles(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> AngleSet:
    """All 3-body angles among each center's K nearest shell neighbors
    (getCosAngs with fixed shapes; counts are returned so callers can check
    that K covers the shell)."""
    neigh = pairs.topk_neighbors(
        sub, pos, box, k=k, low_cut=low_cut, high_cut=high_cut, row_block=row_block
    )
    rel = pbc.minimum_image(pos[neigh.idx.long()] - sub[..., None, :], box)  # (Ns, K, 3)
    ang = _pair_degrees(_unit(rel))
    iu = torch.triu(torch.ones((k, k), dtype=torch.bool, device=sub.device), diagonal=1)
    valid = neigh.valid[..., :, None] & neigh.valid[..., None, :] & iu
    return AngleSet(ang=ang, valid=valid, count=neigh.count)


def angle_histogram(
    angles: AngleSet, n_bins: int = 500, lo: float = 0.0, hi: float = 180.0
) -> torch.Tensor:
    """Histogram of valid angles with np.histogram bin semantics."""
    return histograms.masked_histogram(angles.ang, angles.valid, n_bins, lo, hi)


class TetMetrics(NamedTuple):
    hist: torch.Tensor      # (..., n_bins) angle counts, int64
    frac_tet: torch.Tensor  # fraction of angles in [100, 120] degrees
    avg_cos: torch.Tensor   # mean cos(angle) within the tetrahedral window
    var_cos: torch.Tensor   # population variance of cos within the window
    entropy: torch.Tensor   # Shannon entropy of the normalized histogram
    n_angles: torch.Tensor  # total valid angles


def _metrics(hist, ang, valid):
    """Statistics over the last axis of flat (B, M) angles and masks, with
    their (B, n_bins) histograms."""
    n_tot = valid.sum(dim=-1)
    tet = valid & (ang >= 100.0) & (ang <= 120.0)
    n_tet = tet.sum(dim=-1)
    cosv = torch.cos(torch.deg2rad(ang))
    denom = torch.clamp(n_tet, min=1)
    avg = torch.where(tet, cosv, 0.0).sum(dim=-1) / denom
    var = torch.where(tet, (cosv - avg[:, None]) ** 2, 0.0).sum(dim=-1) / denom
    h = hist.to(torch.float32)
    dens = h / torch.clamp(h.sum(dim=-1, keepdim=True), min=1.0)
    ent = -torch.where(dens > 0, dens * torch.log(torch.where(dens > 0, dens, 1.0)), 0.0).sum(dim=-1)
    frac = n_tet / torch.clamp(n_tot, min=1)
    return frac, avg, var, ent, n_tot


def tetrahedral_metrics(
    angles: AngleSet, n_bins: int = 500, lo: float = 0.0, hi: float = 180.0
) -> TetMetrics:
    """tetrahedralMetrics (wp:314-342) over one AngleSet: frac_tet over the
    inclusive [100, 120]-degree window, avg/var cos within it, and the
    Shannon entropy of the normalized histogram (empty bins skipped)."""
    return tetrahedral_metrics_flat(angles.ang.reshape(1, -1), angles.valid.reshape(1, -1),
                                    n_bins, lo, hi)


def tetrahedral_metrics_flat(
    ang: torch.Tensor,
    valid: torch.Tensor,
    n_bins: int = 500,
    lo: float = 0.0,
    hi: float = 180.0,
) -> TetMetrics:
    """`tetrahedral_metrics` over a pair-angle tensor (..., N, P), the layout
    of the kernel path (ops/cuda/angles.py): the statistics are taken over
    the last two axes (centers, pair slots), one set per leading index
    (e.g. per frame); a 2-D input gives one set, as the JAX function does."""
    lead = ang.shape[:-2]
    a = ang.reshape(-1, ang.shape[-2] * ang.shape[-1])
    v = valid.reshape(a.shape)
    hist = histograms.masked_histogram_frames(a, v, n_bins, lo, hi)
    frac, avg, var, ent, n_tot = _metrics(hist, a, v)
    return TetMetrics(*(t.reshape(lead + t.shape[1:]) for t in (hist, frac, avg, var, ent, n_tot)))


def pair_angles_from_positions(
    ref: torch.Tensor, neigh_pos: torch.Tensor, box: torch.Tensor
) -> torch.Tensor:
    """Analog of f2py `tetracosang(refPos, neighPos, BoxL)`: symmetric (K, K)
    degree matrix, zero diagonal."""
    rel = pbc.minimum_image(neigh_pos - ref[..., None, :], box)
    ang = _pair_degrees(_unit(rel))
    k = neigh_pos.shape[-2]
    return torch.where(torch.eye(k, dtype=torch.bool, device=ang.device), 0.0, ang)
