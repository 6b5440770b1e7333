"""Vectorized geometric primitives (port of waterorderlib_tpu.core.geometry).

Replacements for the scalar Fortran helpers of the reference
(waterlib.f90): `Centroid` (:9-15), `RgWeights` (:50-64), `CosAngle3`
(:683-703), `AngBetween` (:954-965), `watOrient` (:973-1010), `watOHvec`
(:1018-1044), `calcSD` (:923-951), `SpherePoints` (:68-87), `tetraCosAng`
(:867-895) and `lsiDists` (:900-918).

Every function but `sphere_points` is plain PyTorch, batched over leading
axes. Sums of products over xyz are elementwise fused multiply-add chains in
the order XLA's CPU backend contracts the JAX package's expressions
(`core.fp32.xla_dot3`), never a matrix product, so no TF32 path lowers their
precision on the card. Angles are in degrees, as the reference has them.
`sphere_points` is host numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32, xla_dot3

RAD2DEG = 180.0 / np.pi
DEG2RAD = np.pi / 180.0


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    n = sqrt_f32(xla_dot3(v, v))
    return n[..., None] if keepdim else n


def _degrees_of_cos(cosv: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(torch.acos(torch.clamp(cosv, -1.0, 1.0)))


def centroid(pos: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Mean of positions along the atom axis (waterlib.f90:9-15)."""
    return torch.mean(pos, dim=axis)


def rg_weights(pos: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mass-weighted radius of gyration (waterlib.f90:50-64).

    pos: (..., N, 3); weights: (..., N). The center is the *unweighted*
    centroid, as in the reference.
    """
    center = torch.mean(pos, dim=-2, keepdim=True)
    d = pos - center
    sq = xla_dot3(d, d)
    return torch.sqrt(torch.sum(weights * sq, dim=-1) / torch.sum(weights, dim=-1))


def cos_angle_deg(p1: torch.Tensor, p2: torch.Tensor, p3: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) at vertex p2 formed by p1-p2-p3 (waterlib.f90:683-703).

    Degenerate inputs (p1 == p2 or p2 == p3) give 0, as in the reference.
    Broadcasts over leading dims.
    """
    v21 = p1 - p2
    v23 = p3 - p2
    n1 = xla_dot3(v21, v21)
    n2 = xla_dot3(v23, v23)
    norm = sqrt_f32(n1 * n2)
    cosv = torch.where(norm > 0, xla_dot3(v21, v23) / torch.where(norm > 0, norm, 1.0), 1.0)
    ang = _degrees_of_cos(cosv)
    degenerate = (n1 == 0) | (n2 == 0)
    return torch.where(degenerate, 0.0, ang)


def angle_between_deg(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between *normalized* vectors (waterlib.f90:954-965)."""
    return _degrees_of_cos(xla_dot3(v1, v2))


def pair_angles_deg(ref: torch.Tensor, neigh: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """All 3-body angles (degrees) among neighbors with `ref` at the vertex.

    Vectorized `tetraCosAng` (waterlib.f90:867-895): neighbors are imaged
    around ref first; returns the symmetric (..., K, K) matrix with zero
    diagonal. ref: (..., 3); neigh: (..., K, 3); box: (3,).
    """
    rel = pbc.minimum_image(neigh - ref[..., None, :], box)  # (..., K, 3)
    norms = _norm(rel)
    dots = xla_dot3(rel[..., :, None, :], rel[..., None, :, :])
    denom = norms[..., :, None] * norms[..., None, :]
    cosv = torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 1.0)
    ang = _degrees_of_cos(cosv)
    eye = torch.eye(neigh.shape[-2], dtype=torch.bool, device=neigh.device)
    return torch.where(eye, 0.0, ang)


def imaged_distances(ref: torch.Tensor, neigh: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image distances from ref to each neighbor (waterlib.f90:900-918)."""
    return _norm(pbc.displacement(ref[..., None, :], neigh, box))


def water_dipoles(opos: torch.Tensor, hpos: torch.Tensor, box: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """Per-water dipole direction, the sum of the two imaged OH vectors
    (`watOHvec`, waterlib.f90:1018-1044). opos: (..., Nw, 3); hpos:
    (..., 2*Nw, 3) ordered so hpos[2i], hpos[2i+1] belong to opos[i]."""
    nw = opos.shape[-2]
    h = hpos.reshape(hpos.shape[:-2] + (nw, 2, 3))
    oh = pbc.minimum_image(h - opos[..., :, None, :], box)
    dip = pbc.minimum_image(oh[..., 0, :] + oh[..., 1, :], box)
    if normalize:
        dip = dip / _norm(dip, keepdim=True)
    return dip


def water_orientation(opos: torch.Tensor, hpos: torch.Tensor, refvec: torch.Tensor,
                      box: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-water (dipole-vs-ref, plane-normal-vs-ref) angles in degrees
    (`watOrient`, waterlib.f90:973-1010)."""
    nw = opos.shape[-2]
    h = hpos.reshape(hpos.shape[:-2] + (nw, 2, 3))
    oh = pbc.minimum_image(h - opos[..., :, None, :], box)  # (..., Nw, 2, 3)
    dip = pbc.minimum_image(oh[..., 0, :] + oh[..., 1, :], box)
    dip = dip / _norm(dip, keepdim=True)
    plane = torch.linalg.cross(oh[..., 0, :], oh[..., 1, :])
    plane = plane / _norm(plane, keepdim=True)
    ref = refvec / _norm(refvec, keepdim=True)
    return angle_between_deg(dip, ref), angle_between_deg(plane, ref)


def squared_displacement(pos: torch.Tensor, prev_pos: torch.Tensor, ref_pos: torch.Tensor,
                         box: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unwrapped squared displacement per coordinate (waterlib.f90:923-951).

    Returns (sd (..., N, 3), new_pos (..., N, 3)): new_pos is the
    PBC-unwrapped continuation of prev_pos and sd = (new_pos - ref_pos)**2.
    The MSD building block.
    """
    step = pbc.minimum_image(pos - prev_pos, box)
    new_pos = prev_pos + step
    sd = (new_pos - ref_pos) ** 2
    return sd, new_pos


def sphere_points(n: int) -> np.ndarray:
    """Golden-spiral points on the unit sphere (waterlib.f90:68-87;
    surface_library.py:41-53). Host numpy (static geometry), returns (n, 3)
    float64."""
    inc = np.pi * (3.0 - np.sqrt(5.0))
    off = 2.0 / n
    k = np.arange(n, dtype=np.float64)
    y = k * off - 1.0 + off / 2.0
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    phi = k * inc
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r], axis=1)
