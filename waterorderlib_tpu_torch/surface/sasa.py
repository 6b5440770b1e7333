"""Solvent-accessible surface area, Shrake-Rupley (port of
waterorderlib_tpu.surface.sasa).

Replaces `SpherePoints`/`SphereSurfaceAreas`/`SphereVolumes`
(waterlib.f90:68-187), the `SASAperAtom` wrapper
(water_properties.py:59-74) and `sasaCalc` (surface_library.py:394-423).

`sasa_per_atom` runs the occluder-pruned tier (K = 128 nearest atoms within
2 max r, `ops.pairs.topk_neighbors`) on the occlusion kernel
(ops/cuda/sasa.py `sasa_topk`) and, where its certificate fails (an atom
with more than K candidates), the brute tier on the same kernel's other
entry point (`sasa_brute`). Both tiers take the JAX package's quadratic
occlusion test in XLA's arithmetic, so they agree exactly, with one
deliberate edge kept from the JAX package: an occluder at exactly zero
distance (a coincident atom) is left out by the pruned tier's neighbor
search and counted by the brute tier. The JAX package's opt-in MXU kernel
(`WOL_SASA_MXU`) and its fallback are not ported: there is one occlusion
test, and nothing falls back.

`sasa_calc` and `sphere_volumes` are plain PyTorch, as they are XLA in the
JAX package, blocked over atoms and voxels so memory stays bounded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock, pbc
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end
from waterorderlib_tpu_torch.core.fp32 import xla_dot3
from waterorderlib_tpu_torch.core.geometry import sphere_points
from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.ops.cuda import sasa as occlusion

CALC_PAIR_BUDGET = 1 << 22  # (point, atom) pairs per block of sasa_calc
VOXEL_BLOCK = 4096  # voxels per block of sphere_volumes, as the JAX package

# `last_tier`: which tier served the most recent sasa_per_atom call, "topk"
# | "brute" (the registry's `tier:sasa_per_atom:*`)
__getattr__ = clock.tier_attr("sasa_per_atom", __name__)


def _areas(radii, n_vis, p: int):
    """4 pi r^2 n_vis / P in float32, in the order XLA evaluates the JAX
    expression `4.0 * jnp.pi * r**2 * n_vis / p`: the division by the
    constant P becomes a product with float32(1/P)."""
    four_pi = torch.tensor(4.0 * math.pi, dtype=torch.float32, device=radii.device)
    inv_p = torch.tensor(1.0 / p, dtype=torch.float32, device=radii.device)
    return four_pi * (radii * radii) * n_vis.to(torch.float32) * inv_p


def sphere_surface_areas(pos, radii, points, box, n_exp: int = 10, atom_block: int = 64):
    """Per-atom exposed surface area and exposure flag (waterlib.f90:90-141),
    the brute tier: every atom's points against all N atoms.

    pos (N, 3); radii (N,) *including* any probe radius; points (P, 3) unit
    points; box (3,) (non-positive = no PBC); float32 tensors on one device.
    A point on sphere i is occluded if it lies strictly inside sphere j
    (distance^2 < radii[j]^2, j != i, j reimaged around i). Returns (areas
    (N,), exposed (N,) bool: at least n_exp visible points). `atom_block`
    is the JAX package's blocking and changes nothing here.
    """
    n_vis = occlusion.sasa_brute(pos.contiguous(), radii.contiguous(), points.contiguous(),
                                 box.contiguous())
    return _areas(radii, n_vis, points.shape[0]), n_vis >= n_exp


def sphere_surface_areas_topk(pos, radii, points, box, n_exp: int = 10, k: int = 128,
                              atom_block: int = 256):
    """Occluder-pruned `sphere_surface_areas`: a point on sphere i lies
    strictly inside sphere j only when |c_i - c_j| < r_i + r_j <= 2 max r,
    so only the K nearest candidates within that cutoff are tested.

    Returns (areas, exposed, ok): `ok` (a bool tensor) certifies exactness,
    True iff every atom had at most K in-range candidates. An occluder at
    exactly zero distance from the center is left out here and counted by
    the brute tier. `atom_block` is the neighbor search's row block.
    """
    n_vis, ok = _topk_counts(pos, radii, points, box, k, atom_block)
    return _areas(radii, n_vis, points.shape[0]), n_vis >= n_exp, ok


def _topk_counts(pos, radii, points, box, k, atom_block):
    """(n_vis (N,) int32, ok) of the pruned tier, its steps on the stage
    clock: top-K search, occluder gather, kernel."""
    cutoff = 2.0 * float(torch.max(radii)) if radii.numel() else 0.0
    nl = pairs.topk_neighbors(pos, pos, box, k=k, low_cut=0.0, high_cut=cutoff,
                              row_block=atom_block)
    ok = torch.all(nl.count <= k)
    stage_end("top-K search")
    slots = occluder_slots(pos, radii, box, nl)
    stage_end("occluder gather")
    n_vis = occlusion.sasa_topk(pos.contiguous(), radii.contiguous(), points.contiguous(), *slots)
    stage_end("kernel")
    return n_vis, ok


def occluder_slots(pos, radii, box, nl: pairs.NeighborList):
    """The occlusion kernel's slots from a neighbor list of `pos` against
    itself: (occ (N, K, 3) occluder centers reimaged around each center, as
    the JAX package gathers them (ref :125-128), occ_rsq (N, K) their
    squared radii, valid (N, K)), contiguous."""
    idx = nl.idx.long()
    occ = pos[:, None, :] + pbc.minimum_image(pos[idx] - pos[:, None, :], box)
    return occ.contiguous(), (radii * radii)[idx].contiguous(), nl.valid.contiguous()


@clock.traced("call:sasa_per_atom")
def sasa_per_atom(pos, radii, box=None, probe_radius: float = 1.4, n_points: int = 1000,
                  n_expose: int = 10, device="cuda"):
    """SASA per atom and surface flags (water_properties.py:59-74): golden
    spiral points on spheres of radius (vdW + probe). box=None disables PBC
    (the reference wrapper passes no box).

    The pruned tier runs first; if its certificate fails (more than K = 128
    candidate occluders on some atom), the brute tier recomputes: the same
    results, slower. `last_tier` names the tier that served. Returns
    (areas (N,), exposed (N,) bool) as tensors on `device`. Steps end on the
    stage clock (`core.clock.stage_times`): H2D, top-K search, occluder
    gather, kernel, areas (and brute kernel where the certificate fails).
    """
    dev = resolve_device(device)
    pts = clock.to_device(sphere_points(n_points), torch.float32, dev)
    if box is None:
        box = [-1.0, -1.0, -1.0]
    pos = clock.to_device(np.asarray(pos), torch.float32, dev)
    rad = clock.to_device(np.asarray(radii), torch.float32, dev) + probe_radius
    box = clock.to_device(np.asarray(box), torch.float32, dev).reshape(3)
    stage_end("H2D")
    n_vis, ok = _topk_counts(pos, rad, pts, box, 128, 256)
    if bool(ok):
        clock.serve_tier("sasa_per_atom", "topk")
    else:
        clock.serve_tier("sasa_per_atom", "brute")
        n_vis = occlusion.sasa_brute(pos, rad, pts, box)
        stage_end("brute kernel")
    areas, exposed = _areas(rad, n_vis, n_points), n_vis >= n_expose
    stage_end("areas")
    return areas, exposed


@clock.traced("call:sasa_calc")
def sasa_calc(heavy_pos, box, vdw_radii, sol_radius: float = 1.4, n_points: int = 100,
              device="cuda"):
    """surface_library.py:394-423 variant: insertion points at (vdW_i +
    probe) tested for overlap (0 < d^2 <= r_vdw_j^2) against *bare* vdW
    spheres of the other atoms under PBC. Returns (points (N, P, 3),
    accessible (N, P) bool, sasa (N,)) as tensors on `device`.

    NOTE: the reference computes sasa_i = frac * 4*pi*(r_i + probe) -- the
    radius is NOT squared (surface_library.py:417); reproduced verbatim for
    parity.
    """
    dev = resolve_device(device)
    heavy = clock.to_device(np.asarray(heavy_pos), torch.float32, dev)
    boxv = clock.to_device(np.asarray(box), torch.float32, dev).reshape(3)
    vdw = clock.to_device(np.asarray(vdw_radii), torch.float32, dev)
    n = heavy.shape[0]
    pts = clock.to_device(sphere_points(n_points), torch.float32, dev)
    ins = heavy[:, None, :] + (vdw + sol_radius)[:, None, None] * pts[None, :, :]
    vdw_sq = vdw * vdw
    idx = torch.arange(n, device=dev)
    step = max(1, CALC_PAIR_BUDGET // max(1, n_points * n))
    accessible = []
    for s in range(0, n, step):
        blk = ins[s : s + step]
        d = pbc.minimum_image(blk[:, :, None, :] - heavy[None, None, :, :], boxv)
        d2 = xla_dot3(d, d)
        overl = (d2 > 0.0) & (d2 <= vdw_sq[None, None, :])
        overl = overl & (idx[s : s + step, None, None] != idx[None, None, :])
        accessible.append(~overl.any(dim=-1))
    accessible = torch.cat(accessible)
    frac = accessible.sum(dim=-1).to(torch.float32) / n_points
    sasa = frac * 4.0 * math.pi * (sol_radius + vdw)
    return ins, accessible, sasa


def sphere_volumes(pos, radii, dx: float, grid_points_per_axis: int = 64, device="cuda"):
    """Partitioned sphere volumes by voxel scan (waterlib.f90:144-187): each
    voxel of the bounding grid is assigned to the nearest sphere that covers
    it; volumes are voxel counts * the voxel volume. The grid is a uniform
    lattice of grid_points_per_axis points along each axis over the bounding
    box (pass one that gives spacing <= dx for parity). Voxels that no sphere
    covers count for no atom. Returns (N,) float32 volumes on `device`."""
    dev = resolve_device(device)
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
    radii = torch.as_tensor(np.asarray(radii), dtype=torch.float32, device=dev)
    radii_sq = radii * radii
    lo = torch.min(pos - radii[:, None], dim=0).values
    hi = torch.max(pos + radii[:, None], dim=0).values + dx / 2
    g = grid_points_per_axis
    ar = torch.arange(g, dtype=torch.float32, device=dev)
    ax = [lo[d] + (hi[d] - lo[d]) * ar / g for d in range(3)]
    grid = torch.stack(torch.meshgrid(*ax, indexing="ij"), dim=-1).reshape(-1, 3)
    edge = (hi - lo) / g
    cell_v = edge[0] * edge[1] * edge[2]
    counts = torch.zeros(pos.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, grid.shape[0], VOXEL_BLOCK):
        blk = grid[s : s + VOXEL_BLOCK]
        d = blk[:, None, :] - pos[None, :, :]
        d2 = xla_dot3(d, d)  # (B, N)
        covered = d2 < radii_sq[None, :]
        owner = torch.argmin(torch.where(covered, d2, math.inf), dim=-1)
        has = covered.any(dim=-1)
        counts += torch.bincount(owner[has], minlength=pos.shape[0])
    return counts.to(torch.float32) * cell_v
