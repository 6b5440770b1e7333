"""Isosurface mesh builders around a solute (port of
waterorderlib_tpu.surface.grids): `sasa_grid`, `density_grid` and
`density_voxel`, each with the JAX function's arguments plus `device`.

The scalar fields (signed SASA distance, Willard-Chandler density, raw
box-count density) are computed on the device; isosurfaces come from host
marching tetrahedra (surface.mesh). `density_grid` takes the certified
Willard grid dispatch (ops/cuda/willard.py): the grid kernel where its
`covered` certificate holds, the points kernel over all atoms where it
fails, and no other way between them. Its steps end on the drivers' stage
clock (`core.clock.stage_times`): grid setup, H2D, prep (sorts,
windows, certificate), kernel, D2H, marching tetrahedra.
"""

from __future__ import annotations

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end
from waterorderlib_tpu_torch.density import fields
from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.ops.cuda import willard
from waterorderlib_tpu_torch.surface.mesh import marching_tetrahedra

SASA_ROW_BLOCK = 4096  # grid points per block of the SASA metric


def _f32(a, dev) -> torch.Tensor:
    return clock.to_device(np.asarray(a), torch.float32, dev)


def sasa_grid(heavy_pos, box, cutoff, n_bins: int = 50, device="cuda"):
    """SASA-style isosurface mesh (surface_library.py:120-167): on a grid
    spanning 0.8*min..1.2*max of the heavy atoms, evaluate the signed field
    min_j(d(grid, atom_j)^2 - cutoff_j^2) and extract the zero level set.
    cutoff: per-atom radii (e.g. vdW + probe). Returns (verts, faces)."""
    dev = resolve_device(device)
    heavy_pos = np.asarray(heavy_pos, float)
    lo = 0.8 * heavy_pos.min(axis=0)
    hi = 1.2 * heavy_pos.max(axis=0)
    axes = [np.linspace(lo[d], hi[d], n_bins) for d in range(3)]
    pts = _f32(fields.make_grid(*axes), dev)
    heavy, boxv, cut = _f32(heavy_pos, dev), _f32(box, dev), _f32(cutoff, dev)
    field = torch.cat([
        pairs.signed_sq_metric(pts[s : s + SASA_ROW_BLOCK], heavy, boxv, cut).min(dim=1).values
        for s in range(0, pts.shape[0], SASA_ROW_BLOCK)
    ]).reshape(n_bins, n_bins, n_bins).cpu().numpy()
    spacing = [(hi[d] - lo[d]) / (n_bins - 1) for d in range(3)]
    # negative inside the surface; extract the 0 level of -field so normals
    # (toward higher values) point outward
    verts, faces = marching_tetrahedra(-field, 0.0, spacing=spacing, origin=lo)
    return verts, faces


def grid_spec(heavy_pos, box, n_bins: int = 81):
    """`density_grid`'s cube: three equal (g0, dg, n) axes spanning the
    solute's scalar min and max -/+ half of box[0] in n_bins edges, the
    first edge dropped as the reference does (:192-194), so n = n_bins - 1
    points that may lie outside [0, L)."""
    heavy_pos = np.asarray(heavy_pos, float)
    half = float(np.asarray(box).reshape(-1)[0]) / 2.0
    span = np.linspace(heavy_pos.min() - half, heavy_pos.max() + half, n_bins)
    spacing = span[1] - span[0]
    g = span[:-1] + spacing
    return ((float(g[0]), float(spacing), len(g)),) * 3


@clock.traced("call:density_grid")
def density_grid(heavy_pos, wat_pos, box, level: float = 0.016, smoothlen: float = 2.4,
                 n_bins: int = 81, device="cuda", *, window=None, window_x=None):
    """Willard-Chandler instantaneous interface mesh
    (surface_library.py:170-210): coarse-grained water density on a cube
    spanning the solute extent plus half a box, isosurface at ~half bulk
    density. Returns (verts, faces) centered like the reference (mesh
    shifted so its extent is centered at the origin).

    `window` and `window_x` force the grid prep's window widths
    (`willard.grid_prep`); a window too narrow fails the certificate, and
    the points kernel serves. `willard.last_tier` names the tier."""
    dev = resolve_device(device)
    all_min = float(np.min(heavy_pos))
    grid = grid_spec(heavy_pos, box, n_bins)
    spacing = grid[0][1]
    stage_end("grid setup")
    pos = _f32(wat_pos, dev)
    boxv = _f32(box, dev).reshape(-1)
    stage_end("H2D")
    prep = willard.grid_prep(pos, boxv, grid, smoothlen, window, window_x)
    stage_end("prep")
    dens, _ = willard.field_from_prep(prep, pos, boxv, grid, smoothlen)
    stage_end("kernel")
    dens = dens.cpu().numpy()
    stage_end("D2H")
    verts, faces = marching_tetrahedra(dens, level, spacing=(spacing,) * 3, origin=(0.0, 0.0, 0.0))
    if len(verts):
        verts = verts - all_min
        verts = verts - 0.5 * verts.max()
    stage_end("marching tetrahedra")
    return verts, faces


def density_voxel(heavy_pos, wat_pos, box, n_bins: int = 11, device="cuda"):
    """Raw box-count density voxels around the solute
    (surface_library.py:213-241). Returns (n_bins-1,)^3 density values."""
    dev = resolve_device(device)
    heavy_pos = np.asarray(heavy_pos, float)
    lo = 0.8 * heavy_pos.min(axis=0)
    hi = 1.2 * heavy_pos.max(axis=0)
    axes = []
    for d in range(3):
        span = np.linspace(lo[d], hi[d], n_bins)
        w = span[1] - span[0]
        axes.append(_f32(span[:-1] + w, dev))
    n = n_bins - 1
    dens = fields.density_field(_f32(wat_pos, dev), *axes, _f32(box, dev).reshape(-1),
                                nx=n, ny=n, nz=n)
    return dens.cpu().numpy()
