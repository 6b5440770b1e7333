"""Density fields on grids: raw box-count, Willard-Chandler coarse-grained,
spherical probe volumes, and interface-water bookkeeping (port of
waterorderlib_tpu.density.fields).

`willard_density_points` and `willard_density_field` run the points kernel
(ops/cuda/willard.py `willard_points`: csrc/willard.cu on CUDA tensors, its
plain PyTorch version on CPU tensors). The other functions are plain
PyTorch, blocked over grid points or waters so that peak memory is
O(row_block * N).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.ops.cuda import willard
from waterorderlib_tpu_torch.ops.pairs import DEFAULT_ROW_BLOCK


def make_grid(gridx, gridy, gridz) -> np.ndarray:
    """Flattened (Nx*Ny*Nz, 3) grid points from per-axis coordinates,
    x-major to match the Fortran (i, j, k) loop order."""
    gx, gy, gz = (np.asarray(g) for g in (gridx, gridy, gridz))
    pts = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"), axis=-1)
    return pts.reshape(-1, 3)


def _grid_points(gridx, gridy, gridz) -> torch.Tensor:
    return torch.stack(torch.meshgrid(gridx, gridy, gridz, indexing="ij"), dim=-1).reshape(-1, 3)


def willard_density_points(pos, pts, box, smoothlen: float = 2.4):
    """Truncated-shifted Gaussian density + unit normals at arbitrary points
    (waterlib.f90:1351-1398). pos (N, 3), pts (P, 3), box (3,), float32.
    Returns (dens (P,), norms (P, 3)).

    The Gaussian is truncated at 3*sigma and shifted so it reaches zero
    there; normals point along the density gradient. The JAX function's
    `row_block` is not taken: the points kernel takes every point at once
    and its plain version blocks by pair count."""
    out = willard.willard_points(pos.to(torch.float32).t().contiguous(),
                                 pts.to(torch.float32).t().contiguous(),
                                 box.to(torch.float32).reshape(3), smoothlen)
    return out[0], willard._unit(out[1:].t())


def willard_density_field(pos, gridx, gridy, gridz, box, smoothlen: float = 2.4,
                          nx: int = 0, ny: int = 0, nz: int = 0):
    """Willard-Chandler field on a regular grid (waterlib.f90:1286-1341).
    Returns (dens (Nx, Ny, Nz), norms (Nx, Ny, Nz, 3)). nx/ny/nz are the
    grid sizes (pass gridx.shape[0] etc.)."""
    dens, norms = willard_density_points(pos, _grid_points(gridx, gridy, gridz), box, smoothlen)
    return dens.reshape(nx, ny, nz), norms.reshape(nx, ny, nz, 3)


def _row_blocks(n: int, row_block: int):
    block = min(row_block, max(1, n))
    return range(0, n, block), block


def density_field(pos, gridx, gridy, gridz, box, nx: int = 0, ny: int = 0, nz: int = 0,
                  row_block: int = DEFAULT_ROW_BLOCK):
    """Raw box-count density (waterlib.f90:1220-1268): atoms reimaged around
    each grid point and counted if within +-binwidth/2 along every axis
    (inclusive edges), normalized by binwidth^3."""
    binwidth = gridx[1] - gridx[0]
    half = binwidth / 2.0
    pts = _grid_points(gridx, gridy, gridz)
    starts, block = _row_blocks(pts.shape[0], row_block)
    counts = torch.cat([
        (pbc.minimum_image(pos[None, :, :] - pts[s : s + block, None, :], box).abs() <= half)
        .all(dim=-1).sum(dim=1).to(torch.float32)
        for s in starts
    ])
    return (counts / (binwidth * binwidth * binwidth)).reshape(nx, ny, nz)


def probe_grid(pos, grid_pos, box, probe_radius: float,
               row_block: int = DEFAULT_ROW_BLOCK) -> torch.Tensor:
    """Count positions within probe_radius (inclusive) of each grid point
    (waterlib.f90:1106-1134). int32 (G,)."""
    r_sq = torch.tensor(probe_radius * probe_radius, dtype=pos.dtype, device=pos.device)
    starts, block = _row_blocks(grid_pos.shape[0], row_block)
    out = []
    for s in starts:
        d = pbc.minimum_image(pos[None, :, :] - grid_pos[s : s + block, None, :], box)
        out.append(((d * d).sum(dim=-1) <= r_sq).sum(dim=1, dtype=torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=pos.device)


def bin_on_grid(opos, xbins, ybins, zbins, nx: int, ny: int, nz: int) -> torch.Tensor:
    """Bin positions onto a uniform cubic grid, counting only points inside
    the sphere inscribed in each cell (waterlib.f90:1047-1099). nx/ny/nz are
    the *bin-edge* counts; output is (nx-1, ny-1, nz-1) int32."""
    w = xbins[1] - xbins[0]
    radsq = w * w / 4.0
    idx, centers = [], []
    for d, (bins, nb) in enumerate(((xbins, nx), (ybins, ny), (zbins, nz))):
        i = torch.floor((opos[:, d] - bins[0]) / w).to(torch.int32)
        ic = torch.clamp(i, 0, nb - 2)
        idx.append((i, ic, nb))
        centers.append(bins[0] + (ic.to(opos.dtype) + 0.5) * w)
    ok = torch.ones(opos.shape[0], dtype=torch.bool, device=opos.device)
    for i, _, nb in idx:
        ok = ok & (i >= 0) & (i < nb - 1)
    e = [opos[:, d] - centers[d] for d in range(3)]
    ok = ok & (e[0] * e[0] + e[1] * e[1] + e[2] * e[2] <= radsq)
    (_, cx, _), (_, cy, _), (_, cz, _) = idx
    flat = (cx.long() * ((ny - 1) * (nz - 1)) + cy.long() * (nz - 1) + cz.long())
    hist = torch.zeros((nx - 1) * (ny - 1) * (nz - 1), dtype=torch.int32, device=opos.device)
    hist.index_add_(0, torch.where(ok, flat, 0), ok.to(torch.int32))
    return hist.reshape(nx - 1, ny - 1, nz - 1)


class InterfaceWaterResult(NamedTuple):
    wat_close: torch.Tensor   # (Nw,) int32 index of closest surface point per water
    surf_close: torch.Tensor  # (Ng,) int32 index of closest water per surface point
    num_water: torch.Tensor   # int32 scalar: waters with projected distance <= cutoff
    wat_dists: torch.Tensor   # (Nw,) signed distance to interface (projection)


def interface_water(pos, grid_pos, grid_norm, box, cutoff: float,
                    row_block: int = DEFAULT_ROW_BLOCK) -> InterfaceWaterResult:
    """Closest-point bookkeeping between waters and interface points
    (waterlib.f90:1414-1469): nearest surface point per water, nearest water
    per surface point, per-water signed distance along the local surface
    normal, and the count with projection <= cutoff. Ties take the first
    index, as jnp.argmin does."""
    ng = grid_pos.shape[0]
    best = torch.full((ng,), float("inf"), dtype=pos.dtype, device=pos.device)
    surf_close = torch.zeros(ng, dtype=torch.int64, device=pos.device)
    wcl, projs = [], []
    starts, block = _row_blocks(pos.shape[0], row_block)
    for s in starts:
        blk = pos[s : s + block]
        d = pbc.minimum_image(blk[:, None, :] - grid_pos[None, :, :], box)
        dsq = (d * d).sum(dim=-1)  # (B, Ng)
        wclose = torch.argmin(dsq, dim=1)
        dvec = pbc.minimum_image(blk - grid_pos[wclose], box)
        projs.append((dvec * grid_norm[wclose]).sum(dim=-1))
        wcl.append(wclose.to(torch.int32))
        col = torch.argmin(dsq, dim=0)
        col_min = dsq.gather(0, col[None])[0]
        better = col_min < best  # strict: an earlier block keeps its tie
        best = torch.where(better, col_min, best)
        surf_close = torch.where(better, col + s, surf_close)
    proj = torch.cat(projs)
    num_water = (proj <= cutoff).sum(dtype=torch.int32)
    return InterfaceWaterResult(torch.cat(wcl), surf_close.to(torch.int32), num_water, proj)
