"""Willard-Chandler density and gradient on a uniform grid and at points:
the two CUDA kernels' wrappers, their plain PyTorch versions, the grid prep
and the certified dispatch (port of waterorderlib_tpu.ops.pallas.willard_grid
and willard_kernel, and of the kernel dispatch of surface/grids.py:66-104).

The field at a point p, over atoms a with d = p - a (minimum image):
density sum(g - shift) and gradient -sum(d g) / sigma^2 over |d|^2 <
9 sigma^2, g = exp(-|d|^2 / (2 sigma^2)) (2 pi sigma^2)^-3/2 and shift =
e^-4.5 (2 pi sigma^2)^-3/2, sigma = smoothlen.

A grid is three (g0, dg, n) axes, coordinate g0 + dg * i in float32. The
grid kernel (`willard_grid`) serves one (plane, x-row) of grid points per
block, scanning a window of w atoms; the prep (`grid_prep`) gives it one of
three layouts:
- "x": per plane, the atoms of its z-window, sorted by x, with boundary
  copies shifted by +/-Lx; each x-row scans its own sub-window of them;
- "plane": the z-sorted atoms with boundary copies shifted by +/-Lz; each
  plane scans one window (every row of a plane the same start);
- "brute": every atom once, start 0, w = N.
Window widths and pads come from the data (the TPU's fixed window 2048, pad
640 and 128-lane alignment were VMEM limits), so `covered` holds by
construction unless a caller forces a narrower window; it is checked all
the same. No window can hold an atom twice: an atom and its copy sit
exactly N (plane form) or w (x form) slots apart, and windows are at most
that wide. Where `covered` fails the points kernel (`willard_points`)
serves every grid point over all atoms.

Each kernel wrapper launches its kernel (csrc/willard.cu) on CUDA tensors
and calls its plain version on CPU tensors; any other device raises. There
is no fallback from a kernel to a plain version, nor from the grid kernel
to the points kernel but through the certificate.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.ops.cuda import build, window

# added to the 3-sigma reach in the window search and the certificate: the
# prep wraps grid coordinates with torch.remainder, the kernel as
# v - L floor(v / L), which may round an ulp apart
CUT_SLACK = 1.0e-3
PAIR_BUDGET = 1 << 22  # (point, atom) pairs per block of the plain versions
MAX_NY = 1024  # grid points along y: one thread each in a block

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def scalars(smoothlen: float) -> tuple[float, float, float, float]:
    """(sigma^2, 1/(2 sigma^2), peak, shift) rounded to float32 from their
    float64 values, as the JAX kernels' scalar arrays hold them."""
    sig2 = smoothlen * smoothlen
    peak = 1.0 / (2.0 * np.pi * sig2) ** 1.5
    shift = float(np.exp(-4.5)) * peak
    return tuple(float(np.float32(v)) for v in (sig2, 0.5 / sig2, peak, shift))


def grid_axes(grid, device) -> tuple[torch.Tensor, ...]:
    """The three float32 axes g0 + dg * arange(n) of `grid`, unwrapped."""
    return tuple(torch.tensor(g0, dtype=torch.float32, device=device)
                 + torch.tensor(dg, dtype=torch.float32, device=device)
                 * torch.arange(n, dtype=torch.float32, device=device)
                 for g0, dg, n in grid)


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _mi(d, box_l):
    """The grid kernel's minimum image: two compare-selects."""
    d = torch.where(d > box_l * 0.5, d - box_l, d)
    return torch.where(d < -box_l * 0.5, d + box_l, d)


def _wrap(v, box_l):
    """v - L floor(v / L), the grid kernel's wrap of a grid coordinate."""
    return v - box_l * torch.floor(v / box_l)


def _check_box(box, dev):
    if box.device != dev or box.dtype != torch.float32 or tuple(box.shape) != (3,):
        raise ValueError(f"box must be float32 (3,) on {dev}, got {box.dtype} "
                         f"{tuple(box.shape)} on {box.device}")


def _check_grid(atoms, starts, w, box, grid):
    dev = atoms.device
    _check_box(box, dev)
    if atoms.dtype != torch.float32 or atoms.dim() != 3 or atoms.shape[1] != 3:
        raise ValueError(f"atoms must be float32 (P, 3, M), got {atoms.dtype} {tuple(atoms.shape)}")
    if starts.device != dev or starts.dtype != torch.int32 or starts.dim() != 2:
        raise ValueError(f"starts must be int32 (nz, nx) on {dev}, got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")
    if not (atoms.is_contiguous() and starts.is_contiguous()):
        raise ValueError("atoms and starts must be contiguous")
    (_, _, nx), (_, _, ny), (_, _, nz) = grid
    if tuple(starts.shape) != (nz, nx) or atoms.shape[0] not in (1, nz):
        raise ValueError(f"starts {tuple(starts.shape)} and atoms {tuple(atoms.shape)} do not fit "
                         f"the grid's {nz} planes of {nx} rows")
    if not 0 <= w <= atoms.shape[2]:
        raise ValueError(f"window w={w} must lie in [0, {atoms.shape[2]}]")
    if ny > MAX_NY:
        raise ValueError(f"ny={ny} exceeds {MAX_NY} grid points along y")


@clock.kernel
def willard_grid(atoms, starts, w, box, grid, smoothlen=2.4):
    """Density and gradient on every point of `grid`.

    atoms (1 or nz, 3, M) float32: one array shared by every plane, or one
    per plane; starts (nz, nx) int32: the first of the w atoms
    that grid row (plane, x-row i) scans; box (3,) float32; grid: three
    (g0, dg, n) axes. Coordinates as `grid_prep` lays them out.

    Returns (4, nx, ny, nz) float32: the density, then the gradient
    sums -sum(d g) / sigma^2 along x, y, z. A start outside [0, M - w] gives
    NaN for its row."""
    _check_grid(atoms, starts, w, box, grid)
    if window.runs_plain(atoms, "willard_grid"):
        return willard_grid_plain(atoms, starts, w, box, grid, smoothlen)
    (gx0, dgx, nx), (gy0, dgy, ny), (gz0, dgz, nz) = grid
    out = torch.empty((4, nx, ny, nz), dtype=torch.float32, device=atoms.device)
    fn = build.load("willard").willard_grid_launch
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_int, _c_int, _c_ptr, _c_int, _c_int, _c_int, _c_int,
                       *([_c_float] * 13), _c_ptr, _c_ptr]
        fn.restype = _c_int
    with torch.cuda.device(atoms.device):
        err = fn(atoms.data_ptr(), atoms.shape[0], atoms.shape[2], starts.data_ptr(), w, nx, ny,
                 nz, *box.tolist(), gx0, dgx, gy0, dgy, gz0, dgz,
                 *scalars(smoothlen), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"willard_grid_launch failed: CUDA error {err}")
    clock.count("launches:willard_grid")
    return out


@clock.plain
def willard_grid_plain(atoms, starts, w, box, grid, smoothlen=2.4):
    """Plain PyTorch version of `willard_grid`, same contract and float32
    operations, one plane at a time in blocks of rows."""
    _check_grid(atoms, starts, w, box, grid)
    dev = atoms.device
    (gx0, dgx, nx), (gy0, dgy, ny), (gz0, dgz, nz) = grid
    m = atoms.shape[2]
    sig2, inv2sig2, peak, shift = (_f32(v, dev) for v in scalars(smoothlen))
    nine_sig2, inv_sig2 = _f32(9.0, dev) * sig2, _f32(1.0, dev) / sig2
    bx, by, bz = box[0], box[1], box[2]
    gx = _wrap(_f32(gx0, dev) + _f32(dgx, dev) * torch.arange(nx, dtype=torch.float32, device=dev), bx)
    gy = _wrap(_f32(gy0, dev) + _f32(dgy, dev) * torch.arange(ny, dtype=torch.float32, device=dev), by)
    out = torch.empty((4, nx, ny, nz), dtype=torch.float32, device=dev)
    offs = torch.arange(w, device=dev)
    rb = max(1, PAIR_BUDGET // max(1, ny * w))
    for kk in range(nz):
        a = atoms[kk if atoms.shape[0] > 1 else 0]
        gz = _wrap(_f32(gz0, dev) + _f32(dgz, dev) * _f32(float(kk), dev), bz)
        for i0 in range(0, nx, rb):
            st = starts[kk, i0 : i0 + rb].long()
            bad = (st < 0) | (st > m - w)
            idx = st.clamp(0, m - w)[:, None] + offs  # (r, w)
            dx = _mi(gx[i0 : i0 + rb, None] - a[0][idx], bx)
            dz = _mi(gz - a[2][idx], bz)
            dxz = dx * dx + dz * dz
            exz = torch.exp(-dxz * inv2sig2) * peak
            dy = _mi(gy[None, :, None] - a[1][idx][:, None, :], by)  # (r, ny, w)
            dy_sq = dy * dy
            g = torch.exp(-dy_sq * inv2sig2) * exz[:, None, :]
            inside = dy_sq + dxz[:, None, :] < nine_sig2
            gm = torch.where(inside, g, 0.0)
            dens = gm.sum(dim=-1) - shift * inside.sum(dim=-1, dtype=torch.int32).float()
            grads = [(gm * -d).sum(dim=-1) * inv_sig2 for d in (dx[:, None, :], dy, dz[:, None, :])]
            block = torch.stack([dens, *grads])  # (4, r, ny)
            out[:, i0 : i0 + rb, :, kk] = torch.where(bad[None, :, None], torch.nan, block)
    return out


def _check_points(atoms_t, pts_t, box):
    dev = atoms_t.device
    _check_box(box, dev)
    for name, t in (("atoms_t", atoms_t), ("pts_t", pts_t)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 3:
            raise ValueError(f"{name} must be float32 (3, n) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@clock.kernel
def willard_points(atoms_t, pts_t, box, smoothlen=2.4):
    """Density and gradient at arbitrary points over all atoms, round-form
    minimum image. atoms_t (3, N), pts_t (3, P) float32; box (3,).

    Returns (4, P) float32: the density, then the gradient along x, y, z."""
    _check_points(atoms_t, pts_t, box)
    if window.runs_plain(atoms_t, "willard_points"):
        return willard_points_plain(atoms_t, pts_t, box, smoothlen)
    p = pts_t.shape[1]
    out = torch.empty((4, p), dtype=torch.float32, device=atoms_t.device)
    fn = build.load("willard").willard_points_launch
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_int, _c_ptr, _c_int, *([_c_float] * 6), _c_ptr, _c_ptr]
        fn.restype = _c_int
    sig2, _, peak, shift = scalars(smoothlen)
    with torch.cuda.device(atoms_t.device):
        err = fn(atoms_t.data_ptr(), atoms_t.shape[1], pts_t.data_ptr(), p, *box.tolist(), sig2,
                 shift, peak, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"willard_points_launch failed: CUDA error {err}")
    clock.count("launches:willard_points")
    return out


@clock.plain
def willard_points_plain(atoms_t, pts_t, box, smoothlen=2.4):
    """Plain PyTorch version of `willard_points`, same contract and float32
    operations, in blocks of points of under PAIR_BUDGET pairs."""
    _check_points(atoms_t, pts_t, box)
    dev = atoms_t.device
    n, p = atoms_t.shape[1], pts_t.shape[1]
    sig2, _, peak, shift = (_f32(v, dev) for v in scalars(smoothlen))
    nine_sig2, two_sig2 = _f32(9.0, dev) * sig2, _f32(2.0, dev) * sig2
    scale = _f32(-1.0, dev) / sig2
    box_l = box[:, None, None]
    inv_box = _f32(1.0, dev) / box_l
    out = torch.empty((4, p), dtype=torch.float32, device=dev)
    pb = max(1, PAIR_BUDGET // max(1, n))
    for p0 in range(0, p, pb):
        d = pts_t[:, p0 : p0 + pb, None] - atoms_t[:, None, :]  # (3, pb, N)
        d = d - box_l * torch.round(d * inv_box)
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = rsq < nine_sig2
        g = torch.exp(-rsq / two_sig2) * peak
        out[0, p0 : p0 + pb] = torch.where(inside, g - shift, 0.0).sum(dim=-1)
        out[1:, p0 : p0 + pb] = (d * torch.where(inside, g, 0.0)).sum(dim=-1) * scale
    return out


class GridPrep(NamedTuple):
    """Inputs of `willard_grid` for a whole grid, and the certificate."""

    tier: str             # "x", "plane" or "brute"
    atoms: torch.Tensor   # (1 or nz, 3, M) float32
    starts: torch.Tensor  # (nz, nx) int32
    w: int
    covered: bool         # every grid row's window holds every atom within reach


def _pad_for(sorted_v, lo_min, hi_max, box_l):
    """The fewest boundary copies on each side of sorted coordinates
    (..., n) in [0, L) such that the last copy below, v - L, lies at or below
    lo_min and the last copy above, v + L, at or above hi_max, over every
    leading index, plus one against rounding; at most n."""
    n = sorted_v.shape[-1]
    lo = torch.full(sorted_v.shape[:-1] + (1,), float(lo_min), device=sorted_v.device) + box_l
    hi = torch.full(sorted_v.shape[:-1] + (1,), float(hi_max), device=sorted_v.device) - box_l
    c_lo = torch.searchsorted(sorted_v, lo.to(sorted_v.dtype), right=True)  # v <= lo_min + L
    c_hi = torch.searchsorted(sorted_v, hi.to(sorted_v.dtype))              # v < hi_max - L
    need = int(torch.maximum(n - c_lo + 1, c_hi + 1).max())
    return min(n, need + 1)


def _extend(sorted_pos, pad, axis, box_l):
    """(..., n + 2 pad, 3): the last `pad` entries shifted by -L along
    `axis` before, the first `pad` shifted by +L after."""
    shift = torch.zeros(3, dtype=sorted_pos.dtype, device=sorted_pos.device)
    shift[axis] = box_l
    n = sorted_pos.shape[-2]
    return torch.cat([sorted_pos[..., n - pad :, :] - shift, sorted_pos,
                      sorted_pos[..., :pad, :] + shift], dim=-2)


def _z_sorted(pos, box):
    """(N, 3) atoms wrapped into [0, L), sorted by z (stable)."""
    wrapped = torch.remainder(pos.to(torch.float32), box)
    return wrapped[torch.argsort(wrapped[:, 2], stable=True)]


def brute_prep(pos, box, grid) -> GridPrep:
    """The brute form: every atom once, wrapped and z-sorted, start 0 and
    w = N for every row; exact by construction."""
    (_, _, nx), _, (_, _, nz) = grid
    starts = torch.zeros((nz, nx), dtype=torch.int32, device=pos.device)
    return GridPrep("brute", _z_sorted(pos, box).t().contiguous()[None], starts, pos.shape[0],
                    True)


def grid_prep(pos, box, grid, smoothlen=2.4, window=None, window_x=None) -> GridPrep:
    """The grid kernel's inputs (willard_grid.py:244-353) for atoms pos (N,
    3) float32 in any image and box (3,).

    Atoms are wrapped into [0, L) and z-sorted, with boundary copies
    shifted by -/+Lz; each plane's window holds the atoms within reach
    (3 sigma + CUT_SLACK) of its wrapped z. `window` forces the window
    (at most N), else it is the widest plane's need; the brute form serves
    when that need is N or more, or the reach spans half the z edge. The x
    form then sorts each plane's window by x with boundary copies shifted by
    -/+Lx, each x-row scanning `window_x` of them (at most w; else its
    widest need). It is taken where that need is narrower than w, or where
    `window_x` > 0 is given; `window_x` = 0 keeps the plane form, as does a
    reach spanning half the x edge.

    `covered` holds when every window holds every atom within reach of its
    plane (and of its row, in the x form) and the pads reach that far
    beyond the extreme planes and rows (willard_grid.py:284-291, 347-351).
    """
    dev = pos.device
    n = pos.shape[0]
    (_, _, nx), _, (_, _, nz) = grid
    reach = 3.0 * smoothlen + CUT_SLACK
    lx, lz = float(box[0]), float(box[2])
    sp = _z_sorted(pos, box)
    gxa, _, gza = grid_axes(grid, dev)
    gz_w = torch.remainder(gza, box[2])
    lo, hi = gz_w - reach, gz_w + reach

    if 2.0 * reach >= lz or n == 0:
        return brute_prep(pos, box, grid)
    pad = _pad_for(sp[:, 2].contiguous(), lo.min(), hi.max(), lz)
    ext = _extend(sp, pad, 2, lz)
    ext_z = ext[:, 2].contiguous()
    n_ext = ext.shape[0]
    starts = torch.searchsorted(ext_z, lo)
    ends = torch.searchsorted(ext_z, hi, right=True)
    need = int((ends - starts).max())
    if window is None and need >= n:
        return brute_prep(pos, box, grid)
    w = min(n, need if window is None else window)
    starts = torch.clamp(starts, 0, n_ext - w)
    pad_ok = bool((ext_z[0] <= lo.min()) & (ext_z[-1] >= hi.max()))
    covered = bool(((ends - starts) <= w).all()) and pad_ok
    plane = GridPrep("plane", ext.t().contiguous()[None],
                     starts.to(torch.int32)[:, None].expand(nz, nx).contiguous(), w, covered)
    if window_x == 0 or w == 0 or 2.0 * reach >= lx:
        return plane

    win = ext[starts[:, None] + torch.arange(w, device=dev)]  # (nz, w, 3)
    xw = torch.remainder(win[..., 0], box[0])
    xs, ordx = torch.sort(xw, dim=1, stable=True)
    win_s = torch.gather(win, 1, ordx[..., None].expand(-1, -1, 3)).clone()
    win_s[..., 0] = xs
    gx_w = torch.remainder(gxa, box[0])
    lo_x, hi_x = gx_w - reach, gx_w + reach
    px = _pad_for(xs.contiguous(), lo_x.min(), hi_x.max(), lx)
    extx = _extend(win_s, px, 0, lx)  # (nz, w + 2 px, 3)
    ex_x = extx[..., 0].contiguous()
    n_extx = ex_x.shape[1]
    sx = torch.searchsorted(ex_x, lo_x.expand(nz, nx).contiguous())
    ends_x = torch.searchsorted(ex_x, hi_x.expand(nz, nx).contiguous(), right=True)
    need_x = int((ends_x - sx).max())
    if window_x is None and need_x >= w:
        return plane
    wx = min(w, need_x if window_x is None else window_x)
    sx = torch.clamp(sx, 0, n_extx - wx)
    pad_ok_x = bool((ex_x[:, 0] <= lo_x.min()).all() & (ex_x[:, -1] >= hi_x.max()).all())
    covered = covered and bool(((ends_x - sx) <= wx).all()) and pad_ok_x
    return GridPrep("x", extx.transpose(1, 2).contiguous(), sx.to(torch.int32).contiguous(), wx,
                    covered)


def _unit(nvec):
    """nvec / |nvec| along the last axis, zero vectors left as they are."""
    nn = torch.linalg.vector_norm(nvec, dim=-1, keepdim=True)
    return nvec / torch.where(nn > 0, nn, torch.ones_like(nn))


# `last_tier`: which tier served the most recent `field_from_prep`, "x" |
# "plane" | "brute" | "points" (`covered` failed)
__getattr__ = clock.tier_attr("field_from_prep", __name__)


@clock.traced("dispatch:field_from_prep", device=True)
def field_from_prep(prep: GridPrep, pos, box, grid, smoothlen=2.4):
    """(density (nx, ny, nz), gradient (3, nx, ny, nz)) from the grid kernel
    on `prep` where `prep.covered` holds, else from the points kernel over
    every atom at every grid point (willard_grid.py's caller,
    grids.py:94-104)."""
    (_, _, nx), (_, _, ny), (_, _, nz) = grid
    if prep.covered:
        out = willard_grid(prep.atoms, prep.starts, prep.w, box, grid, smoothlen)
        clock.serve_tier("field_from_prep", prep.tier)
        return out[0], out[1:]
    axes = grid_axes(grid, pos.device)
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
    out = willard_points(pos.to(torch.float32).t().contiguous(), pts, box, smoothlen)
    clock.serve_tier("field_from_prep", "points")
    return out[0].reshape(nx, ny, nz), out[1:].reshape(3, nx, ny, nz)


def density_grid_certified(pos, box, grid, smoothlen=2.4, window=None, window_x=None):
    """Willard-Chandler density (nx, ny, nz) and unit normals (nx, ny, nz,
    3) on `grid` for atoms pos (N, 3) and box (3,), float32: `grid_prep`,
    then `field_from_prep`. `last_tier` names the tier that served."""
    dens, grad = field_from_prep(grid_prep(pos, box, grid, smoothlen, window, window_x),
                                 pos, box, grid, smoothlen)
    return dens, _unit(grad.permute(1, 2, 3, 0))
