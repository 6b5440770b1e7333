"""K-nearest mirrored candidates of the device Voronoi search: the CUDA
kernel's two wrappers and their plain PyTorch versions (port of
waterorderlib_tpu.ops.pallas.voronoi_topk, serving the searches of
waterorderlib_tpu_torch.surface.voronoi_device).

For each center row, over its candidate lanes in lane order: dsq =
((dx*dx) + (dy*dy)) + (dz*dz) with d = center - candidate; lanes with dsq
<= 0 (self and coincident mirrors) or dsq = +inf (parked empty slots) are
dropped; the k smallest are kept in ascending order, ties to the lowest
lane (a stable ascending sort, as `lax.top_k` on -dsq). dist = sqrt(dsq),
correctly rounded; empty slots hold +inf and payload -1.

`voronoi_window_topk`: rows (F, R, 3) z-sorted in blocks of `row_block`;
block b of frame f scans the `win` z-sorted candidates exts[f, starts[f, b]
:][:win]; the payload is the position in the sorted candidate array. Its
kernel scans each row's window outward from the row's own z, nearest
first, and stops a side once the z distance alone exceeds the row's k-th
distance; `_window_split` gives a row of a launch with few rows several
warps.
`voronoi_cellgrid_topk`: each row scans the 27 cells around its cell cid
(dz, then dy, then dx in (-1, 0, 1)), each cell's `cap` table slots in
order; the payload is the table's candidate id. Its kernel has two
mappings, chosen per launch by `_cellgrid_grouped`: grouped, where rows
share cells (`_cellgrid_order` sorts the rows by cell; a block stages one
neighborhood for each run of one cell among its GROUP_ROWS rows), and
direct (one warp a row, for the sparse escalation tiers).

Each wrapper launches its kernel (csrc/voronoi_topk.cu) on CUDA tensors,
which must be float32, and calls its plain version on CPU tensors (float32
or float64); any other device raises. There is no fallback from a kernel to
a plain version. dist has the coordinates' dtype; payloads are int32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import build, window

MAX_K = 256  # kMaxK in csrc/voronoi_topk.cu: the row's list in shared memory
PLAIN_BUDGET = 1 << 25  # (row, lane) distances per step of the plain versions
GROUP_ROWS = 32  # sorted rows a block of the grouped cell-grid mapping takes
GROUP_MIN = 16  # rows to an inner cell from which the grouped mapping is taken
WINDOW_WARPS = 2048  # warps a window launch with few rows is given
WINDOW_SPLITS = (1, 2, 4, 8)  # the warps a row the window kernel is compiled for
SMEM_MAX = build.SMEM_MAX
_WARPS, _BUF = 8, 64  # kWarps, kBuf in csrc/voronoi_topk.cu
# the order in which the cell-grid kernel reads the 27 cells: the row's own
# cell, the 6 that share a face, the 12 that share an edge, the 8 corners
# (each in lane order). The nearest candidates come first, so the k-th
# distance falls early and fewer lanes enter the selection; the result does
# not depend on it (ties go by lane).
SCAN_ORDER = tuple(sorted(range(27), key=lambda o: (
    abs(o // 9 - 1) + abs(o // 3 % 3 - 1) + abs(o % 3 - 1), o)))

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _offsets(n_side: int) -> list[int]:
    """Flat cell offsets of a cell's 27 neighbors, in the lane order."""
    return [(dz * n_side + dy) * n_side + dx
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _check_coords(kernel: bool, **coords):
    dev = next(iter(coords.values())).device
    allowed = (torch.float32,) if kernel else (torch.float32, torch.float64)
    dtype = None
    for name, t in coords.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype not in allowed:
            raise TypeError(f"{name} must be {' or '.join(map(str, allowed))}, got {t.dtype}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the other coordinates {dtype}")
        dtype = t.dtype
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_k(k: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")


def _check_window(centers, exts, starts, k, row_block, win):
    if centers.dim() != 3 or centers.shape[2] != 3 or exts.dim() != 3 or exts.shape[2] != 3:
        raise ValueError(f"centers and exts must be (F, n, 3), got {tuple(centers.shape)}, "
                         f"{tuple(exts.shape)}")
    F, R, _ = centers.shape
    if exts.shape[0] != F:
        raise ValueError(f"frame counts differ: centers {F}, exts {exts.shape[0]}")
    if row_block < 1 or R % row_block:
        raise ValueError(f"{R} rows are not whole blocks of row_block={row_block}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (F, R // row_block):
        raise ValueError(f"starts must be int32 (F, n_blocks) = {(F, R // row_block)}, got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    if starts.device != centers.device or not starts.is_contiguous():
        raise ValueError("starts must be contiguous, on the centers' device")
    if not 0 < win <= exts.shape[1]:
        raise ValueError(f"window win={win} must lie in (0, {exts.shape[1]}]")
    _check_k(k)


def _check_cellgrid(centers, cid, tbl_pos, tbl_idx, n_side, k):
    if centers.dim() != 3 or centers.shape[2] != 3:
        raise ValueError(f"centers must be (F, R, 3), got {tuple(centers.shape)}")
    F, R, _ = centers.shape
    n_cells = n_side ** 3
    cap = tbl_idx.shape[-1] if tbl_idx.dim() == 3 else -1
    if tbl_idx.dim() != 3 or tuple(tbl_idx.shape) != (F, n_cells, cap):
        raise ValueError(f"tbl_idx must be (F, n_side^3, cap) = ({F}, {n_cells}, cap), got "
                         f"{tuple(tbl_idx.shape)}")
    if tuple(tbl_pos.shape) != (F, n_cells, 3, cap):
        raise ValueError(f"tbl_pos must be (F, n_side^3, 3, cap) = {(F, n_cells, 3, cap)}, got "
                         f"{tuple(tbl_pos.shape)}")
    for name, t in (("cid", cid), ("tbl_idx", tbl_idx)):
        if t.dtype != torch.int32 or t.device != centers.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {centers.device}")
    if tuple(cid.shape) != (F, R):
        raise ValueError(f"cid must be (F, R) = {(F, R)}, got {tuple(cid.shape)}")
    if n_side < 3:
        raise ValueError(f"n_side={n_side} must be at least 3")
    _check_k(k)


def _launch(entry, argtypes, args):
    fn = getattr(build.load("voronoi_topk"), entry)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, _c_ptr]
        fn.restype = _c_int
    with torch.cuda.device(args[0].device):
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _window_split(n_rows: int) -> int:
    """Warps a row of a window launch takes (WINDOW_SPLITS): one where the
    launch has WINDOW_WARPS rows or more (tier 1: 32,768 rows at 2,048
    waters x 16 frames), else the least that brings the launch to
    WINDOW_WARPS warps, at most 8 (the last tier's full scans: 2 at a
    16-frame chunk's 1,024 rows; 8 at one frame's 64). More warps a row
    shorten its serial scan but test more lanes under a looser bound. On
    the H100 (PERF.md) 1 a row won at 4,096 and 32,768 rows, and at k 256
    2 won at 1,024 and 512 rows, 4 at 256, 8 at 128 and 64; the pick is
    within 0.01 ms of the best at each."""
    split = WINDOW_SPLITS[0]
    for split in WINDOW_SPLITS:
        if n_rows * split >= WINDOW_WARPS:
            break
    return split


def grouped_smem(cap: int) -> int:
    """Shared memory of one block of the grouped cell-grid mapping: the
    warps' key buffers (8 bytes a key), the 27 cells' staged slots (x, y,
    z, tag and the candidate id: 20 bytes a slot) and the cell offsets."""
    return _WARPS * _BUF * 8 + 27 * cap * 20 + 28 * 4


def _cellgrid_grouped(n_rows: int, n_side: int, cap: int) -> bool:
    """The grouped mapping where a frame's rows are at least GROUP_MIN to
    an inner cell (tier 1: ~24 at 12,294 points) and the staged cells fit a
    block (cap <= 422); else the direct one (the escalation tiers' subsets:
    ~8 rows to an inner cell at k 96, about one beyond, where staging a
    neighborhood for a few rows costs more than it saves)."""
    return n_rows >= GROUP_MIN * (n_side - 2) ** 3 and grouped_smem(cap) <= SMEM_MAX


def _cellgrid_order(cid):
    """The grouped mapping's row order: each frame's rows sorted stably by
    their cell, as global row ids f * R + r (F * R,) int32. A block takes
    GROUP_ROWS consecutive ones and stages one neighborhood for each run of
    one cell among them."""
    F, R = cid.shape
    order = torch.sort(cid, dim=-1, stable=True)[1]
    return (order + torch.arange(F, device=cid.device)[:, None] * R).to(torch.int32).reshape(-1)


_SCAN_T: dict = {}


def _scan_order(dev):
    t = _SCAN_T.get(dev)
    if t is None:
        t = _SCAN_T[dev] = torch.tensor(SCAN_ORDER, dtype=torch.int32, device=dev)
    return t


def _sqrt(x):
    return sqrt_f32(x) if x.dtype == torch.float32 else torch.sqrt(x)


def _dsq(c, x, y, z):
    """((dx*dx) + (dy*dy)) + (dz*dz) of rows c (..., 3) against lanes
    (..., L) with d = c - lane."""
    dx, dy, dz = c[..., 0, None] - x, c[..., 1, None] - y, c[..., 2, None] - z
    return (dx * dx + dy * dy) + dz * dz


def _select(dsq, k):
    """(dist, lane) of the k smallest positive finite dsq over the last
    axis, ascending, ties to the lowest lane; lane -1 where empty."""
    masked = torch.where(dsq > 0, dsq, torch.full_like(dsq, math.inf))
    top, lane = torch.sort(masked, dim=-1, stable=True)
    top, lane = top[..., :k], lane[..., :k]
    if top.shape[-1] < k:  # fewer lanes than slots
        pad = k - top.shape[-1]
        top = torch.nn.functional.pad(top, (0, pad), value=math.inf)
        lane = torch.nn.functional.pad(lane, (0, pad))
    ok = torch.isfinite(top)
    dist = torch.where(ok, _sqrt(torch.where(ok, top, torch.zeros_like(top))), top)
    return dist, torch.where(ok, lane, torch.full_like(lane, -1)), ok


@clock.kernel
def voronoi_window_topk(centers, exts, starts, k, row_block, win, tested=None):
    """The k nearest of each row's window: (dist (F, R, k), pos (F, R, k)
    int32 positions in the sorted candidates, -1 where empty). centers
    (F, R, 3) z-sorted rows, R a multiple of row_block; exts (F, P, 3)
    z-sorted candidates; starts (F, R / row_block) int32 in [0, P - win].
    `tested`: None, or (kernel only) an int64 (1,) tensor on the centers'
    device to which the kernel adds the (row, lane) pairs it offered to its
    selection."""
    _check_coords(centers.device.type == "cuda", centers=centers, exts=exts)
    _check_window(centers, exts, starts, k, row_block, win)
    if tested is not None and (tested.device != centers.device or tested.dtype != torch.int64
                               or tuple(tested.shape) != (1,)):
        raise ValueError("tested must be an int64 (1,) tensor on the centers' device")
    if window.runs_plain(centers, "voronoi_window_topk"):
        if tested is not None:
            raise ValueError("tested counts the kernel's lanes; CPU tensors run the plain version")
        return voronoi_window_topk_plain(centers, exts, starts, k, row_block, win)
    F, R, _ = centers.shape
    dist = torch.empty((F, R, k), dtype=torch.float32, device=centers.device)
    pos = torch.empty((F, R, k), dtype=torch.int32, device=centers.device)
    _launch("voronoi_window_topk_launch",
            [_c_ptr, _c_int, _c_int, _c_ptr, _c_int, _c_ptr, _c_int, _c_int, _c_int, _c_int,
             _c_int, _c_ptr, _c_ptr, _c_ptr],
            (centers, R, row_block, exts, exts.shape[1], starts, R // row_block, win, k, F,
             _window_split(F * R), tested, dist, pos))
    clock.count("launches:voronoi_window_topk")
    return dist, pos


@clock.plain
def voronoi_window_topk_plain(centers, exts, starts, k, row_block, win):
    """Plain PyTorch version of `voronoi_window_topk`, in steps of row
    blocks."""
    _check_coords(False, centers=centers, exts=exts)
    _check_window(centers, exts, starts, k, row_block, win)
    F, R, _ = centers.shape
    nb = R // row_block
    dist = torch.empty((F, R, k), dtype=centers.dtype, device=centers.device)
    pos = torch.empty((F, R, k), dtype=torch.int32, device=centers.device)
    lanes = torch.arange(win, device=centers.device)
    step = max(1, PLAIN_BUDGET // (row_block * win))
    for f in range(F):
        for b0 in range(0, nb, step):
            b1 = min(nb, b0 + step)
            st = starts[f, b0:b1].long()
            cand = exts[f][st[:, None] + lanes[None, :]]  # (nbc, win, 3)
            c = centers[f, b0 * row_block : b1 * row_block].reshape(b1 - b0, row_block, 3)
            d, lane, ok = _select(_dsq(c, cand[:, None, :, 0], cand[:, None, :, 1],
                                       cand[:, None, :, 2]), k)
            p = torch.where(ok, st[:, None, None] + lane, lane)
            dist[f, b0 * row_block : b1 * row_block] = d.reshape(-1, k)
            pos[f, b0 * row_block : b1 * row_block] = p.reshape(-1, k).to(torch.int32)
    return dist, pos


@clock.kernel
def voronoi_cellgrid_topk(centers, cid, tbl_pos, tbl_idx, n_side, k):
    """The k nearest of each row's 27-cell neighborhood: (dist (F, R, k),
    idx (F, R, k) int32 candidate ids, -1 where empty). centers (F, R, 3);
    cid (F, R) int32 each row's cell, every coordinate in [1, n_side - 2];
    tbl_pos (F, n_side^3, 3, cap) each cell's slots as planes x, y, z
    (+inf where empty); tbl_idx (F, n_side^3, cap) int32 ids (-1 where
    empty)."""
    _check_coords(centers.device.type == "cuda", centers=centers, tbl_pos=tbl_pos)
    _check_cellgrid(centers, cid, tbl_pos, tbl_idx, n_side, k)
    if window.runs_plain(centers, "voronoi_cellgrid_topk"):
        return voronoi_cellgrid_topk_plain(centers, cid, tbl_pos, tbl_idx, n_side, k)
    F, R, _ = centers.shape
    cap = tbl_idx.shape[-1]
    dist = torch.empty((F, R, k), dtype=torch.float32, device=centers.device)
    idx = torch.empty((F, R, k), dtype=torch.int32, device=centers.device)
    order = _cellgrid_order(cid) if _cellgrid_grouped(R, n_side, cap) else None
    _launch("voronoi_cellgrid_topk_launch",
            [_c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr,
             _c_ptr, _c_int, _c_ptr, _c_ptr],
            (centers, cid, R, tbl_pos, tbl_idx, n_side, cap, k, F, _scan_order(centers.device),
             order, GROUP_ROWS, dist, idx))
    clock.count("launches:voronoi_cellgrid_topk")
    return dist, idx


@clock.plain
def voronoi_cellgrid_topk_plain(centers, cid, tbl_pos, tbl_idx, n_side, k):
    """Plain PyTorch version of `voronoi_cellgrid_topk`: each row's 27
    cells gathered as lanes o * cap + slot, in steps of rows."""
    _check_coords(False, centers=centers, tbl_pos=tbl_pos)
    _check_cellgrid(centers, cid, tbl_pos, tbl_idx, n_side, k)
    F, R, _ = centers.shape
    cap = tbl_idx.shape[-1]
    offs = torch.tensor(_offsets(n_side), device=centers.device)
    dist = torch.empty((F, R, k), dtype=centers.dtype, device=centers.device)
    idx = torch.empty((F, R, k), dtype=torch.int32, device=centers.device)
    step = max(1, PLAIN_BUDGET // (27 * cap))
    for f in range(F):
        for r0 in range(0, R, step):
            r1 = min(R, r0 + step)
            cells = cid[f, r0:r1, None].long() + offs  # (rc, 27)
            planes = tbl_pos[f][cells]  # (rc, 27, 3, cap)
            x, y, z = (planes[:, :, a].reshape(r1 - r0, 27 * cap) for a in range(3))
            ids = tbl_idx[f][cells].reshape(r1 - r0, 27 * cap)
            d, lane, ok = _select(_dsq(centers[f, r0:r1], x, y, z), k)
            dist[f, r0:r1] = d
            idx[f, r0:r1] = torch.where(ok, ids.gather(1, lane.clamp(min=0)), lane).to(torch.int32)
    return dist, idx
