"""q_tet over z-slab windows: the CUDA kernel's wrapper, its plain PyTorch
version, and the host dispatch (port of waterorderlib_tpu.ops.pallas.qtet2).

One kernel contract (`q_window`) serves three uses:
- the slab form (`order_param_q_traj`): rows are the z-sorted frame, columns
  the extended array `SlabPrep.ext_t`, one window start per row tile;
- the brute form (`order_param_q_frames`): rows and columns are the wrapped
  frame, start 0, window = N;
- the straggler patch in `order_param_q_certified`: rows are one frame's
  uncertified atoms, columns that frame, start 0, window = N.

`q_window` launches the kernel (csrc/qtet_window.cu) on a CUDA tensor and
calls `q_window_plain` on a CPU tensor; any other device raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from waterorderlib_tpu_torch.ops.cuda import build
from waterorderlib_tpu_torch.ops.cuda.slab import slab_prep_traj, suggest_pad, unsort_frames

# rows per thread block of the kernel (kRows in csrc/qtet_window.cu); a
# window tile of `row_tile` rows must hold whole blocks
ROWS_PER_BLOCK = 128

_c_ll, _c_int, _c_float, _c_ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _launcher():
    fn = build.load("qtet_window").qtet_window_launch
    if fn.argtypes is None:
        fn.argtypes = [
            _c_ptr, _c_ll, _c_ll, _c_int,          # rows, frame/coord strides, n_rows
            _c_ptr, _c_ll, _c_ll, _c_int,          # cols, frame/coord strides, n_cols
            _c_ptr, _c_int,                        # starts, w
            _c_ptr, _c_int, _c_int,                # boxes, n_frames, row_tile
            _c_float, _c_float, _c_float,          # low^2, high^2, margin^2
            _c_ptr, _c_ptr, _c_ptr,                # q, ok, stream
        ]
        fn.restype = _c_int
    return fn


def _check(rows, cols, starts, boxes, w, row_tile):
    dev = rows.device
    for name, t in (("cols", cols), ("starts", starts), ("boxes", boxes)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
    for name, t in (("rows", rows), ("cols", cols), ("boxes", boxes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"starts must be int32, got {starts.dtype}")
    if rows.dim() != 3 or rows.shape[1] != 3 or cols.dim() != 3 or cols.shape[1] != 3:
        raise ValueError(f"rows and cols must be (F, 3, n), got {tuple(rows.shape)}, {tuple(cols.shape)}")
    F, _, n_rows = rows.shape
    if cols.shape[0] != F or tuple(boxes.shape) != (F, 3):
        raise ValueError(f"frame counts differ: rows {F}, cols {cols.shape[0]}, boxes {tuple(boxes.shape)}")
    if rows.stride(2) != 1 or cols.stride(2) != 1:
        raise ValueError("rows and cols need unit stride along their last axis")
    if not (boxes.is_contiguous() and starts.is_contiguous()):
        raise ValueError("boxes and starts must be contiguous")
    if row_tile <= 0 or row_tile % ROWS_PER_BLOCK:
        raise ValueError(f"row_tile={row_tile} must be a positive multiple of {ROWS_PER_BLOCK}")
    if tuple(starts.shape) != (-(-n_rows // row_tile),):
        raise ValueError(f"starts must hold one entry per row tile, got {tuple(starts.shape)}")
    if not 0 < w <= cols.shape[2]:
        raise ValueError(f"window w={w} must lie in (0, {cols.shape[2]}]")


def q_window(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """q_tet and the per-row exactness flag of R rows against one column
    window per row tile.

    rows: (F, 3, R) f32, unit stride along R (a view into `cols` is fine);
    cols: (F, 3, C) f32, unit stride along C; starts: (ceil(R/row_tile),)
    int32 first column of each tile's window, each in [0, C - w]; boxes:
    (F, 3) f32. Coordinates must lie in [0, L) (pad copies within +/-L).
    low_sq, high_sq, margin_sq: squared shell bounds and margin.

    Returns (q (F, R) f32, ok (F, R) bool): ok says the 4th neighbor slot is
    filled and lies within margin. An out-of-range window start gives q = NaN.
    """
    _check(rows, cols, starts, boxes, w, row_tile)
    if rows.device.type == "cpu":
        return q_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq)
    if rows.device.type != "cuda":
        raise RuntimeError(f"q_window runs on cuda or cpu tensors, not {rows.device}")
    F, _, n_rows = rows.shape
    q = torch.empty((F, n_rows), dtype=torch.float32, device=rows.device)
    ok = torch.empty((F, n_rows), dtype=torch.bool, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _launcher()(
            rows.data_ptr(), rows.stride(0), rows.stride(1), n_rows,
            cols.data_ptr(), cols.stride(0), cols.stride(1), cols.shape[2],
            starts.data_ptr(), w, boxes.data_ptr(), F, row_tile,
            low_sq, high_sq, margin_sq, q.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qtet_window kernel launch failed: CUDA error {err}")
    q_window.launches += 1
    return q, ok


q_window.launches = 0


def _mi(d, box_l):
    # coordinates are wrapped into [0, L); two compare-selects replace round()
    d = torch.where(d > box_l * 0.5, d - box_l, d)
    return torch.where(d < -box_l * 0.5, d + box_l, d)


def q_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """Plain PyTorch version of `q_window`, same contract and tie-break
    (4 rounds of lowest-column minimum extraction, as slab.extract_k_min)."""
    _check(rows, cols, starts, boxes, w, row_tile)
    q_window_plain.calls += 1
    F, _, n_rows = rows.shape
    dev = rows.device
    low, high, marg = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (low_sq, high_sq, margin_sq))
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    col = torch.arange(w, device=dev)
    q = torch.empty((F, n_rows), dtype=torch.float32, device=dev)
    ok = torch.empty((F, n_rows), dtype=torch.bool, device=dev)
    for t, s in enumerate(starts.tolist()):
        r0, r1 = t * row_tile, min(n_rows, (t + 1) * row_tile)
        if not 0 <= s <= cols.shape[2] - w:  # a window outside the columns
            q[:, r0:r1], ok[:, r0:r1] = math.nan, False
            continue
        xr = rows[:, :, r0:r1, None]                 # (F, 3, r, 1)
        xs = cols[:, :, None, s : s + w]             # (F, 3, 1, w)
        d = _mi(xs - xr, boxes[:, :, None, None])    # (F, 3, r, w)
        dsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        valid = (dsq > low) & (dsq <= high)
        count = valid.sum(dim=-1)
        dm = torch.where(valid, dsq, inf)
        units, oks = [], []
        for _ in range(4):
            m = dm.min(dim=-1, keepdim=True).values
            eq = (dm == m) & torch.isfinite(dm)
            fc = torch.where(eq, col, w).min(dim=-1, keepdim=True).values
            first = eq & (col == fc)
            oks.append(first.any(dim=-1))
            v = d.gather(3, fc.clamp(max=w - 1)[:, None].expand(-1, 3, -1, -1))[..., 0]
            nrm = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
            inv = torch.where(nrm > 0, 1.0 / torch.where(nrm > 0, nrm, 1.0), 0.0)
            units.append(v * inv[:, None])
            last_d = m[..., 0]
            dm = torch.where(first, inf, dm)
        ssum = torch.zeros_like(last_d)
        for a in range(4):
            for b in range(a + 1, 4):
                ua, ub = units[a], units[b]
                cosv = ua[:, 0] * ub[:, 0] + ua[:, 1] * ub[:, 1] + ua[:, 2] * ub[:, 2]
                cosv = torch.where(oks[a] & oks[b], cosv.clamp(-1.0, 1.0), -1.0)
                ssum = ssum + (cosv + 1.0 / 3.0) ** 2
        q[:, r0:r1] = torch.where(count > 0, 1.0 - 0.375 * ssum, 0.0)
        ok[:, r0:r1] = oks[3] & (last_d <= marg)
    return q, ok


q_window_plain.calls = 0


def _sq(v: float) -> float:
    return v * v


def order_param_q_frames(
    pos: torch.Tensor,
    boxes: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    row_tile: int = 256,
) -> torch.Tensor:
    """Brute whole-trajectory q_tet, one launch: every row against all N
    columns. pos: (F, N, 3) f32; boxes: (F, 3) f32. Returns q (F, N)."""
    n = pos.shape[1]
    ext_t = torch.remainder(pos, boxes[:, None, :]).transpose(1, 2).contiguous()
    starts = torch.zeros(-(-n // row_tile), dtype=torch.int32, device=pos.device)
    q, _ = q_window(
        ext_t, ext_t, starts, boxes, n, row_tile, _sq(low_cut), _sq(high_cut), _sq(high_cut)
    )
    return q


def order_param_q_traj(
    pos: torch.Tensor,
    boxes: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    margin: float = 4.5,
    row_tile: int = 256,
    window: int = 1536,
    pad: int = 512,
    unsort: bool = True,
):
    """Slab-pruned whole-trajectory q_tet with the frame-0 persistent
    z-ordering. Per-atom `ok` certifies exactness; `covered` certifies window
    coverage at the drift-inflated margin.

    Returns (q (F, N) in original atom order when unsort, ok (F, N) bool,
    covered (F,) bool).
    """
    n = pos.shape[1]
    prep = slab_prep_traj(pos, boxes, margin, row_tile, window, pad)
    rows = prep.ext_t[:, :, pad : pad + n]
    q, ok = q_window(
        rows, prep.ext_t, prep.starts, boxes, prep.w, row_tile,
        _sq(low_cut), _sq(high_cut), _sq(margin),
    )
    if not unsort:
        return q, ok, prep.covered
    return unsort_frames(q, prep.order0), unsort_frames(ok, prep.order0), prep.covered


def suggest_window(n: int, box_z: float, margin: float = 4.5, row_tile: int = 256,
                   safety: float = 1.35) -> int:
    """Window width (multiple of 128) expected to cover a tile's slab."""
    tile_extent = row_tile / n * box_z
    slab = tile_extent + 2.0 * margin
    est = n * slab / box_z * safety + 256
    return int(-(-est // 128) * 128)


# which tier served the most recent order_param_q_certified call:
# "slab" | "brute" (drivers log it)
last_tier: str = "none"


def _patch_stragglers(q, bad, pos, boxes, low_cut, high_cut, row_tile):
    """Recompute the uncertified rows of each frame with the brute form of
    the same kernel contract (rows = those atoms, columns = the frame)."""
    n = pos.shape[1]
    for f in torch.nonzero(bad.any(dim=1)).flatten().tolist():
        idx = torch.nonzero(bad[f]).flatten()
        cols = torch.remainder(pos[f : f + 1], boxes[f : f + 1, None, :]).transpose(1, 2).contiguous()
        rows = cols[:, :, idx].contiguous()
        starts = torch.zeros(-(-idx.numel() // row_tile), dtype=torch.int32, device=pos.device)
        qf, _ = q_window(
            rows, cols, starts, boxes[f : f + 1], n, row_tile,
            _sq(low_cut), _sq(high_cut), _sq(high_cut),
        )
        q[f, idx] = qf[0]


def order_param_q_certified(
    pos: torch.Tensor,
    boxes: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    row_tile: int = 256,
    margin: float = 4.5,
) -> torch.Tensor:
    """q with certified exactness (host-level dispatch).

    Runs the slab-pruned form and checks its certificates on the host. Atoms
    whose per-atom certificate fails (4th neighbor beyond `margin`) are
    recomputed with the brute form over just those rows when they are under
    0.1% of all; a window-coverage failure, or more stragglers, runs the
    brute form over everything. pos: (F, N, 3) f32; boxes: (F, 3) f32.
    Returns q (F, N) in the original atom order.
    """
    global last_tier

    n = pos.shape[1]
    box_z = float(boxes[0, 2])
    window = suggest_window(n, box_z, margin=margin, row_tile=row_tile)
    # pad must span at least the drift-inflated margin in z (the covered
    # certificate verifies) and the last row tile's remainder
    pad = max(suggest_pad(n, box_z, margin + 2.0), min(n, -n % row_tile))
    if window < n:
        last_tier = "slab"
        q, ok, cov = order_param_q_traj(
            pos, boxes, low_cut, high_cut, margin=margin,
            row_tile=row_tile, window=window, pad=pad,
        )
        if bool(cov.all()):
            if bool(ok.all()):
                return q
            bad = ~ok
            if float(bad.float().mean()) < 1e-3:
                _patch_stragglers(q, bad, pos, boxes, low_cut, high_cut, row_tile)
                return q
    last_tier = "brute"
    return order_param_q_frames(pos, boxes, low_cut, high_cut, row_tile=row_tile)
