"""The column-window contract that the port's neighbor kernels share, its
launcher, and the plain PyTorch form of its scan.

Contract (csrc/qtet_window.cu, csrc/nbr_window.cu): R rows (centers) are
held against one window of `w` columns per row tile. rows (F, 3, R) and
cols (F, 3, C) are f32 with unit stride along their last axis (rows may be
a view into cols); starts (ceil(R / row_tile),) int32 gives each tile's
first column, in [0, C - w]; boxes (F, 3) f32. Coordinates lie in [0, L)
(pad copies within +/-L). A kernel runs blocks of ROWS_PER_BLOCK rows
inside tiles of `row_tile` rows. A window outside the columns gives NaN.

The slab form passes the z-sorted frame as rows and the extended array as
columns; the brute form passes the wrapped frame as both, start 0, w = N.
`certified` chooses between them for the angles, psi6 and LSI kernels.

LSI's kernels also take the raw (stored, not wrapped) coordinates of the
same rows and columns: raw_rows (F, 3, R) and raw_cols (F, 3, C), laid out
as rows and cols (`slab.raw_ext_t`, `slab.brute_raw`); `raw_args` passes
them to the launcher after the contract's arguments.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from waterorderlib_tpu_torch.core.fp32 import fma_f32, sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import build, slab

# rows per thread block of the kernels (kRows in csrc/*.cu); a window tile
# of `row_tile` rows must hold whole blocks
ROWS_PER_BLOCK = 128

_c_ll, _c_int, _c_float, _c_ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def check(rows, cols, starts, boxes, w, row_tile):
    """Raise on inputs the kernels do not take."""
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


def check_raw(rows, cols, raw_rows, raw_cols):
    """Raise unless the raw rows and columns match rows and cols in
    device, dtype and shape, with unit stride along their last axis."""
    for name, t, like in (("raw_rows", raw_rows, rows), ("raw_cols", raw_cols, cols)):
        if t.device != like.device or t.dtype != torch.float32 or t.shape != like.shape:
            raise ValueError(f"{name} must be float32 {tuple(like.shape)} on {like.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs unit stride along its last axis")


def raw_args(raw_rows, raw_cols):
    """The launcher's `extra` arguments for the raw rows and columns."""
    return ((_c_ptr, raw_rows.data_ptr()), (_c_ll, raw_rows.stride(0)), (_c_ll, raw_rows.stride(1)),
            (_c_ptr, raw_cols.data_ptr()), (_c_ll, raw_cols.stride(0)), (_c_ll, raw_cols.stride(1)))


def runs_plain(rows, name: str) -> bool:
    """True for CPU tensors (the plain version serves them); False for CUDA
    tensors (the kernel serves them); any other device raises."""
    if rows.device.type == "cpu":
        return True
    if rows.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, not {rows.device}")
    return False


def launch(source, entry, rows, cols, starts, boxes, w, row_tile, scalars, outs, extra=()):
    """Call `entry` of csrc/<source>.cu on the current stream. Its C
    signature is the contract's arguments, then `extra` ((ctypes type,
    value) pairs, e.g. `raw_args`), then `scalars` as floats, then the
    output pointers, then the stream; it returns the CUDA error code."""
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = [
            _c_ptr, _c_ll, _c_ll, _c_int,          # rows, frame/coord strides, n_rows
            _c_ptr, _c_ll, _c_ll, _c_int,          # cols, frame/coord strides, n_cols
            _c_ptr, _c_int,                        # starts, w
            _c_ptr, _c_int, _c_int,                # boxes, n_frames, row_tile
            *(ctype for ctype, _ in extra),
            *([_c_float] * len(scalars)),
            *([_c_ptr] * len(outs)),
            _c_ptr,                                # stream
        ]
        fn.restype = _c_int
    with torch.cuda.device(rows.device):
        err = fn(
            rows.data_ptr(), rows.stride(0), rows.stride(1), rows.shape[2],
            cols.data_ptr(), cols.stride(0), cols.stride(1), cols.shape[2],
            starts.data_ptr(), w, boxes.data_ptr(), rows.shape[0], row_tile,
            *(value for _, value in extra), *scalars, *(t.data_ptr() for t in outs),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def brute_form(kernel, pos, boxes, row_tile, *scalars, raw=False):
    """`kernel` over whole frames in one launch: rows and columns are the
    wrapped frames, start 0, window = N (with `raw`, the stored frames
    follow as raw rows and columns). pos: (F, N, 3) f32; boxes: (F, 3)."""
    n = pos.shape[1]
    ext_t = slab.brute_cols(pos, boxes)
    starts = torch.zeros(-(-n // row_tile), dtype=torch.int32, device=pos.device)
    extra = (slab.brute_raw(pos),) * 2 if raw else ()
    return kernel(ext_t, ext_t, starts, boxes, n, row_tile, *extra, *scalars)


def certified(kernel, pos, boxes, margin, row_tile, *scalars, raw=False):
    """`kernel` over whole frames with certified exactness (host-level
    dispatch): the slab form when its planned window is narrower than N and
    the prep's `covered` certificate holds at `margin`, else the brute form.
    With `raw`, the kernel also takes the raw rows and columns.

    Returns (the kernel's outputs in the original atom order, tier), tier
    "slab" or "brute".
    """
    n = pos.shape[1]
    win, pad = slab.plan(n, float(boxes[0, 2]), margin, row_tile)
    if win < n:
        prep = slab.slab_prep_traj(pos, boxes, ((margin, win),), row_tile, pad)
        if bool(prep.covered[0].all()):
            extra = ()
            if raw:
                raw_t = slab.raw_ext_t(pos, prep.order0, pad)
                extra = (raw_t[:, :, pad : pad + n], raw_t)
            outs = kernel(prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes,
                          prep.ws[0], row_tile, *extra, *scalars)
            return tuple(slab.unsort_frames(o, prep.order0) for o in outs), "slab"
    return brute_form(kernel, pos, boxes, row_tile, *scalars, raw=raw), "brute"


class TopK(NamedTuple):
    """The k nearest shell neighbors of a tile's rows, in slot order."""

    ux: torch.Tensor     # (F, r, k) unit vectors to the neighbors (0 in empty slots)
    uy: torch.Tensor
    uz: torch.Tensor
    ok: torch.Tensor     # (F, r, k) bool: the slot holds a neighbor
    count: torch.Tensor  # (F, r) int64 full shell count over the window
    dsq: torch.Tensor    # (F, r, k) squared imaged distances (+inf in empty slots)
    col: torch.Tensor    # (F, r, k) int64 column of each slot in `cols` (window
                         # start + offset; meaningless in empty slots)


def dot3(a0, b0, a1, b1, a2, b2, fused: bool):
    """a0*b0 + a1*b1 + a2*b2 in float32: left to right with every step
    rounded (fused=False, the q kernel's --fmad=false arithmetic), or as
    fma(a2, b2, fma(a0, b0, a1*b1)) (fused=True, the explicit fmaf chain of
    nbr_window.cu, which is how XLA contracts the JAX kernels' expression)."""
    if not fused:
        return a0 * b0 + a1 * b1 + a2 * b2
    return fma_f32(a2, b2, fma_f32(a0, b0, a1 * b1))


def window_disp(rows, cols, boxes, r0, r1, s, w):
    """(F, 3, r, w) minimum-image displacements from rows [r0, r1) to the
    columns [s, s + w), column minus row. Coordinates are wrapped into
    [0, L): two compare-selects replace round(), as in the kernels."""
    d = cols[:, :, None, s : s + w] - rows[:, :, r0:r1, None]
    box_l = boxes[:, :, None, None]
    d = torch.where(d > box_l * 0.5, d - box_l, d)
    return torch.where(d < -box_l * 0.5, d + box_l, d)


def topk_tiles(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, k, fused=False):
    """The plain form of the kernels' scan. For each row tile, yields
    (r0, r1, top): the tile's rows [r0, r1) and a TopK from the shell count
    over its window and k rounds of lowest-column minimum extraction (the
    rule of slab.extract_k_min), or top = None for a window outside the
    columns. `fused` selects the kernel's arithmetic for squared lengths
    (`dot3`). Shells are (low_sq, high_sq] on squared distances."""
    dev = rows.device
    n_rows = rows.shape[2]
    low, high = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (low_sq, high_sq))
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    col = torch.arange(w, device=dev)
    for t, s in enumerate(starts.tolist()):
        r0, r1 = t * row_tile, min(n_rows, (t + 1) * row_tile)
        if not 0 <= s <= cols.shape[2] - w:
            yield r0, r1, None
            continue
        d = window_disp(rows, cols, boxes, r0, r1, s, w)  # (F, 3, r, w)
        dsq = dot3(d[:, 0], d[:, 0], d[:, 1], d[:, 1], d[:, 2], d[:, 2], fused)
        valid = (dsq > low) & (dsq <= high)
        count = valid.sum(dim=-1)
        dm = torch.where(valid, dsq, inf)
        units, oks, mins, fcs = [], [], [], []
        for _ in range(k):
            m = dm.min(dim=-1, keepdim=True).values
            eq = (dm == m) & torch.isfinite(dm)
            fc = torch.where(eq, col, w).min(dim=-1, keepdim=True).values
            first = eq & (col == fc)
            oks.append(first.any(dim=-1))
            v = d.gather(3, fc.clamp(max=w - 1)[:, None].expand(-1, 3, -1, -1))[..., 0]
            v = torch.where(oks[-1][:, None], v, 0.0)
            nrm = sqrt_f32(dot3(v[:, 0], v[:, 0], v[:, 1], v[:, 1], v[:, 2], v[:, 2], fused))
            inv = torch.where(nrm > 0, 1.0 / torch.where(nrm > 0, nrm, 1.0), 0.0)
            units.append(v * inv[:, None])
            mins.append(m[..., 0])
            fcs.append(s + fc[..., 0])
            dm = torch.where(first, inf, dm)
        u = torch.stack(units, dim=-1)               # (F, 3, r, k)
        yield r0, r1, TopK(u[:, 0], u[:, 1], u[:, 2], torch.stack(oks, dim=-1), count,
                           torch.stack(mins, dim=-1), torch.stack(fcs, dim=-1))
