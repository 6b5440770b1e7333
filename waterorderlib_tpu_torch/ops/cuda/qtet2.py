"""q_tet over z-slab windows: the CUDA kernel's wrapper, its plain PyTorch
version, and the host dispatch (port of waterorderlib_tpu.ops.pallas.qtet2).

One kernel contract (`q_window`) serves these uses:
- the slab form (`order_param_q_traj`): rows are the z-sorted frame, columns
  the extended array `SlabPrep.ext_t`, one window start per row tile (with
  starts (F, n_tiles), one per frame and tile: ops/cuda/qtet_sorted.py's
  per-frame sort);
- the brute form (`order_param_q_frames`): rows and columns are the wrapped
  frame, start 0, window = N;
- the straggler patch in `order_param_q_certified`: rows are one frame's
  uncertified atoms, columns that frame, start 0, window = N.
`q_window_hist` is the same kernel with the dense q kernel's fused 500-bin
histogram in its epilogue (ops/cuda/qtet_kernel.py).

Each wrapper launches its kernel (csrc/qtet_window.cu) on a CUDA tensor and
calls its plain version on a CPU tensor; any other device raises. There is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.ops.cuda import window
from waterorderlib_tpu_torch.ops.cuda.slab import (
    brute_cols, plan, slab_prep_traj, unsort_frames,
)

Q_BINS = 500  # the fused q histogram's bins over [0, 1]


def _starts_stride(rows, cols, starts, boxes, w, row_tile) -> int:
    """window.check, with `starts` either (n_tiles,), shared by all frames,
    or (F, n_tiles), one start per (frame, tile); returns the starts' frame
    stride (0 when shared)."""
    if starts.dim() != 2:
        window.check(rows, cols, starts, boxes, w, row_tile)
        return 0
    if starts.shape[0] != rows.shape[0] or not starts.is_contiguous():
        raise ValueError(f"per-frame starts must be contiguous ({rows.shape[0]}, n_tiles), got "
                         f"{tuple(starts.shape)}")
    window.check(rows, cols, starts[0], boxes, w, row_tile)
    return starts.shape[1]


def _launch(entry, rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq, outs):
    stride = _starts_stride(rows, cols, starts, boxes, w, row_tile)
    window.launch("qtet_window", entry, rows, cols, starts, boxes, w, row_tile,
                  (low_sq, high_sq, margin_sq), outs, extra=((ctypes.c_longlong, stride),))


def _outputs(rows):
    F, _, n_rows = rows.shape
    return (torch.empty((F, n_rows), dtype=torch.float32, device=rows.device),
            torch.empty((F, n_rows), dtype=torch.bool, device=rows.device))


@clock.kernel
def q_window(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """q_tet and the per-row exactness flag of R rows against one column
    window per row tile (the contract of ops/cuda/window.py; `starts` may
    also be (F, n_tiles), one window start per frame and tile).

    low_sq, high_sq, margin_sq: squared shell bounds and margin.

    Returns (q (F, R) f32, ok (F, R) bool): ok says the 4th neighbor slot is
    filled and lies within margin. An out-of-range window start gives q = NaN.
    """
    if window.runs_plain(rows, "q_window"):
        return q_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq)
    q, ok = _outputs(rows)
    _launch("qtet_window_launch", rows, cols, starts, boxes, w, row_tile, low_sq, high_sq,
            margin_sq, (q, ok))
    clock.count("launches:q_window")
    return q, ok


@clock.kernel
def q_window_hist(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """`q_window` and, from the same kernel's epilogue, the 500-bin
    histogram of every row's q over [0, 1] (`q_hist`'s rule). Returns (q,
    ok, hist (500,) int32)."""
    if window.runs_plain(rows, "q_window_hist"):
        return q_window_hist_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq,
                                   margin_sq)
    q, ok = _outputs(rows)
    hist = torch.zeros(Q_BINS, dtype=torch.int32, device=rows.device)
    _launch("qtet_window_hist_launch", rows, cols, starts, boxes, w, row_tile, low_sq, high_sq,
            margin_sq, (q, ok, hist))
    clock.count("launches:q_window_hist")
    return q, ok, hist


def _q_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    _starts_stride(rows, cols, starts, boxes, w, row_tile)
    if starts.dim() == 2:  # one window start per (frame, tile): frame by frame
        outs = [_q_plain(rows[f : f + 1], cols[f : f + 1], starts[f], boxes[f : f + 1], w,
                         row_tile, low_sq, high_sq, margin_sq) for f in range(rows.shape[0])]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    q, ok = _outputs(rows)
    for r0, r1, top in window.topk_tiles(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, 4):
        if top is None:  # a window outside the columns
            q[:, r0:r1], ok[:, r0:r1] = math.nan, False
            continue
        ssum = torch.zeros_like(top.dsq[..., 0])
        for a in range(4):
            for b in range(a + 1, 4):
                cosv = (top.ux[..., a] * top.ux[..., b] + top.uy[..., a] * top.uy[..., b]
                        + top.uz[..., a] * top.uz[..., b])
                cosv = torch.where(top.ok[..., a] & top.ok[..., b], cosv.clamp(-1.0, 1.0), -1.0)
                ssum = ssum + (cosv + 1.0 / 3.0) ** 2
        q[:, r0:r1] = torch.where(top.count > 0, 1.0 - 0.375 * ssum, 0.0)
        ok[:, r0:r1] = top.ok[..., 3] & (top.dsq[..., -1] <= torch.tensor(margin_sq, dtype=torch.float32))
    return q, ok


@clock.plain
def q_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """Plain PyTorch version of `q_window`, same contract and tie-break
    (4 rounds of lowest-column minimum extraction, as slab.extract_k_min)."""
    return _q_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq)


@clock.plain
def q_window_hist_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq):
    """Plain PyTorch version of `q_window_hist`."""
    q, ok = _q_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, margin_sq)
    return q, ok, q_hist(q)


def q_hist(q: torch.Tensor) -> torch.Tensor:
    """The fused histogram rule of the JAX package's dense q kernel
    (qtet_kernel.py:101-119): q in [0, 1] goes to bin floor(q * 500) in
    float32, q == 1 to the last bin; other values (NaN) to none. Returns
    (500,) int32 counts. This is not `histograms.masked_histogram`'s
    threshold rule, which can put a value on a bin edge one bin apart."""
    qf = q.reshape(-1)
    qf = qf[(qf >= 0.0) & (qf <= 1.0)]
    b = torch.where(qf == 1.0, Q_BINS - 1, torch.floor(qf * float(Q_BINS)).to(torch.int64))
    return torch.bincount(b[b < Q_BINS], minlength=Q_BINS).to(torch.int32)


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
    ext_t = brute_cols(pos, boxes)
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
    prep = slab_prep_traj(pos, boxes, ((margin, window),), row_tile, pad)
    rows = prep.ext_t[:, :, pad : pad + n]
    q, ok = q_window(
        rows, prep.ext_t, prep.starts[0], boxes, prep.ws[0], row_tile,
        _sq(low_cut), _sq(high_cut), _sq(margin),
    )
    if not unsort:
        return q, ok, prep.covered[0]
    return unsort_frames(q, prep.order0), unsort_frames(ok, prep.order0), prep.covered[0]


# `last_tier`: which tier served the most recent order_param_q_certified
# call, "slab" | "brute" (the registry's `tier:order_param_q_certified:*`)
__getattr__ = clock.tier_attr("order_param_q_certified", __name__)


def _patch_stragglers(q, bad, pos, boxes, low_cut, high_cut, row_tile):
    """Recompute the uncertified rows of each frame with the brute form of
    the same kernel contract (rows = those atoms, columns = the frame)."""
    n = pos.shape[1]
    for f in torch.nonzero(bad.any(dim=1)).flatten().tolist():
        idx = torch.nonzero(bad[f]).flatten()
        cols = brute_cols(pos[f : f + 1], boxes[f : f + 1])
        rows = cols[:, :, idx].contiguous()
        starts = torch.zeros(-(-idx.numel() // row_tile), dtype=torch.int32, device=pos.device)
        qf, _ = q_window(
            rows, cols, starts, boxes[f : f + 1], n, row_tile,
            _sq(low_cut), _sq(high_cut), _sq(high_cut),
        )
        q[f, idx] = qf[0]


@clock.traced("dispatch:order_param_q_certified", device=True)
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
    n = pos.shape[1]
    window, pad = plan(n, float(boxes[0, 2]), margin, row_tile)
    if window < n:
        q, ok, cov = order_param_q_traj(
            pos, boxes, low_cut, high_cut, margin=margin,
            row_tile=row_tile, window=window, pad=pad,
        )
        if bool(cov.all()):
            bad = ~ok
            if bool(ok.all()) or float(bad.float().mean()) < 1e-3:
                if not bool(ok.all()):
                    _patch_stragglers(q, bad, pos, boxes, low_cut, high_cut, row_tile)
                clock.serve_tier("order_param_q_certified", "slab")
                return q
    clock.serve_tier("order_param_q_certified", "brute")
    return order_param_q_frames(pos, boxes, low_cut, high_cut, row_tile=row_tile)
