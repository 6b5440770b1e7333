"""Dense q_tet of all waters against all waters, with its 500-bin q
histogram (port of waterorderlib_tpu.ops.pallas.qtet_kernel:
`order_param_q_pallas` and `order_param_q_pallas_frames`).

Both run the brute form of the q kernel contract (ops/cuda/qtet2.py): rows
and columns are the wrapped frames, window start 0, window = N.
`order_param_q_dense` launches the kernel's histogram entry point
(`q_window_hist`, csrc/qtet_window.cu `qtet_window_hist_launch`), which bins
each row's q with the JAX kernel's fused rule (`qtet2.q_hist`).
`order_param_q_dense_frames` launches the q kernel over all frames at once
and bins with `histograms.masked_histogram`, as the JAX function does
outside its kernel (its docstring says the histogram is accumulated in the
kernel; its code does not). Counts are integers, where the JAX functions
return float32: the two are exact below 2^24.
"""

from __future__ import annotations

import torch

from waterorderlib_tpu_torch.ops import histograms
from waterorderlib_tpu_torch.ops.cuda import qtet2
from waterorderlib_tpu_torch.ops.cuda.slab import brute_cols


def order_param_q_dense(pos: torch.Tensor, box: torch.Tensor, low_cut: float = 0.0,
                        high_cut: float = 10.0, row_tile: int = 128):
    """q of all positions against themselves and its fused histogram.

    pos: (N, 3) f32; box: (3,) f32. Returns (q (N,), hist (500,) int32: q
    over [0, 1] in 500 bins, bin floor(q * 500), q == 1 in the last)."""
    n = pos.shape[0]
    boxes = box.reshape(1, 3).contiguous()
    cols = brute_cols(pos[None], boxes)
    starts = torch.zeros(-(-n // row_tile), dtype=torch.int32, device=pos.device)
    q, _, hist = qtet2.q_window_hist(cols, cols, starts, boxes, n, row_tile, low_cut * low_cut,
                                     high_cut * high_cut, high_cut * high_cut)
    return q[0], hist


def order_param_q_dense_frames(pos: torch.Tensor, boxes: torch.Tensor, low_cut: float = 0.0,
                               high_cut: float = 10.0, row_tile: int = 128):
    """Whole-trajectory dense q in one launch, per-frame boxes.

    pos: (F, N, 3) f32; boxes: (F, 3) f32. Returns (q (F, N), hist (500,)
    int64 from `masked_histogram` over [0, 1])."""
    q = qtet2.order_param_q_frames(pos, boxes, low_cut, high_cut, row_tile=row_tile)
    hist = histograms.masked_histogram(q, torch.ones_like(q, dtype=torch.bool), qtet2.Q_BINS,
                                       0.0, 1.0)
    return q, hist
