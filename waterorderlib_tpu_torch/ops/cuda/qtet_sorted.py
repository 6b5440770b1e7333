"""Slab-pruned q_tet with z-sorted atoms and contiguous column windows, the
first (v1) slab form (port of waterorderlib_tpu.ops.pallas.qtet_sorted:
`order_param_q_pallas_sorted`, `order_param_q_pallas_traj` and
`suggest_window`), with its defaults.

Both run the slab form of the q kernel contract (ops/cuda/qtet2.py
`q_window`). `order_param_q_sorted` sorts every frame by z on its own
(`slab.slab_prep_frames`), so each (frame, row tile) has its own window
start: the kernel takes starts (F, n_tiles). `order_param_q_sorted_traj`
sorts frame 0 once (`slab.slab_prep_traj`, with its drift and box-change
guard) and shares one start per tile across frames.

As everywhere in the port, window starts are plain column indices (not
rounded down to 128 columns) and windows are capped at N, so `covered` can
hold where the JAX prep's fails; both are exact where they hold. q is exact
wherever `ok` (4 neighbors found, the 4th within `margin`) and `covered`.
"""

from __future__ import annotations

import torch

from waterorderlib_tpu_torch.ops.cuda import qtet2, slab


def _unsort_per_frame(arr_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(arr_sorted).scatter_(1, order, arr_sorted)


def order_param_q_sorted(pos: torch.Tensor, boxes: torch.Tensor, low_cut: float = 0.0,
                         high_cut: float = 10.0, margin: float = 4.5, row_tile: int = 128,
                         window: int = 1280, pad: int = 512, unsort: bool = True):
    """Slab-pruned q for a whole trajectory, each frame z-sorted on its own.

    pos: (F, N, 3) f32; boxes: (F, 3) orthorhombic edges. Returns (q (F, N)
    in the original atom order (z-sorted per frame when not `unsort`), ok
    (F, N) bool, covered (F,) bool): q[f, i] is exact wherever ok[f, i] and
    covered[f]."""
    n = pos.shape[1]
    prep = slab.slab_prep_frames(pos, boxes, margin, window, row_tile, pad)
    q, ok = qtet2.q_window(prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts, boxes,
                           prep.w, row_tile, low_cut * low_cut, high_cut * high_cut,
                           margin * margin)
    if not unsort:
        return q, ok, prep.covered
    return _unsort_per_frame(q, prep.order), _unsort_per_frame(ok, prep.order), prep.covered


def suggest_window(n: int, box_z: float, margin: float = 4.5, row_tile: int = 128,
                   safety: float = 1.35) -> int:
    """Window width (multiple of 128) expected to cover a tile's slab: atoms
    within (tile z-extent + 2*margin) of the tile, times a safety factor for
    density fluctuations. Check `covered` and retry larger if it fails."""
    return slab.suggest_window(n, box_z, margin=margin, row_tile=row_tile, safety=safety)


def order_param_q_sorted_traj(pos: torch.Tensor, boxes: torch.Tensor, low_cut: float = 0.0,
                              high_cut: float = 10.0, margin: float = 4.5, row_tile: int = 128,
                              window: int = 1536, pad: int = 512, unsort: bool = True):
    """Trajectory variant with a persistent frame-0 z-ordering: one sort,
    and frame-0 window starts whose margin is inflated by twice the measured
    drift (`slab.slab_prep_traj`). Returns (q (F, N), ok (F, N), covered
    (F,)), as `order_param_q_sorted`."""
    return qtet2.order_param_q_traj(pos, boxes, low_cut, high_cut, margin=margin,
                                    row_tile=row_tile, window=window, pad=pad, unsort=unsort)
