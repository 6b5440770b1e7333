"""3-body pair angles over z-slab windows: the CUDA kernel's wrapper, its
plain PyTorch version, and the certified host dispatch (port of
waterorderlib_tpu.ops.pallas.angles_kernel).

Per center: the full shell count over (low, high] and the K = 16 nearest
shell neighbors in lowest-column order; then all 120 pair angles in degrees
through the A&S 4.4.46 arccos polynomial, -1 in slots that miss a neighbor
and in the 8 padding slots. Slot p holds the pair (PAIR_A[p], PAIR_B[p]); it
is valid iff PAIR_B[p] < min(count, K) (`pair_validity`).

`angles_window` launches the kernel (csrc/nbr_window.cu) on a CUDA tensor
and calls `angles_window_plain` on a CPU tensor; any other device raises.
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.fp32 import fma_f32, sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import window

K = 16
N_PAIRS = K * (K - 1) // 2  # 120
N_PAIRS_PAD = 128

# static pair enumeration: slot p -> (PAIR_A[p], PAIR_B[p]), a < b; the
# padding slots carry b = K, which no count validates
PAIR_A = np.array([a for a in range(K) for b in range(a + 1, K)], np.int32)
PAIR_B = np.array([b for a in range(K) for b in range(a + 1, K)], np.int32)
PAIR_B_PADDED = np.concatenate([PAIR_B, np.full(N_PAIRS_PAD - N_PAIRS, K, np.int32)])

# Abramowitz & Stegun 4.4.46 coefficients: |acos_poly - acos| <= 2e-8 rad
_ACOS_C = (1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
           0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911)


def pair_validity(count: torch.Tensor) -> torch.Tensor:
    """(..., 128) bool: slot p valid iff PAIR_B[p] < min(count, K)."""
    pb = torch.as_tensor(PAIR_B_PADDED, device=count.device)
    return pb < torch.clamp(count, max=K)[..., None]


def acos_poly(x: torch.Tensor) -> torch.Tensor:
    """Polynomial arccos of f32 x in [-1, 1] (radians), one operation at a
    time in the kernel's order: Horner steps as fused multiply-adds."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    ax = torch.abs(x)
    p = f32(_ACOS_C[-1]).expand_as(ax)
    for c in _ACOS_C[-2::-1]:
        p = fma_f32(p, ax, f32(c))
    r = sqrt_f32(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x >= 0, r, f32(np.pi) - r)


@clock.kernel
def angles_window(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq):
    """Pair angles of R rows against one column window per row tile (the
    contract of ops/cuda/window.py). low_sq, high_sq: squared shell bounds.

    Returns (ang (F, R, 128) f32 degrees, count (F, R) int32 full shell
    counts). An out-of-range window start gives ang = NaN, count = 0.
    """
    window.check(rows, cols, starts, boxes, w, row_tile)
    if window.runs_plain(rows, "angles_window"):
        return angles_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq)
    F, _, n_rows = rows.shape
    ang = torch.empty((F, n_rows, N_PAIRS_PAD), dtype=torch.float32, device=rows.device)
    count = torch.empty((F, n_rows), dtype=torch.int32, device=rows.device)
    window.launch("nbr_window", "angles_window_launch", rows, cols, starts, boxes, w, row_tile,
                  (low_sq, high_sq), (ang, count))
    clock.count("launches:angles_window")
    return ang, count


@clock.plain
def angles_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq):
    """Plain PyTorch version of `angles_window`, same contract and slot
    order (16 rounds of lowest-column minimum extraction)."""
    window.check(rows, cols, starts, boxes, w, row_tile)
    F, _, n_rows = rows.shape
    dev = rows.device
    ang = torch.full((F, n_rows, N_PAIRS_PAD), -1.0, dtype=torch.float32, device=dev)
    count = torch.empty((F, n_rows), dtype=torch.int32, device=dev)
    pa = torch.as_tensor(PAIR_A, dtype=torch.long, device=dev)
    pb = torch.as_tensor(PAIR_B, dtype=torch.long, device=dev)
    rad2deg = torch.tensor(180.0 / np.pi, dtype=torch.float32, device=dev)
    tiles = window.topk_tiles(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, K, fused=True)
    for r0, r1, top in tiles:
        if top is None:  # a window outside the columns
            ang[:, r0:r1], count[:, r0:r1] = math.nan, 0
            continue
        cosv = window.dot3(top.ux[..., pa], top.ux[..., pb], top.uy[..., pa], top.uy[..., pb],
                           top.uz[..., pa], top.uz[..., pb], fused=True)    # (F, r, 120)
        deg = acos_poly(cosv.clamp(-1.0, 1.0)) * rad2deg
        ang[:, r0:r1, :N_PAIRS] = torch.where(top.ok[..., pb], deg, -1.0)
        count[:, r0:r1] = top.count.to(torch.int32)
    return ang, count


# `last_tier`: which tier served the most recent
# neighbor_pair_angles_certified call, "slab" | "brute"
__getattr__ = clock.tier_attr("neighbor_pair_angles_certified", __name__)


@clock.traced("dispatch:neighbor_pair_angles_certified", device=True)
def neighbor_pair_angles_certified(pos, boxes, low_cut=0.0, high_cut=3.413, row_tile=128):
    """Pair angles with certified exactness (`window.certified`): the slab
    form at margin max(4.5, high_cut) (4.5 is the JAX package's margin
    wherever it runs its kernel), else the brute form of the same kernel.
    pos: (F, N, 3) f32; boxes: (F, 3) f32.
    Returns (ang (F, N, 128), count (F, N) int32) in the original atom order.
    """
    out, tier = window.certified(angles_window, pos, boxes, max(4.5, high_cut), row_tile,
                                 low_cut * low_cut, high_cut * high_cut)
    clock.serve_tier("neighbor_pair_angles_certified", tier)
    return out
