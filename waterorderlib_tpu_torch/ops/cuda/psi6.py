"""psi6 over z-slab windows: the CUDA kernel's wrapper, its plain PyTorch
version, and the certified host dispatch (port of
waterorderlib_tpu.ops.pallas.psi6_kernel).

Per center: the full shell count over (low, high] and the K = 24 nearest
shell neighbors in lowest-column order; psi = |mean exp(6 i theta)| over
every pair of them, with cos 6t = T6(c) = 32c^6 - 48c^4 + 18c^2 - 1 and
sin 6t = sqrt(1 - c^2) U5(c) for c = cos t (no transcendental), and
psi = 0 when the shell holds fewer than 2 neighbors.

`psi6_window` launches the kernel (csrc/nbr_window.cu) on a CUDA tensor and
calls `psi6_window_plain` on a CPU tensor; any other device raises. There
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import math

import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import window

K = 24


@clock.kernel
def psi6_window(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq):
    """psi6 of R rows against one column window per row tile (the contract
    of ops/cuda/window.py). low_sq, high_sq: squared shell bounds.

    Returns (psi (F, R) f32, count (F, R) int32 full shell counts). An
    out-of-range window start gives psi = NaN, count = 0.
    """
    window.check(rows, cols, starts, boxes, w, row_tile)
    if window.runs_plain(rows, "psi6_window"):
        return psi6_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq)
    F, _, n_rows = rows.shape
    psi = torch.empty((F, n_rows), dtype=torch.float32, device=rows.device)
    count = torch.empty((F, n_rows), dtype=torch.int32, device=rows.device)
    window.launch("nbr_window", "psi6_window_launch", rows, cols, starts, boxes, w, row_tile,
                  (low_sq, high_sq), (psi, count))
    clock.count("launches:psi6_window")
    return psi, count


@clock.plain
def psi6_window_plain(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq):
    """Plain PyTorch version of `psi6_window`, same contract and slot order
    (24 rounds of lowest-column minimum extraction); the pairs (a, b) are
    summed over a < b for each b = 1..K-1, as the kernel sums them."""
    window.check(rows, cols, starts, boxes, w, row_tile)
    F, _, n_rows = rows.shape
    psi = torch.empty((F, n_rows), dtype=torch.float32, device=rows.device)
    count = torch.empty((F, n_rows), dtype=torch.int32, device=rows.device)
    tiles = window.topk_tiles(rows, cols, starts, boxes, w, row_tile, low_sq, high_sq, K, fused=True)
    for r0, r1, top in tiles:
        if top is None:  # a window outside the columns
            psi[:, r0:r1], count[:, r0:r1] = math.nan, 0
            continue
        re = torch.zeros_like(top.dsq[..., 0])
        im = torch.zeros_like(re)
        npair = torch.zeros_like(re)
        for b in range(1, K):
            c = window.dot3(top.ux[..., :b], top.ux[..., b : b + 1], top.uy[..., :b],
                            top.uy[..., b : b + 1], top.uz[..., :b], top.uz[..., b : b + 1],
                            fused=True).clamp(-1.0, 1.0)                      # (F, r, b)
            c2 = c * c
            cos6 = ((32.0 * c2 - 48.0) * c2 + 18.0) * c2 - 1.0
            sin6 = sqrt_f32(torch.clamp(1.0 - c2, min=0.0)) * (((32.0 * c2 - 32.0) * c2 + 6.0) * c)
            pair_ok = top.ok[..., b : b + 1] & top.ok[..., :b]
            re = re + torch.where(pair_ok, cos6, 0.0).sum(dim=-1)
            im = im + torch.where(pair_ok, sin6, 0.0).sum(dim=-1)
            npair = npair + pair_ok.sum(dim=-1)
        denom = torch.clamp(npair, min=1.0)
        mr, mi = re / denom, im / denom
        psi[:, r0:r1] = torch.where(top.count > 1, sqrt_f32(mr * mr + mi * mi), 0.0)
        count[:, r0:r1] = top.count.to(torch.int32)
    return psi, count


# `last_tier`: which tier served the most recent psi6_certified call, "slab"
# | "brute"
__getattr__ = clock.tier_attr("psi6_certified", __name__)


@clock.traced("dispatch:psi6_certified", device=True)
def psi6_certified(pos, boxes, low_cut=0.0, high_cut=7.0, row_tile=128):
    """psi6 with certified exactness (`window.certified`): the slab form at
    margin = high_cut, else the brute form of the same kernel.
    pos: (F, N, 3) f32; boxes: (F, 3) f32.
    Returns (psi (F, N), count (F, N) int32) in the original atom order.
    """
    out, tier = window.certified(psi6_window, pos, boxes, high_cut, row_tile,
                                 low_cut * low_cut, high_cut * high_cut)
    clock.serve_tier("psi6_certified", tier)
    return out
