"""Local structure index (LSI) of Shiratani & Sasai (port of
waterorderlib_tpu.order.lsi), plain PyTorch.

Per center: every neighbor in the (low, high] shell plus the single next
neighbor beyond `high` (searched in (high, high+3.7]), their minimum-image
distances sorted, and the population variance of the consecutive gaps. One
top-k sweep over (low, high+3.7] serves both shells: the in-shell members
are the ascending-distance prefix with dist <= high, and the next neighbor
is picked among the remaining candidates.

The reference's quirks, kept as the JAX package keeps them:
- the next neighbor is the argmin of the *raw* (stored, not imaged)
  distance among the k nearest candidates beyond `high`, while its
  minimum-image distance enters the gaps;
- a center needs >= 2 in-shell neighbors and >= 1 next-shell candidate,
  else it has no LSI (valid False, lsi 0, count 0).

This is the independent plain path that the kernel path (ops/cuda/lsi.py)
is checked against.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from waterorderlib_tpu_torch.core.fp32 import fma_f32, sqrt_f32
from waterorderlib_tpu_torch.ops import pairs


class LSIResult(NamedTuple):
    lsi: torch.Tensor    # (Ns,) LSI values in A^2 (0 where invalid)
    valid: torch.Tensor  # (Ns,) centers with a defined LSI
    count: torch.Tensor  # (Ns,) int32 in-shell neighbor count (= number of gaps), 0 where invalid


def lsi(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 3.7,
    k: int = 24,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> LSIResult:
    """LSI of each row of `sub` (stored coordinates) against `pos`."""
    cand = pairs.topk_neighbors(sub, pos, box, k, low_cut, high_cut + 3.7, row_block)
    near = cand.valid & (cand.dist <= high_cut)  # the ascending-distance prefix
    n_near = near.sum(dim=-1, dtype=torch.int32)
    nxt = cand.valid & (cand.dist > high_cut)
    has_next = nxt.any(dim=-1)

    # the raw distance of the stored positions, |x|^2 as x*x, fma(y, y, .),
    # fma(z, z, .) (the JAX package's norm on XLA's CPU backend)
    rel = pos[cand.idx.long()] - sub[:, None, :]
    rsq = fma_f32(rel[..., 2], rel[..., 2], fma_f32(rel[..., 1], rel[..., 1], rel[..., 0] * rel[..., 0]))
    raw_d = torch.where(nxt, sqrt_f32(rsq), math.inf)
    pick = torch.argmin(raw_d, dim=-1)  # the first of equal minima
    next_dist = cand.dist.gather(1, pick[:, None])[:, 0]

    d = cand.dist  # ascending, +inf padded
    gaps = d[:, 1:] - d[:, :-1]
    inner_ok = torch.arange(k - 1, device=d.device)[None, :] < (n_near - 1)[:, None]
    last_near = d.gather(1, torch.clamp(n_near - 1, min=0).long()[:, None])[:, 0]
    final_gap = next_dist - last_near
    denom = torch.clamp(n_near, min=1).to(torch.float32)
    sum_gaps = torch.where(inner_ok, gaps, 0.0).sum(dim=-1) + final_gap
    mean = sum_gaps / denom
    var = (torch.where(inner_ok, (gaps - mean[:, None]) ** 2, 0.0).sum(dim=-1)
           + (final_gap - mean) ** 2) / denom
    ok = (n_near > 1) & has_next
    return LSIResult(torch.where(ok, var, 0.0), ok, torch.where(ok, n_near, 0))
