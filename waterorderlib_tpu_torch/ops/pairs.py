"""Blocked all-pairs minimum-image neighbor engine (the neighbor half of
waterorderlib_tpu.ops.pairs).

Rows are processed in blocks of `row_block`, so peak memory is
O(row_block * N). Shells follow the reference's (lowCut, highCut]
convention: squared distance strictly above lowCut^2 and at most highCut^2.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32

DEFAULT_ROW_BLOCK = 512


class NeighborList(NamedTuple):
    """Padded fixed-K neighbor list.

    dist:  (Ns, K) minimum-image distances, +inf where invalid.
    idx:   (Ns, K) indices into the `pos` array, 0 where invalid.
    valid: (Ns, K) True where the slot holds a real neighbor.
    count: (Ns,)   total neighbors within the cutoff shell (may be > K).
    """

    dist: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def _pad_rows(sub: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    """Pad the row axis up to a multiple of `block`; returns (padded, n_valid)."""
    ns = sub.shape[0]
    pad = (-ns) % block
    if pad:
        sub = torch.cat([sub, sub.new_zeros((pad,) + tuple(sub.shape[1:]))], dim=0)
    return sub, ns


def _block_rows(sub: torch.Tensor, block: int) -> torch.Tensor:
    return sub.reshape((-1, block) + tuple(sub.shape[1:]))


def pair_dist_sq(sub: torch.Tensor, pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Full squared minimum-image distance matrix (Ns, N)."""
    disp = pbc.minimum_image(sub[..., :, None, :] - pos[..., None, :, :], box)
    return torch.sum(disp * disp, dim=-1)


def _shell_mask_sq(dsq: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """(lowCut, highCut] shell on squared distances."""
    return (dsq > low * low) & (dsq <= high * high)


def neighbor_mask(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
) -> torch.Tensor:
    """Boolean (Ns, N) neighbor matrix. With low_cut=0 the self-pair
    (distance 0) is excluded."""
    return _shell_mask_sq(pair_dist_sq(sub, pos, box), low_cut, high_cut)


def signed_sq_metric(sub: torch.Tensor, pos: torch.Tensor, box: torch.Tensor,
                     high_cut) -> torch.Tensor:
    """distSq - highCut^2 metric matrix (Ns, N), a signed-distance field
    for isosurfaces (`nearNeighbors3`, waterlib.f90:796-826). high_cut:
    scalar or (N,)."""
    hc = torch.as_tensor(high_cut, dtype=sub.dtype, device=sub.device)
    return pair_dist_sq(sub, pos, box) - hc * hc


def _blocks(sub: torch.Tensor, row_block: int):
    block = min(row_block, max(1, sub.shape[0]))
    padded, ns = _pad_rows(sub, block)
    return _block_rows(padded, block), ns


def topk_neighbors(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    k: int,
    low_cut: float = 0.0,
    high_cut: float = math.inf,
    row_block: int = DEFAULT_ROW_BLOCK,
) -> NeighborList:
    """K nearest neighbors of each row of `sub` among `pos`, within the
    (low_cut, high_cut] shell. Equal distances keep the lower index first,
    as `lax.top_k` does: a stable ascending sort, then the first K."""
    high = 3.0e18 if math.isinf(high_cut) else high_cut
    blocks, ns = _blocks(sub, row_block)
    outs = []
    for blk in blocks:
        dsq = pair_dist_sq(blk, pos, box)
        valid = _shell_mask_sq(dsq, low_cut, high)
        count = valid.sum(dim=-1, dtype=torch.int32)
        masked = torch.where(valid, dsq, torch.full_like(dsq, math.inf))
        top_dsq, idx = torch.sort(masked, dim=-1, stable=True)
        top_dsq, idx = top_dsq[:, :k], idx[:, :k]
        if top_dsq.shape[1] < k:  # fewer candidates than requested slots
            pad = k - top_dsq.shape[1]
            top_dsq = torch.nn.functional.pad(top_dsq, (0, pad), value=math.inf)
            idx = torch.nn.functional.pad(idx, (0, pad))
        slot_ok = torch.isfinite(top_dsq)
        dist = sqrt_f32(top_dsq)  # correctly rounded, as XLA's and the card's sqrt
        idx = torch.where(slot_ok, idx, torch.zeros_like(idx)).to(torch.int32)
        outs.append((dist, idx, slot_ok, count))
    return NeighborList(*(torch.cat(parts)[:ns] for parts in zip(*outs)))


def neighbor_counts(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    row_block: int = DEFAULT_ROW_BLOCK,
) -> torch.Tensor:
    """Per-row count of neighbors in the (low, high] shell, blocked over rows."""
    blocks, ns = _blocks(sub, row_block)
    counts = [
        _shell_mask_sq(pair_dist_sq(blk, pos, box), low_cut, high_cut).sum(
            dim=-1, dtype=torch.int32
        )
        for blk in blocks
    ]
    return torch.cat(counts)[:ns]
