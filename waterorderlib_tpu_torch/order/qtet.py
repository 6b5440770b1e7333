"""Errington-Debenedetti tetrahedral order parameter q (port of
waterorderlib_tpu.order.qtet), plain PyTorch.

Padding semantics match the reference: with c neighbors inside the
(low, high] shell, the 6 angle slots hold the C(min(c,4),2) real angles among
the min(c,4) nearest neighbors, padded to 6 with 180-degree angles
(cos = -1); centers with c = 0 get q = 0.

Pair cosines are elementwise products summed over xyz, never a matrix
product, so no TF32 path can lower their precision on the card.
"""

from __future__ import annotations

import math

import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.ops import pairs

# the 6 neighbor pairs (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


def _q_from_vectors(rel: torch.Tensor, ok4: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """q from (B, 4, 3) neighbor displacements, (B, 4) slot validity and
    (B,) shell counts."""
    norm = torch.linalg.vector_norm(rel, dim=-1)
    unit = rel / torch.where(norm > 0, norm, torch.ones_like(norm))[..., None]
    ui, uj = unit[..., _PAIR_I, :], unit[..., _PAIR_J, :]
    cos_pairs = (ui * uj).sum(dim=-1)  # (B, 6)
    pair_ok = ok4[..., _PAIR_I] & ok4[..., _PAIR_J]
    cos_pairs = torch.where(pair_ok, cos_pairs, torch.full_like(cos_pairs, -1.0))
    q = 1.0 - (3.0 / 8.0) * ((cos_pairs + 1.0 / 3.0) ** 2).sum(dim=-1)
    return torch.where(count > 0, q, torch.zeros_like(q))


def q_from_neighbors(
    sub: torch.Tensor, neigh: pairs.NeighborList, pos: torch.Tensor, box: torch.Tensor
) -> torch.Tensor:
    """q per center given a (Ns, >=4) NeighborList (ascending distance)."""
    idx4 = neigh.idx[..., :4].long()
    rel = pbc.minimum_image(pos[idx4] - sub[..., None, :], box)  # (Ns, 4, 3)
    return _q_from_vectors(rel, neigh.valid[..., :4], neigh.count)


def order_param_q_fused(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> torch.Tensor:
    """q by iterative 4-minimum extraction per row block: the row minimum of
    the masked distance block is located (lowest column among equals), its
    displacement taken, and the slot masked out, four times."""
    n = pos.shape[0]
    blocks, ns = pairs._blocks(sub, row_block)
    out = []
    for rows in blocks:
        disp = pbc.minimum_image(pos[None, :, :] - rows[:, None, :], box)  # (B, N, 3)
        dsq = (disp * disp).sum(dim=-1)
        valid = pairs._shell_mask_sq(dsq, low_cut, high_cut)
        count = valid.sum(dim=-1)
        d = torch.where(valid, dsq, torch.full_like(dsq, math.inf))
        col = torch.arange(n, device=d.device).expand_as(d)
        vecs, oks = [], []
        for _ in range(4):
            m = d.min(dim=1, keepdim=True).values
            eq = (d == m) & torch.isfinite(d)
            fc = torch.where(eq, col, torch.full_like(col, n)).min(dim=1, keepdim=True).values
            first = eq & (col == fc)
            vecs.append(disp.gather(1, fc.clamp(max=n - 1)[..., None].expand(-1, 1, 3))[:, 0])
            oks.append(first.any(dim=1))
            d = torch.where(first, torch.full_like(d, math.inf), d)
        out.append(_q_from_vectors(torch.stack(vecs, 1), torch.stack(oks, 1), count))
    return torch.cat(out)[:ns]


def order_param_q(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> torch.Tensor:
    """q for each row of `sub` against candidate positions `pos`; returns
    (Ns,) values in [-3, 1] (1 = perfect tetrahedron)."""
    neigh = pairs.topk_neighbors(
        sub, pos, box, k=4, low_cut=low_cut, high_cut=high_cut, row_block=row_block
    )
    return q_from_neighbors(sub, neigh, pos, box)
