"""Plain PyTorch reference of the local structure index (LSI), written from
the definition (water_properties.py:252-311 of the original library): for
each center, the neighbors in (low, high] and the next shell in (high,
high + 3.7] under the minimum image; with at least two neighbors and a next
shell, the next-shell atom nearest in raw (stored, not wrapped) distance
joins the neighbors; the LSI is the population variance of the gaps
between their sorted minimum-image distances.

It imports nothing of the program. `precision` is "float64" (the reference)
or "tf32" (the control: coordinates and displacements rounded to TF32)."""

from __future__ import annotations

import torch

from bench_torch.core.compare import at_precision, rounded
from bench_torch.reference.q import min_image

NEXT_SHELL = 3.7
MAX_NEAR = 24  # more neighbors than this within `high` is refused, not truncated


def lsi_frame(x, box, low: float, high: float, precision: str = "float64",
              tie_eps_sq: float = 1e-4, row_block: int = 2048):
    """x (N, 3) stored coordinates, box (3,) of one frame, already at the
    precision -> (lsi (N,), valid (N,) bool, ambiguous (N,) bool). A row is
    ambiguous where the float32 program may fairly decide otherwise: a
    squared distance within `tie_eps_sq` of low^2, high^2 or the outer
    edge's square, or two next-shell raw squared distances within it of
    the least."""
    n = x.shape[0]
    outer = high + NEXT_SHELL
    lo2, hi2, out2 = low * low, high * high, outer * outer
    lsis, valids, ambs = [], [], []
    for r0 in range(0, n, row_block):
        c = x[r0:r0 + row_block]
        raw = rounded(x[None, :, :] - c[:, None, :], precision)       # (B, N, 3)
        d = rounded(min_image(raw, box), precision)
        dsq = (d * d).sum(-1)
        near = (dsq > lo2) & (dsq <= hi2)
        nxt = (dsq > hi2) & (dsq <= out2)
        n_near = near.sum(-1)
        if int(n_near.max()) >= MAX_NEAR:
            raise ValueError(f"a center has {int(n_near.max())} neighbors within {high} A")
        raw_sq = torch.where(nxt, (raw * raw).sum(-1), torch.inf)
        two, pick = torch.topk(raw_sq, 2, dim=-1, largest=False)
        d_next = torch.sqrt(torch.gather(dsq, 1, pick[:, :1]))[:, 0]
        near_d = torch.sqrt(torch.topk(torch.where(near, dsq, torch.inf), MAX_NEAR, dim=-1,
                                       largest=False).values)        # ascending, inf after
        slot = torch.arange(MAX_NEAR, device=x.device)[None, :]
        dist = torch.where(slot < n_near[:, None], near_d, 0.0)
        dist = torch.cat([dist, torch.zeros_like(dist[:, :1])], 1)
        dist.scatter_(1, n_near[:, None], d_next[:, None])
        gaps = dist[:, 1:] - dist[:, :-1]
        g_ok = slot < n_near[:, None]
        m = g_ok.to(dist.dtype)
        cnt = m.sum(-1).clamp(min=1)
        mean = (gaps * m).sum(-1) / cnt
        var = (m * (gaps - mean[:, None]) ** 2).sum(-1) / cnt
        valid = (n_near > 1) & nxt.any(-1)
        lsis.append(torch.where(valid, var, 0.0))
        valids.append(valid)
        edge = ((dsq - hi2).abs() < tie_eps_sq) | ((dsq - out2).abs() < tie_eps_sq)
        if low > 0:
            edge |= (dsq - lo2).abs() < tie_eps_sq
        edge = edge.any(-1)
        ambs.append(edge | (two[:, 1] - two[:, 0] < tie_eps_sq))
    return torch.cat(lsis), torch.cat(valids), torch.cat(ambs)


def lsi_frames(pos, boxes, low: float, high: float, precision: str = "float64", **kw):
    """pos (F, N, 3), boxes (F, 3) -> (lsi, valid, ambiguous), each (F, N)."""
    x_all, b_all = at_precision(pos, precision), at_precision(boxes, precision)
    outs = [lsi_frame(x_all[f], b_all[f], low, high, precision, **kw)
            for f in range(x_all.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))
