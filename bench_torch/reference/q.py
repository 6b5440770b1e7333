"""Plain PyTorch reference of the tetrahedral order parameter q, written
from the definition (water_properties.py:344-391 of the original library):
for each center, its neighbors in (low, high] under the minimum image, the
four nearest of them, the six angles between their displacement vectors,
q = 1 - 3/8 sum (cos + 1/3)^2; with fewer than four neighbors every angle
to a missing one is 180 degrees, and with none q = 0.

It imports nothing of the program. `precision` is "float64" (the reference)
or "tf32" (the control: coordinates and displacements rounded to TF32)."""

from __future__ import annotations

import torch

from bench_torch.core.compare import at_precision, rounded

PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def min_image(d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """d (..., 3) under the minimum image of box (..., 3), broadcast."""
    return d - box * torch.round(d / box)


def q_frames(oxy, boxes, low: float, high: float, precision: str = "float64",
             tie_eps_sq: float = 1e-4, frame_block: int = 4):
    """oxy (F, N, 3), boxes (F, 3) -> (q (F, N), ambiguous (F, N) bool),
    on oxy's device. A row is ambiguous where the float32 program may fairly
    pick another fourth neighbor: the 4th and 5th squared distances, or the
    4th and high^2, lie within `tie_eps_sq` of each other."""
    x_all = at_precision(oxy, precision)
    b_all = at_precision(boxes, precision)
    n = x_all.shape[1]
    qs, amb = [], []
    eye = torch.eye(n, dtype=torch.bool, device=x_all.device)
    for f0 in range(0, x_all.shape[0], frame_block):
        x, b = x_all[f0:f0 + frame_block], b_all[f0:f0 + frame_block]
        d = rounded(min_image(x[:, None, :, :] - x[:, :, None, :], b[:, None, None, :]),
                    precision)                      # (B, i, j, 3): j - i
        dsq = (d * d).sum(-1)
        near = (dsq > low * low) & (dsq <= high * high) & ~eye
        c = near.sum(-1)
        k = min(5, n - 1)
        vals, idx = torch.topk(torch.where(near, dsq, torch.inf), k, dim=-1, largest=False)
        vec = torch.take_along_dim(d, idx[..., :4, None].expand(*idx.shape[:-1], 4, 3), dim=2)
        ok = torch.arange(4, device=x.device) < c[..., None]
        terms = []
        for a, bb in PAIRS:
            u, v = vec[..., a, :], vec[..., bb, :]
            cos = (u * v).sum(-1) / torch.sqrt((u * u).sum(-1) * (v * v).sum(-1))
            cos = torch.where(ok[..., a] & ok[..., bb], cos.clamp(-1.0, 1.0), -1.0)
            terms.append((cos + 1.0 / 3.0) ** 2)
        q = 1.0 - 0.375 * torch.stack(terms, -1).sum(-1)
        qs.append(torch.where(c > 0, q, 0.0))
        tie = torch.zeros_like(c, dtype=torch.bool)
        if k == 5:
            tie = (c >= 5) & (vals[..., 4] - vals[..., 3] < tie_eps_sq)
        tie |= (c >= 4) & (high * high - vals[..., 3] < tie_eps_sq)
        amb.append(tie)
    return torch.cat(qs), torch.cat(amb)
