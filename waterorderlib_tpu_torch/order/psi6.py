"""Hexagonal order parameter psi_6 (port of waterorderlib_tpu.order.psi6),
plain PyTorch.

For each center, psi = | mean over neighbor pairs of exp(6i * theta) | where
theta is the 3-body angle between every pair of its K nearest shell
neighbors, with the center at the vertex; centers with < 2 neighbors get
psi = 0. This is the independent plain path that the kernel path
(ops/cuda/psi6.py) is checked against.
"""

from __future__ import annotations

import torch

from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.order.angles import neighbor_angles


def order_param_psi(
    sub: torch.Tensor,
    pos: torch.Tensor,
    box: torch.Tensor,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    k: int = 16,
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
) -> torch.Tensor:
    """(Ns,) psi_6 of each row of `sub` against candidate positions `pos`."""
    angset = neighbor_angles(
        sub, pos, box, low_cut=low_cut, high_cut=high_cut, k=k, row_block=row_block
    )
    theta = torch.deg2rad(angset.ang) * 6.0
    ok = angset.valid
    denom = torch.clamp(ok.sum(dim=(-1, -2)), min=1)
    re = torch.where(ok, torch.cos(theta), 0.0).sum(dim=(-1, -2)) / denom
    im = torch.where(ok, torch.sin(theta), 0.0).sum(dim=(-1, -2)) / denom
    psi = torch.sqrt(re * re + im * im)
    return torch.where(angset.count > 1, psi, 0.0)
