"""Periodic-boundary-condition primitives (port of waterorderlib_tpu.core.pbc).

Boxes are orthorhombic, a length-3 tensor of edge lengths; a non-positive
component disables wrapping along that axis. Every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch


def inverse_box(box: torch.Tensor) -> torch.Tensor:
    """1/box with zeros where the box edge is non-positive (no wrapping)."""
    pos_edge = box > 0
    safe = torch.where(pos_edge, box, torch.ones_like(box))
    return torch.where(pos_edge, 1.0 / safe, torch.zeros_like(box))


def minimum_image(disp: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """`disp - box * round(disp / box)`; `torch.round` rounds half to even,
    like `jnp.round`."""
    return disp - box * torch.round(disp * inverse_box(box))


def displacement(a: torch.Tensor, b: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement b - a, shapes broadcast over (..., 3)."""
    return minimum_image(b - a, box)


def distance_sq(a: torch.Tensor, b: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Squared minimum-image distance between broadcast position arrays."""
    d = displacement(a, b, box)
    return torch.sum(d * d, dim=-1)


def wrap_into_box(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Wrap positions into [0, box) along each periodic axis."""
    wrapped = pos - box * torch.floor(pos * inverse_box(box))
    return torch.where(box > 0, wrapped, pos)
