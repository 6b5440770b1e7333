"""Shared z-slab preparation for windowed pair kernels (port of
waterorderlib_tpu.ops.pallas.slab).

Sort the frame by z once (frame-0 persistent ordering for trajectories),
extend the sorted array with wrapped copies of the boundary slabs so PBC
neighbors stay contiguous, and give each row tile a contiguous column window
wide enough to hold every candidate within `margin` of the tile. Exactness
is certified, not assumed: `covered` checks that every tile's window held
all of its slab candidates at the drift-inflated margin.

Window starts are plain column indices: the TPU's 128-lane alignment of
starts has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SlabPrep(NamedTuple):
    ext_t: torch.Tensor    # (F, 3, n_ext) extended transposed coordinates, f32
    starts: torch.Tensor   # (n_tiles,) int32 window starts in columns
                           # (frame-invariant: frame-0 persistent ordering)
    covered: torch.Tensor  # (F,) bool: window held every slab candidate
    order0: torch.Tensor   # (N,) frame-0 z-ordering (sorted -> original scatter)
    w: int                 # window width actually used
    n_tiles: int


def clamp_window(window: int, n: int, seg: int) -> int:
    """Largest valid segmented scan window: a multiple of `seg` no wider
    than N (a wider scan would hold an atom AND one of its periodic pad
    copies and double-count that neighbor)."""
    w = min(-(-window // seg) * seg, (n // seg) * seg)
    if w <= 0:
        raise ValueError(
            f"n={n} is smaller than one scan segment (seg={seg}); use the "
            "monolithic kernel for systems this small"
        )
    return w


def slab_prep_traj(
    pos: torch.Tensor,
    boxes: torch.Tensor,
    margin: float,
    row_tile: int,
    window: int,
    pad: int,
) -> SlabPrep:
    """Frame-0 persistent z-ordering prep for a whole trajectory.

    pos: (F, N, 3) f32; boxes: (F, 3) orthorhombic edges. The effective
    margin is inflated by twice the measured maximum (min-image) z-drift from
    frame 0, so the frame-0 window starts remain valid for every frame.
    """
    F, n = pos.shape[0], pos.shape[1]
    n_pad_rows = -(-n // row_tile) * row_tile
    n_tiles = n_pad_rows // row_tile
    if n_pad_rows - n > pad:
        raise ValueError("row_tile remainder exceeds the boundary pad")
    L = boxes[:, 2][:, None]

    wrapped = torch.remainder(pos, boxes[:, None, :])
    order0 = torch.argsort(wrapped[0, :, 2], stable=True)  # one sort for the trajectory
    sp = wrapped[:, order0, :]
    zs = sp[..., 2]
    # min-image z-drift: an atom crossing the periodic z boundary is still
    # within its circular drift of its frame-0 slot, and the +/-L pad copies
    # realize that circular column adjacency
    dz = torch.abs(zs - zs[0:1])
    drift = torch.max(torch.minimum(dz, L - dz))
    margin_eff = margin + 2.0 * drift

    z_shift = torch.zeros((F, 1, 3), dtype=sp.dtype, device=sp.device)
    z_shift[:, 0, 2] = L[:, 0]
    ext = torch.cat([sp[:, n - pad :, :] - z_shift, sp, sp[:, :pad, :] + z_shift], dim=1)
    n_ext = ext.shape[1]
    # a window wider than N sorted atoms could hold an atom AND its periodic
    # boundary copy, double-counting that neighbor
    w = min(window, n_ext, n)

    ext_z0 = ext[0, :, 2].contiguous()
    tile_first = torch.arange(n_tiles, device=pos.device) * row_tile
    tile_last = torch.clamp(tile_first + row_tile - 1, max=n - 1)
    z_lo = zs[0][tile_first] - margin_eff
    z_hi = zs[0][tile_last] + margin_eff
    starts = torch.searchsorted(ext_z0, z_lo, side="left")
    ends = torch.searchsorted(ext_z0, z_hi, side="right")
    starts = torch.clamp(starts, 0, n_ext - w)
    # the pad slabs must be at least margin_eff deep in z, or cross-boundary
    # candidates fall outside ext while the windows look covered
    pad_ok = (ext_z0[0] <= z_lo[0]) & (ext_z0[-1] >= z_hi[-1])
    covered = (torch.all(ends - starts <= w) & pad_ok).expand(F)

    ext_t = ext.transpose(1, 2).to(torch.float32).contiguous()
    return SlabPrep(ext_t, starts.to(torch.int32), covered, order0, w, n_tiles)


def suggest_pad(n: int, box_z: float, depth: float, safety: float = 1.6) -> int:
    """Boundary-copy count (multiple of 128, capped at n) whose z extent is
    expected to exceed `depth` (the drift-inflated margin). The `covered`
    certificate still verifies sufficiency at run time."""
    est = n * depth / box_z * safety + 128
    return int(min(n, -(-est // 128) * 128))


def suggest_window(n: int, box_z: float, margin: float = 4.5, row_tile: int = 256,
                   safety: float = 1.35) -> int:
    """Window width (multiple of 128) expected to cover a tile's slab."""
    tile_extent = row_tile / n * box_z
    slab = tile_extent + 2.0 * margin
    est = n * slab / box_z * safety + 256
    return int(-(-est // 128) * 128)


def plan(n: int, box_z: float, margin: float, row_tile: int) -> tuple[int, int]:
    """(window, pad) of the certified dispatchers: the pad spans at least
    the drift-inflated margin in z (the `covered` certificate verifies it)
    and the last row tile's remainder."""
    window = suggest_window(n, box_z, margin=margin, row_tile=row_tile)
    pad = max(suggest_pad(n, box_z, margin + 2.0), min(n, -n % row_tile))
    return window, pad


def brute_cols(pos: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(F, 3, N) wrapped, transposed frames: the rows and columns of a
    kernel contract's brute form (start 0, window = N)."""
    return torch.remainder(pos, boxes[:, None, :]).transpose(1, 2).contiguous()


def unsort_frames(arr_sorted: torch.Tensor, order0: torch.Tensor) -> torch.Tensor:
    """Scatter (F, N, ...) results from frame-0 z-order back to atom order."""
    out = torch.empty_like(arr_sorted)
    out[:, order0] = arr_sorted
    return out
