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
    """One z-sort and extended array for a trajectory, with the windows of
    one or more (margin, window) specs: `starts`, `covered` and `ws` hold
    one entry per spec, in the order given."""

    ext_t: torch.Tensor    # (F, 3, n_ext) extended transposed coordinates, f32
    starts: tuple          # per spec: (n_tiles,) int32 window starts in columns
                           # (frame-invariant: frame-0 persistent ordering)
    covered: tuple         # per spec: (F,) bool: window held every slab candidate
    order0: torch.Tensor   # (N,) frame-0 z-ordering (sorted -> original scatter)
    ws: tuple              # per spec: window width actually used
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


def slab_prep_traj(pos, boxes, specs, row_tile: int, pad: int) -> SlabPrep:
    """Frame-0 persistent z-ordering prep for a whole trajectory, for one or
    more (margin, window) specs sharing one z-sort and one extended array
    (port of the JAX package's `slab.slab_prep_traj` and
    `slab_prep_traj_multi`; the split-shell LSI kernel scans two windows of
    different widths per row tile).

    pos: (F, N, 3) f32; boxes: (F, 3) orthorhombic edges. The drift is the
    largest min-image z-drift of any atom from its frame-0 slot plus
    max_f |L_f - L_0| over the z edges: the windows are placed with frame
    0's z and L_0, while frame f's neighbors and pad copies follow L_f, so a
    box that changes between frames (NPT) moves a neighbor's periodic image
    by up to that much more. Each spec's margin is inflated by twice the
    drift, so the frame-0 window starts remain valid for every frame.
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
    drift = torch.max(torch.minimum(dz, L - dz)) + torch.max(torch.abs(L - L[0:1]))

    z_shift = torch.zeros((F, 1, 3), dtype=sp.dtype, device=sp.device)
    z_shift[:, 0, 2] = L[:, 0]
    ext = torch.cat([sp[:, n - pad :, :] - z_shift, sp, sp[:, :pad, :] + z_shift], dim=1)
    n_ext = ext.shape[1]

    ext_z0 = ext[0, :, 2].contiguous()
    tile_first = torch.arange(n_tiles, device=pos.device) * row_tile
    tile_last = torch.clamp(tile_first + row_tile - 1, max=n - 1)
    starts_all, covered_all, ws = [], [], []
    for margin, window in specs:
        margin_eff = margin + 2.0 * drift
        # a window wider than N sorted atoms could hold an atom AND its
        # periodic boundary copy, double-counting that neighbor
        w = min(window, n_ext, n)
        z_lo = zs[0][tile_first] - margin_eff
        z_hi = zs[0][tile_last] + margin_eff
        starts = torch.searchsorted(ext_z0, z_lo, side="left")
        ends = torch.searchsorted(ext_z0, z_hi, side="right")
        starts = torch.clamp(starts, 0, n_ext - w)
        # the pad slabs must be at least margin_eff deep in z, or
        # cross-boundary candidates fall outside ext while the windows look
        # covered
        pad_ok = (ext_z0[0] <= z_lo[0]) & (ext_z0[-1] >= z_hi[-1])
        covered_all.append((torch.all(ends - starts <= w) & pad_ok).expand(F))
        starts_all.append(starts.to(torch.int32))
        ws.append(w)

    ext_t = ext.transpose(1, 2).to(torch.float32).contiguous()
    return SlabPrep(ext_t, tuple(starts_all), tuple(covered_all), order0, tuple(ws), n_tiles)


class FramePrep(NamedTuple):
    """A z-sort and extended array per frame, with one window start per
    (frame, row tile)."""

    ext_t: torch.Tensor    # (F, 3, n_ext) extended transposed coordinates, f32
    starts: torch.Tensor   # (F, n_tiles) int32 window starts in columns
    covered: torch.Tensor  # (F,) bool: every tile's window held its slab candidates
    order: torch.Tensor    # (F, N) each frame's z-ordering (sorted -> original)
    w: int                 # window width


def slab_prep_frames(pos, boxes, margin: float, window: int, row_tile: int, pad: int) -> FramePrep:
    """Per-frame z-sort prep (the prep of the JAX package's
    `qtet_sorted.order_param_q_pallas_sorted`): each frame sorted by its
    own wrapped z, extended by +/-L copies of `pad` boundary atoms, and each
    (frame, tile) given the window that reaches `margin` below its first
    and above its last atom. `covered[f]` also checks that the pad copies
    reach that deep in frame f. pos: (F, N, 3) f32; boxes: (F, 3)."""
    F, n = pos.shape[0], pos.shape[1]
    if not 0 <= pad <= n:
        raise ValueError(f"pad={pad} must lie in [0, {n}]")
    n_tiles = -(-n // row_tile)
    wrapped = torch.remainder(pos, boxes[:, None, :])
    order = torch.argsort(wrapped[..., 2], dim=1, stable=True)
    sp = torch.take_along_dim(wrapped, order[..., None], dim=1)
    z_shift = torch.zeros((F, 1, 3), dtype=sp.dtype, device=sp.device)
    z_shift[:, 0, 2] = boxes[:, 2]
    ext = torch.cat([sp[:, n - pad :, :] - z_shift, sp, sp[:, :pad, :] + z_shift], dim=1)
    n_ext = ext.shape[1]
    w = min(window, n_ext, n)  # no window holds an atom and its pad copy
    ext_z = ext[..., 2].contiguous()
    tile_first = torch.arange(n_tiles, device=pos.device) * row_tile
    tile_last = torch.clamp(tile_first + row_tile - 1, max=n - 1)
    z_lo = sp[:, tile_first, 2].contiguous() - margin
    z_hi = sp[:, tile_last, 2].contiguous() + margin
    starts = torch.searchsorted(ext_z, z_lo, side="left")
    ends = torch.searchsorted(ext_z, z_hi, side="right")
    starts = torch.clamp(starts, 0, n_ext - w)
    pad_ok = (ext_z[:, 0] <= z_lo[:, 0]) & (ext_z[:, -1] >= z_hi[:, -1])
    covered = torch.all(ends - starts <= w, dim=1) & pad_ok
    ext_t = ext.transpose(1, 2).to(torch.float32).contiguous()
    return FramePrep(ext_t, starts.to(torch.int32).contiguous(), covered, order, w)


def raw_ext_t(pos: torch.Tensor, order0: torch.Tensor, pad: int) -> torch.Tensor:
    """(F, 3, n_ext) stored (not wrapped) coordinates in the extended
    array's column layout: permuted by `order0`, with the pad copies keeping
    the original coordinates, unshifted (the layout of the JAX package's
    `lsi_kernel.lsi_traj`). LSI's next-shell pick reads raw distances
    here."""
    n = pos.shape[1]
    raw = pos[:, order0, :]
    ext = torch.cat([raw[:, n - pad :, :], raw, raw[:, :pad, :]], dim=1)
    return ext.transpose(1, 2).to(torch.float32).contiguous()


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


def brute_raw(pos: torch.Tensor) -> torch.Tensor:
    """(F, 3, N) stored, transposed frames: the raw rows and columns of the
    brute form."""
    return pos.transpose(1, 2).to(torch.float32).contiguous()


def unsort_frames(arr_sorted: torch.Tensor, order0: torch.Tensor) -> torch.Tensor:
    """Scatter (F, N, ...) results from frame-0 z-order back to atom order."""
    out = torch.empty_like(arr_sorted)
    out[:, order0] = arr_sorted
    return out
