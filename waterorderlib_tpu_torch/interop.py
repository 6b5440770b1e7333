"""Carry state from the JAX package into the port.

This system has no weights: its state is the trajectory and the slab prep.
The port's `io` is a copy of the JAX package's, so a system built or loaded
by either holds the same arrays (pass them as numpy); `slab_prep_from_jax`
turns the JAX package's slab prep arrays (of one window spec or several)
into the port's `SlabPrep`, so the port's kernel contracts can be fed the
JAX prep and kernel parity checked apart from prep parity, and
`coords_from_jax` carries a coordinate array such as LSI's raw layout;
`neighbor_list_from_jax` carries a fixed-K neighbor list, so the port's
occlusion kernel can be fed the JAX package's occluder slots;
`voronoi_candidates_from_jax` carries a Voronoi tier's candidate payload,
so the port's clip builder and host close can be fed the JAX package's
candidates apart from its search; `voronoi_cells_inputs_from_jax` carries
the fused cell kernel's inputs, so the port's kernel can be fed those of
`voronoi_cells_pallas`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from waterorderlib_tpu_torch.ops.cuda.slab import SlabPrep
from waterorderlib_tpu_torch.ops.pairs import NeighborList


def slab_prep_from_jax(ext_t, starts_div128, covered, order0, ws, n_tiles, device) -> SlabPrep:
    """The port's SlabPrep from the JAX package's, given as numpy arrays:
    starts_div128, covered and ws hold one entry per window spec (the JAX
    `slab_prep_traj`'s single spec passed as 1-tuples).

    The JAX prep stores window starts divided by 128 (the TPU's lane
    alignment); the port stores them in columns.
    """
    # torch.tensor copies: arrays handed over from jax are read-only
    return SlabPrep(
        ext_t=coords_from_jax(ext_t, device),
        starts=tuple(torch.tensor((np.asarray(s, np.int64) * 128).astype(np.int32), device=device)
                     for s in starts_div128),
        covered=tuple(torch.tensor(np.asarray(c, bool), device=device) for c in covered),
        order0=torch.tensor(np.asarray(order0, np.int64), device=device),
        ws=tuple(int(w) for w in ws),
        n_tiles=int(n_tiles),
    )


def coords_from_jax(arr, device) -> torch.Tensor:
    """A float32 coordinate array (e.g. (F, 3, n_ext) ext_t or raw_t) as a
    tensor of its own (a copy: arrays handed over from jax are read-only)."""
    return torch.tensor(np.ascontiguousarray(arr, np.float32), device=device)


def neighbor_list_from_jax(nl, device) -> NeighborList:
    """The port's NeighborList from the JAX package's `pairs.NeighborList`
    (dist, idx, valid, count), each field copied as a tensor of the port's
    dtype: float32 distances, int32 indices and counts, bool flags."""
    return NeighborList(
        dist=torch.tensor(np.asarray(nl.dist, np.float32), device=device),
        idx=torch.tensor(np.asarray(nl.idx, np.int32), device=device),
        valid=torch.tensor(np.asarray(nl.valid, bool), device=device),
        count=torch.tensor(np.asarray(nl.count, np.int32), device=device),
    )


class VoronoiCandidates(NamedTuple):
    """A Voronoi search's payload per center row: rel_all (R, K, 3) the
    candidates relative to the center (nearest first), valid (R, K) bool,
    nbr_idx (R, K) int32 ids in the full mirrored set, nbr_dist (R, K)."""

    rel_all: torch.Tensor
    valid: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_dist: torch.Tensor


def voronoi_candidates_from_jax(rel_all, valid, nbr_idx, nbr_dist, device) -> VoronoiCandidates:
    """The port's tensors for a JAX Voronoi tier's candidate payload, given
    as numpy arrays (`rel_all` as `_cells_blocked` forms it, ext[nbr_idx]
    - center, and the tier's nbr_valid, nbr_idx, nbr_dist). rel_all and
    nbr_dist keep their dtype (float32 or float64), so a float64 payload
    feeds the float64 builder; ids are int32, flags bool."""
    rel = np.ascontiguousarray(rel_all)
    fdtype = torch.float64 if rel.dtype == np.float64 else torch.float32
    return VoronoiCandidates(
        rel_all=torch.tensor(rel, dtype=fdtype, device=device),
        valid=torch.tensor(np.asarray(valid, bool), device=device),
        nbr_idx=torch.tensor(np.asarray(nbr_idx, np.int32), device=device),
        nbr_dist=torch.tensor(np.asarray(nbr_dist), dtype=fdtype, device=device),
    )


def voronoi_cells_inputs_from_jax(rel_parked, valid, is_boundary, device):
    """The port's `ops.cuda.voronoi_cells.voronoi_cells_fused` inputs for
    those of the JAX `voronoi_cells_pallas`, given as numpy arrays:
    (rel_parked (R, ks, 3) in its dtype, contiguous; valid (R, ks) bool;
    is_boundary (R,) bool)."""
    rel = np.ascontiguousarray(rel_parked)
    fdtype = torch.float64 if rel.dtype == np.float64 else torch.float32
    return (torch.tensor(rel, dtype=fdtype, device=device),
            torch.tensor(np.asarray(valid, bool), device=device),
            torch.tensor(np.asarray(is_boundary, bool), device=device))
