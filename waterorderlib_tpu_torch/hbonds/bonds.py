"""Hydrogen-bond detection, the arccos form (port of
waterorderlib_tpu.hbonds.bonds), plain PyTorch.

Criteria (acceptor i, donor j with matching hydrogen j), as the reference's
`generalHbonds` (waterlib.f90:1136-1210):
  - minimum-image heavy-heavy squared distance <= distCut^2 and > 0.01
    (drops self pairs);
  - the D-H...A angle at the hydrogen, between the normalized imaged H->A
    and H->D vectors, >= angCut degrees (180 = linear).

Donor heavy atoms appear once per attached hydrogen. The float32 operations
follow the JAX package's XLA path: sums over xyz as XLA's fma chain
(`core.fp32.xla_dot3`), correctly rounded roots, `torch.acos`. This is the
plain reference the counting kernels (ops/cuda/hbond.py) are checked
against, and the matrix that `get_hb_cluster_stats` needs.
"""

from __future__ import annotations

import math

import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32, xla_dot3

PAIR_BUDGET = 1 << 22  # (frame, acceptor, donor) triples per block


def _unit(v):
    return v / torch.clamp(sqrt_f32(xla_dot3(v, v)), min=1e-12)[..., None]


def _matrix(acc, don, donh, box, dist_cut, ang_cut):
    """One block: acc (..., r, 3), don/donh (..., Nd, 3), box (..., 3)."""
    b = box[..., None, None, :]
    dv = pbc.minimum_image(don[..., None, :, :] - acc[..., :, None, :], b)
    dsq = xla_dot3(dv, dv)
    within = (dsq <= dist_cut * dist_cut) & (dsq > 1.0e-2)
    acc_vec = _unit(pbc.minimum_image(acc[..., :, None, :] - donh[..., None, :, :], b))
    don_vec = _unit(pbc.minimum_image(don - donh, box[..., None, :]))
    cos_ang = xla_dot3(acc_vec, don_vec[..., None, :, :])
    ang = torch.acos(torch.clamp(cos_ang, -1.0, 1.0)) * (180.0 / math.pi)
    return within & (ang >= ang_cut)


def _row_blocks(acc, don):
    """Row-block size of acc (..., Na, 3) against don (..., Nd, 3) under
    PAIR_BUDGET."""
    per_row = max(1, math.prod(acc.shape[:-2]) * don.shape[-2])
    return max(1, PAIR_BUDGET // per_row)


def general_hbonds(
    acceptor_pos: torch.Tensor,
    donor_pos: torch.Tensor,
    donor_h_pos: torch.Tensor,
    box: torch.Tensor,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
) -> torch.Tensor:
    """Boolean (..., Nacc, Ndon) H-bond matrix (not symmetric). Leading
    dimensions (frames) broadcast; acceptor rows go in blocks of at most
    PAIR_BUDGET pairs, so the (r, Nd, 3) intermediates stay bounded."""
    rb = _row_blocks(acceptor_pos, donor_pos)
    na = acceptor_pos.shape[-2]
    return torch.cat(
        [_matrix(acceptor_pos[..., r0 : r0 + rb, :], donor_pos, donor_h_pos, box, dist_cut,
                 ang_cut) for r0 in range(0, na, rb)]
        or [torch.zeros(acceptor_pos.shape[:-1] + donor_pos.shape[-2:-1], dtype=torch.bool,
                        device=acceptor_pos.device)],
        dim=-2,
    )


def general_hbond_counts(acceptor_pos, donor_pos, donor_h_pos, box, dist_cut=3.5, ang_cut=120.0):
    """(acc counts (..., Na), donor counts (..., Nd)) int32: the row and
    column sums of `general_hbonds`, block by block (the matrix is never
    whole). The arccos form of `ops.cuda.hbond.hbond_counts`."""
    rb = _row_blocks(acceptor_pos, donor_pos)
    na = acceptor_pos.shape[-2]
    acc_parts = []
    don_cnt = torch.zeros(donor_pos.shape[:-1], dtype=torch.int32, device=donor_pos.device)
    for r0 in range(0, na, rb):
        m = _matrix(acceptor_pos[..., r0 : r0 + rb, :], donor_pos, donor_h_pos, box, dist_cut,
                    ang_cut)
        acc_parts.append(m.sum(dim=-1, dtype=torch.int32))
        don_cnt += m.sum(dim=-2, dtype=torch.int32)
    acc_cnt = (torch.cat(acc_parts, dim=-1) if acc_parts else
               torch.zeros(acceptor_pos.shape[:-1], dtype=torch.int32, device=acceptor_pos.device))
    return acc_cnt, don_cnt


def hbond_counts_and_midpoints(acceptor_pos, donor_pos, donor_h_pos, box, dist_cut=3.5,
                               ang_cut=120.0):
    """(n_bonds, bond_matrix, midpoints) like `HBondsGeneral` (wp:681-719):
    midpoints (Na, Nd, 3) are the imaged acceptor-donor midpoints of every
    pair (consumers mask them by the bond matrix)."""
    mat = general_hbonds(acceptor_pos, donor_pos, donor_h_pos, box, dist_cut, ang_cut)
    dv = pbc.minimum_image(donor_pos[..., None, :, :] - acceptor_pos[..., :, None, :],
                           box[..., None, None, :])
    mid = acceptor_pos[..., :, None, :] + 0.5 * dv
    return mat.sum(), mat, mid


def per_molecule_counts(bond_matrix, acc_mol, don_mol, n_mol: int):
    """Fold an atom-level (Na, Nd) bond matrix to per-molecule H-bond counts
    (as acceptor + as donor): (n_mol,) float32. acc_mol/don_mol map rows
    and columns to molecule ids (hbCalc's folds, orderParam_lib.py:850-860)."""
    dev = bond_matrix.device
    acc = torch.zeros(n_mol, dtype=torch.float32, device=dev).index_add_(
        0, acc_mol.long(), bond_matrix.sum(dim=1).to(torch.float32))
    don = torch.zeros(n_mol, dtype=torch.float32, device=dev).index_add_(
        0, don_mol.long(), bond_matrix.sum(dim=0).to(torch.float32))
    return acc + don
