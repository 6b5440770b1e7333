"""Legacy geometric H-bond kernels for peptide-surface pulling analyses
(port of waterorderlib_tpu.hbonds.legacy), plain PyTorch.

Replaces the reference's self-described "legacy" `FindHbonds`
(waterlib.f90:427-512), `BBHbonds` (:517-563), `WatHbonds` (:570-679) and
their Python wrappers `PepWatHBonds`/`BBHBonds`/`WatHBonds`
(water_properties.py:77-207). These use the older acceptor-to-hydrogen
convention: |A - H| < distCut and the angle between (A - H) and the covalent
(X -> H) bond below angCut degrees.

Reproduced quirks:
- FindHbonds/BBHbonds apply *no* PBC imaging (ref comment :424-426);
  WatHbonds images each A...H vector but not the covalent bonds;
- water donor search short-circuits: if H1 of a water bonds to a given
  acceptor, H2 is not tested against that same acceptor (the Fortran
  `cycle`, :481, :622, :656).

Positions are taken as float32, as the JAX package takes them; sums over
xyz follow its XLA fma chain (`core.fp32.xla_dot3`).
"""

from __future__ import annotations

import numpy as np
import torch

from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32, xla_dot3
from waterorderlib_tpu_torch.ops.cuda.hbond import cos_cut as _cos_cut


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32)


def _cos_ah(bond_vec, cov_vec):
    """cos(angle) between A-H vector(s) and covalent bond vector(s)."""
    num = xla_dot3(bond_vec, cov_vec)
    den = sqrt_f32(xla_dot3(bond_vec, bond_vec) * xla_dot3(cov_vec, cov_vec))
    return num / torch.clamp(den, min=1e-30)


def _rows(b, dim):
    return b.sum(dim=dim, dtype=torch.int32)


def find_hbonds(pep_acc, pep_don, wat_pos, dist_cut=2.1, ang_cut=30.0):
    """waterlib.f90:427-512. wat_pos: (3 Nw, 3) as O, H1, H2 per water;
    pep_don: (2 Nd, 3) as heavy, H pairs. Returns (n_bonds, wat_acc (3Nw,),
    wat_don (3Nw,), pep_acc_out (Na,), pep_don_out (2Nd,)) per-atom H-bond
    counts (int32), as the Fortran outputs. No PBC."""
    pep_acc, pep_don, wat_pos = _f32(pep_acc), _f32(pep_don), _f32(wat_pos)
    cc = _cos_cut(ang_cut)
    d2cut = dist_cut * dist_cut
    o, h1, h2 = wat_pos[0::3], wat_pos[1::3], wat_pos[2::3]

    def don_bonds(h, vw):  # waters donate to peptide acceptors (Nw, Na)
        bv = pep_acc[None, :, :] - h[:, None, :]
        return (xla_dot3(bv, bv) < d2cut) & (_cos_ah(bv, vw[:, None, :]) > cc)

    b1 = don_bonds(h1, h1 - o)
    b2 = don_bonds(h2, h2 - o) & ~b1  # H2 skipped when H1 already bonded (cycle)

    # peptide donates to water oxygens (Nd, Nw)
    don_heavy, don_h = pep_don[0::2], pep_don[1::2]
    bv = o[None, :, :] - don_h[:, None, :]
    bp = (xla_dot3(bv, bv) < d2cut) & (_cos_ah(bv, (don_h - don_heavy)[:, None, :]) > cc)

    n_bonds = int(b1.sum() + b2.sum() + bp.sum())
    nw3 = wat_pos.shape[0]
    wat_don = torch.zeros(nw3, dtype=torch.int32)
    wat_don[1::3] = _rows(b1, 1)
    wat_don[2::3] = _rows(b2, 1)
    wat_acc = torch.zeros(nw3, dtype=torch.int32)
    wat_acc[0::3] = _rows(bp, 0)
    pep_acc_out = _rows(b1, 0) + _rows(b2, 0)
    pep_don_out = torch.zeros(pep_don.shape[0], dtype=torch.int32)
    pep_don_out[1::2] = _rows(bp, 1)
    return n_bonds, wat_acc, wat_don, pep_acc_out, pep_don_out


def bb_hbonds(pep_acc, pep_don, dist_cut=2.1, ang_cut=30.0):
    """waterlib.f90:517-563: backbone-backbone H-bonds, no PBC. Returns
    (n_bonds, acc_counts (Na,), don_counts (2Nd,)) int32."""
    pep_acc, pep_don = _f32(pep_acc), _f32(pep_don)
    cc = _cos_cut(ang_cut)
    heavy, hpos = pep_don[0::2], pep_don[1::2]
    bv = pep_acc[None, :, :] - hpos[:, None, :]  # (Nd, Na, 3)
    bonded = ((xla_dot3(bv, bv) < dist_cut * dist_cut)
              & (_cos_ah(bv, (hpos - heavy)[:, None, :]) > cc))
    don_out = torch.zeros(pep_don.shape[0], dtype=torch.int32)
    don_out[1::2] = _rows(bonded, 1)
    return int(bonded.sum()), _rows(bonded, 0), don_out


def wat_hbonds(wat_pos, all_wat_pos, box, dist_cut=2.1, ang_cut=30.0):
    """waterlib.f90:570-679: in-set waters against all waters, A...H vectors
    imaged, covalent bonds not. Returns (n_bonds, wat_acc (3Nw,), wat_don
    (3Nw,)) int32 counts over the in-set atoms."""
    wat_pos, all_wat_pos, box = _f32(wat_pos), _f32(all_wat_pos), _f32(box)
    cc = _cos_cut(ang_cut)
    d2cut = dist_cut * dist_cut
    o, h1, h2 = wat_pos[0::3], wat_pos[1::3], wat_pos[2::3]
    all_o, all_h1, all_h2 = all_wat_pos[0::3], all_wat_pos[1::3], all_wat_pos[2::3]
    n_set_mol = o.shape[0]

    def don(h):  # in-set H donating to every oxygen (Nset, NallMol)
        bv = pbc.minimum_image(all_o[None, :, :] - h[:, None, :], box)
        return (xla_dot3(bv, bv) < d2cut) & (_cos_ah(bv, (h - o)[:, None, :]) > cc)

    def acc(all_h):  # in-set oxygen accepting from every H (Nset, NallMol)
        bv = pbc.minimum_image(o[:, None, :] - all_h[None, :, :], box)
        return (xla_dot3(bv, bv) < d2cut) & (_cos_ah(bv, (all_h - all_o)[None, :, :]) > cc)

    b1 = don(h1)
    b2 = don(h2) & ~b1
    a1 = acc(all_h1)
    a2 = acc(all_h2) & ~a1

    n_bonds = int(b1.sum() + b2.sum() + a1.sum() + a2.sum())
    wat_don = torch.zeros(wat_pos.shape[0], dtype=torch.int32)
    # in-set donors, plus donor credit where an in-set water is the "all"
    # set's donating hydrogen (the first NsetMol columns are the in-set
    # waters, ref :699-703)
    wat_don[1::3] = _rows(b1, 1) + _rows(a1[:, :n_set_mol], 0)
    wat_don[2::3] = _rows(b2, 1) + _rows(a2[:, :n_set_mol], 0)
    wat_acc = torch.zeros(wat_pos.shape[0], dtype=torch.int32)
    wat_acc[0::3] = (_rows(a1, 1) + _rows(a2, 1)
                     + _rows(b1[:, :n_set_mol], 0) + _rows(b2[:, :n_set_mol], 0))
    return n_bonds, wat_acc, wat_don


def _index_string(counts, inds):
    out = []
    for j, val in enumerate(np.asarray(counts)):
        out += int(val) * [int(inds[j])]
    return "".join(str(e) + "|" for e in out)


def pep_wat_hbonds(all_pos, pep_acc_inds, pep_don_inds, wat_inds, dist_cut=2.1, ang_cut=30.0):
    """Wrapper matching PepWatHBonds (wp:77-126): returns (NBonds, bondsPer
    (per water), acceptors string, donors string)."""
    all_pos = np.asarray(all_pos)
    n, wat_acc, wat_don, pep_acc, pep_don = find_hbonds(
        all_pos[pep_acc_inds], all_pos[pep_don_inds], all_pos[wat_inds], dist_cut, ang_cut)
    bonds_wat = (wat_acc + wat_don).numpy().reshape(-1, 3).sum(axis=1).astype(float)
    acceptors = _index_string(pep_acc, pep_acc_inds) + _index_string(wat_acc, wat_inds)
    donors = _index_string(pep_don, pep_don_inds) + _index_string(wat_don, wat_inds)
    return n, bonds_wat, acceptors, donors


def bb_hbonds_wrapper(all_pos, pep_acc_inds, pep_don_inds, dist_cut=2.1, ang_cut=30.0):
    """Wrapper matching BBHBonds (wp:129-161): (NBonds, acceptors, donors)."""
    all_pos = np.asarray(all_pos)
    n, acc, don = bb_hbonds(all_pos[pep_acc_inds], all_pos[pep_don_inds], dist_cut, ang_cut)
    return n, _index_string(acc, pep_acc_inds), _index_string(don, pep_don_inds)


def wat_hbonds_wrapper(all_pos, wat_inds, all_wat_inds, box, dist_cut=2.1, ang_cut=30.0):
    """Wrapper matching WatHBonds (wp:164-207): returns (NBonds, bondsPer,
    acceptors string, donors string)."""
    all_pos = np.asarray(all_pos)
    n, wat_acc, wat_don = wat_hbonds(all_pos[wat_inds], all_pos[all_wat_inds], box,
                                     dist_cut, ang_cut)
    bonds_wat = (wat_acc + wat_don).numpy().reshape(-1, 3).sum(axis=1).astype(float)
    return n, bonds_wat, _index_string(wat_acc, wat_inds), _index_string(wat_don, wat_inds)
