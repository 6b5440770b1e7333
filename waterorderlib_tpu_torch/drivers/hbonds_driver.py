"""Hydrogen-bond trajectory drivers (port of
waterorderlib_tpu.drivers.hbonds_driver): `hb_calc` (orderParam_lib.py:
729-917), `get_bound_wrap` (:419-572) and `bound_wrap_func1`, and the
cluster statistics `get_hb_cluster_stats` (:158-237),
`get_ion_cluster_stats` (:239-311) and `get_neighbor_stats` (:313-384).

The trajectory moves to the device once, all atoms as one (F, N, 3) float32
tensor, and each acceptor x donor set is gathered there. Every H-bond count
is one launch over all frames: water-water through the certified tier
dispatch (ops/cuda/hbond.py `hbond_counts_certified`), the eight cosolvent
sets and `get_bound_wrap`'s two any-bond tests through `hbond_counts`. The
JAX package counts the cosolvent sets with the arccos matrix
`general_hbonds`; only counts are consumed, and the two criteria differ only
on the measure-zero angle boundary. The cluster statistics need the
residue adjacency, so they build the matrix (`hbonds.bonds.general_hbonds`).
Their dispatch seam is `hbonds.clusters.hb_cluster_block`, one call a frame
block from positions to cluster sizes: `get_hb_cluster_stats` ends its
`kernel stage` after each and its `stats (device)` after the block's size
distribution and means (same-named stages add up over the blocks).
Each driver writes the JAX package's text artifacts into `output_dir`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end
from waterorderlib_tpu_torch.drivers.orderparams import _not_ported, _resolve_system
from waterorderlib_tpu_torch.hbonds import clusters as clusters_mod
from waterorderlib_tpu_torch.hbonds.populations import bound_wrap_masks
from waterorderlib_tpu_torch.io.streaming import iter_chunks
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import load_topology
from waterorderlib_tpu_torch.ops import histograms, pairs
from waterorderlib_tpu_torch.ops.cuda import hbond
from waterorderlib_tpu_torch.stats import blocks

PAIR_BUDGET = 1 << 24  # (frame, row, column) entries per frame block of the matrix drivers


def _sol_hb_triplets(top, wat_res="WAT"):
    sol, sol_h, sol_c, sol_n, sol_o, sol_s = top.get_sol_inds(wat_res)
    hb_o, hb_n = top.get_hb_inds(sol_n, sol_o)
    return sol, hb_o, hb_n


def _water_triplets(top, wat_res):
    """(water oxygens, [acceptors, donors, donor hydrogens]): acceptors are
    the O's, donors each O twice, donor hydrogens its two H's."""
    wat_inds = top.get_wat_inds(wat_res)[0]
    return wat_inds, top.get_hb_inds(np.array([], int), wat_inds)[0]


def _to(positions, boxes, device):
    """Frames and boxes as float32 tensors on the device."""
    return (clock.to_device(positions, torch.float32, device),
            clock.to_device(boxes, torch.float32, device))


def _frame_blocks(n_frames, per_frame):
    fb = max(1, PAIR_BUDGET // max(1, per_frame))
    return [slice(f0, f0 + fb) for f0 in range(0, n_frames, fb)]


# ---------------------------------------------------------------------------
# hbCalc
# ---------------------------------------------------------------------------

def hb_sets(top, wat_res, device):
    """Index tensors on `device` of hb_calc's (acceptor, donor, donor-H)
    triplets: (water, solute O or None, solute N or None), the number of
    cosolvent molecules, and whether the cosolvent takes part."""
    with clock.span("topology"):
        _, wat_hb = _water_triplets(top, wat_res)
        sol_inds, hb_o, hb_n = _sol_hb_triplets(top, wat_res)
        n_sol = len(np.unique(top.res_ids[sol_inds])) if len(sol_inds) else 0
        has_sol = n_sol > 0 and (len(hb_o[0]) + len(hb_n[0])) > 0

    def idx(triplet):
        return [clock.to_device(np.asarray(a, np.int64), device=device) for a in triplet]

    return (idx(wat_hb), *((idx(hb_o), idx(hb_n)) if has_sol else (None, None))), n_sol, has_sol


def hb_totals(pos, boxes, sets, n_sol, dist_cut=3.5, ang_cut=120.0, water_counts=None,
              counts=None):
    """Per-frame H-bond totals: (per water (F, Nw), per cosolvent molecule
    (F, max(n_sol, 1))) int32. pos: (F, N, 3) all atoms; sets: `hb_sets`.
    Each of the nine acceptor x donor sets is one call over all frames:
    water-water through `water_counts` (default the certified dispatch),
    the others through `counts` (default `hbond_counts`); either may be
    `hbonds.bonds.general_hbond_counts`, the arccos form."""
    water_counts = water_counts or hbond.hbond_counts_certified
    counts = counts or hbond.hbond_counts
    F = pos.shape[0]
    (wa, wd, wdh), sol_o, sol_n = (tuple(pos[:, i] for i in s) if s else None for s in sets)
    nw = wa.shape[1]

    def per_water(v):  # donor entries (F, 2 Nw) -> per water (F, Nw)
        return v.reshape(F, nw, 2).sum(dim=-1)

    acc_cnt, don_cnt = water_counts(wa, wd, wdh, boxes, dist_cut, ang_cut)
    wat_tot = acc_cnt + per_water(don_cnt)
    if sol_o is None:
        return wat_tot, torch.zeros((F, max(n_sol, 1)), dtype=torch.int32, device=pos.device)

    def hb(a, d, dh):
        return counts(a, d, dh, boxes, dist_cut, ang_cut)

    (o_a, o_d, o_dh), (n_a, n_d, n_dh) = sol_o, sol_n
    watsol_o, solwat_o = hb(wa, o_d, o_dh), hb(o_a, wd, wdh)
    watsol_n, solwat_n = hb(wa, n_d, n_dh), hb(n_a, wd, wdh)
    sol_oo, sol_on = hb(o_a, o_d, o_dh), hb(o_a, n_d, n_dh)
    sol_no, sol_nn = hb(n_a, o_d, o_dh), hb(n_a, n_d, n_dh)
    sol_o_acc = solwat_o[0] + sol_oo[0] + sol_on[0]
    sol_o_don = watsol_o[1] + sol_oo[1] + sol_no[1]
    sol_n_acc = solwat_n[0] + sol_nn[0] + sol_no[0]
    sol_n_don = watsol_n[1] + sol_nn[1] + sol_on[1]

    def fold_mol(v):  # per-atom (F, n_sol * k) -> per molecule (F, n_sol)
        k = v.shape[1] // n_sol
        return v.reshape(F, n_sol, k).sum(dim=-1) if k else v.new_zeros((F, n_sol))

    sol_tot = fold_mol(sol_o_acc) + fold_mol(sol_o_don) + fold_mol(sol_n_acc) + fold_mol(sol_n_don)
    wat_tot = wat_tot + watsol_o[0] + per_water(solwat_o[1]) + watsol_n[0] + per_water(solwat_n[1])
    return wat_tot, sol_tot


def _hb_core(pos, boxes, sets, n_sol, dist_cut, ang_cut, n_bins):
    """`hb_totals` of one frame batch and their statistics: ((hist water,
    hist cosolvent) (n_bins,) int64, (water means, cosolvent means) (F,)
    float32)."""
    wat_tot, sol_tot = hb_totals(pos, boxes, sets, n_sol, dist_cut, ang_cut)
    stage_end("kernel stage")
    wat_tot, sol_tot = wat_tot.to(torch.float32), sol_tot.to(torch.float32)
    hists = tuple(
        histograms.masked_histogram_frames(v, torch.ones_like(v, dtype=torch.bool), n_bins, 0.0,
                                           float(n_bins)).sum(dim=0)
        for v in (wat_tot, sol_tot)
    )
    out = hists, (wat_tot.mean(dim=1), sol_tot.mean(dim=1))
    stage_end("stats (device)")
    return out


@clock.traced("call:hb_calc")
def hb_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    dist_cut: float = 3.5,
    ang_cut: float = 120.0,
    output_dir: str = ".",
    chunk_frames: int | None = None,
    mesh=None,
    device="cuda",
):
    """Average H-bonds per water and per cosolvent molecule
    (orderParam_lib.py:729-917). Writes hbDistribution_water.txt and
    hbDistribution_cosolv.txt (bins [0, 1, ..., 10]); returns (avgWatHBs,
    avgSolHBs). With no cosolvent the cosolvent histogram still counts one
    0 per frame, as the JAX package's. With `chunk_frames` the trajectory
    streams through the device in chunks (io/streaming.py). `mesh` is not
    ported yet.
    """
    _not_ported(mesh)
    dev = resolve_device(device)
    if chunk_frames is not None:
        top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
        traj = None
    else:
        top, traj = _resolve_system(top_file, traj_file, stride)
    sets, n_sol, has_sol = hb_sets(top, wat_res, dev)
    stage_end("host gather")
    n_bins = 10

    def run(positions, boxes):
        pos, boxes_t = _to(positions, boxes, dev)
        stage_end("H2D")
        (hw, hs), (wm, sm) = _hb_core(pos, boxes_t, sets, n_sol, dist_cut, ang_cut, n_bins)
        out = hw.cpu().numpy(), hs.cpu().numpy(), wm.cpu().numpy(), sm.cpu().numpy()
        stage_end("D2H")
        return out

    if chunk_frames is not None:
        parts = [run(p, b) for p, b in iter_chunks(traj_file, chunk_frames, stride,
                                                   n_atoms=top.n_atoms)]
        h_wat, h_sol = sum(p[0] for p in parts), sum(p[1] for p in parts)
        wat_means = np.concatenate([p[2] for p in parts])
        sol_means = np.concatenate([p[3] for p in parts])
    else:
        h_wat, h_sol, wat_means, sol_means = run(traj.positions, traj.boxes)
    centers = np.arange(n_bins) + 0.5
    for name, h in (("water", h_wat), ("cosolv", h_sol)):
        np.savetxt(os.path.join(output_dir, f"hbDistribution_{name}.txt"),
                   np.stack([centers, h], axis=1), header="# hbs    frequency", fmt="%.3e")
    stage_end("savetxt")
    avg_wat = float(np.mean(wat_means))
    avg_sol = float(np.mean(sol_means)) if has_sol else 0.0
    return avg_wat, avg_sol


# ---------------------------------------------------------------------------
# getBoundWrap
# ---------------------------------------------------------------------------

@clock.traced("call:get_bound_wrap")
def get_bound_wrap(
    top_file,
    traj,
    frame_index: int | None = None,
    wat_res: str = "WAT",
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
    device="cuda",
):
    """Bound/wrap/shell/non-shell water indices (orderParam_lib.py:419-572).

    With frame_index=None every frame goes through the device in one pass
    and a list of per-frame (boundInds, wrapInds, shellInds, nonShellInds)
    tuples of *global atom indices* is returned; with a frame index, that
    frame's tuple (the reference's per-frame API).
    """
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj, 1)
    with clock.span("topology"):
        wat_inds, (_, _, wat_donh) = _water_triplets(top, wat_res)
        sol_inds, (sol_acc_o, sol_don_o, sol_donh_o), _ = _sol_hb_triplets(top, wat_res)
    sel = slice(None) if frame_index is None else slice(frame_index, frame_index + 1)
    stage_end("host gather")
    pos, boxes = _to(traj.positions[sel], traj.boxes[sel], dev)
    stage_end("H2D")

    def at(inds):
        return pos[:, clock.to_device(np.asarray(inds, np.int64), device=dev)]

    bw = bound_wrap_masks(at(wat_inds), at(wat_donh), at(sol_inds), at(sol_acc_o),
                          at(sol_don_o), at(sol_donh_o), boxes, cutoff, hb_dist, hb_ang)
    stage_end("kernel stage")
    bound, wrap, shell, non_shell = (m.cpu().numpy() for m in (bw.bound, bw.wrap, bw.shell,
                                                                bw.non_shell))
    stage_end("D2H")
    out = [
        (wat_inds[bound[t]], wat_inds[wrap[t]], wat_inds[shell[t]], wat_inds[non_shell[t]])
        for t in range(bound.shape[0])
    ]
    return out[0] if frame_index is not None else out


def bound_wrap_func1(top_file, traj, frame_index: int = 0, cutoff: float = 4.6, device="cuda"):
    """One-call wrapper matching boundWrap.func1 (boundWrap.py:3-14):
    [boundInds, wrapInds, shellInds, nonShellInds] of one frame at the
    4.6 A cutoff."""
    return list(get_bound_wrap(top_file, traj, frame_index=frame_index, cutoff=cutoff,
                               device=device))


# ---------------------------------------------------------------------------
# cluster and coordination statistics
# ---------------------------------------------------------------------------

def _save_dist(output_dir, name, dist, header):
    n = len(dist)
    np.savetxt(os.path.join(output_dir, name),
               np.stack([np.arange(1, n + 1), np.asarray(dist)], axis=1), header=header, fmt="%d")


def _stats_tail(output_dir, dist, series, seed):
    """clusterDistribution.txt and [mean, CI] of each per-frame series."""
    _save_dist(output_dir, "clusterDistribution.txt", dist, "cluster size    frequency")
    stage_end("savetxt")
    out = blocks.mean_and_ci_columns(series, seed=seed)
    stage_end("bootstrap (host)")
    return out


@clock.traced("call:get_hb_cluster_stats")
def get_hb_cluster_stats(
    top_file,
    traj_file,
    acceptor_inds,
    donor_inds,
    donor_h_inds,
    stride: int = 1,
    dist_cut: float = 3.0,
    ang_cut: float = 150.0,
    output_dir: str = ".",
    seed: int | None = 0,
    device="cuda",
):
    """Residue-residue H-bond cluster statistics (orderParam_lib.py:158-237).

    Each frame block goes through one dispatch, `hbonds.clusters.
    hb_cluster_block`: the H-bond matrix, the residue adjacency (any atom
    pair bonded connects two residues: a max over repeated (residue,
    residue) entries, so two atoms of one residue bonding the same partner
    count once) and its connected components by label propagation, to
    each frame's cluster sizes. Writes the cluster-size distribution
    summed over frames (clusterDistribution.txt) and returns [mean cluster
    size, CI] over frames. Counts `hb_clusters:edges`, the residue pairs
    bonded, read with the distribution's D2H."""
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj_file, stride)
    acceptor_inds, donor_inds, donor_h_inds = (np.asarray(a, int) for a in
                                               (acceptor_inds, donor_inds, donor_h_inds))
    with clock.span("topology"):
        acc_res, don_res = top.res_ids[acceptor_inds], top.res_ids[donor_inds]
        res_ids = np.unique(np.concatenate([acc_res, don_res]))
        n_res = int(res_ids.max()) + 1 if len(res_ids) else 0
    flat = clock.to_device((acc_res[:, None].astype(np.int64) * n_res + don_res[None, :])
                           .reshape(-1), device=dev)
    inds = [clock.to_device(a, device=dev) for a in (acceptor_inds, donor_inds, donor_h_inds)]
    stage_end("host gather")
    pos, boxes = _to(traj.positions, traj.boxes, dev)
    stage_end("H2D")
    dist = torch.zeros(n_res, dtype=torch.int64, device=dev)
    edges = torch.zeros((), dtype=torch.int64, device=dev)
    means = []
    for fs in _frame_blocks(pos.shape[0], len(acceptor_inds) * len(donor_inds) + n_res * n_res):
        sizes, block_edges = clusters_mod.hb_cluster_block(pos[fs], boxes[fs], inds, flat, n_res,
                                                           dist_cut, ang_cut)
        stage_end("kernel stage")
        edges += block_edges
        means.append(clusters_mod.mean_of_sizes(sizes))
        dist += clusters_mod.size_distribution(sizes, n_res)[:, 1:].sum(dim=0)
        stage_end("stats (device)")
    counts = torch.cat([dist, edges[None]]).cpu().numpy()  # the edge count rides the D2H
    dist_np, means_np = counts[:-1], torch.cat(means).cpu().numpy()
    clock.count("hb_clusters:edges", int(counts[-1]))
    stage_end("D2H")
    return _stats_tail(output_dir, dist_np, [means_np], seed)[0]


def _contacts(pos, boxes, cutoff):
    """(F, n, n) bool contacts within (0, cutoff] of the atoms pos (F, n, 3)."""
    return pairs.neighbor_mask(pos, pos, boxes[:, None, None, :], 0.0, cutoff)


@clock.traced("call:get_ion_cluster_stats")
def get_ion_cluster_stats(
    top_file,
    traj_file,
    ion_inds,
    charges,
    stride: int = 1,
    cutoff: float = 3.5,
    output_dir: str = ".",
    seed: int | None = 0,
    device="cuda",
):
    """Ion contact-cluster statistics (orderParam_lib.py:239-311): clusters
    of ions within `cutoff`, per-cluster net charge, mean effective charge
    of the clusters that hold a cation. Returns ([mean cluster size, CI],
    [mean effective charge, CI]); writes clusterDistribution.txt."""
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj_file, stride)
    ion_inds = np.asarray(ion_inds, int)
    n = len(ion_inds)
    q = clock.to_device(np.asarray(charges, np.float32), device=dev)
    stage_end("host gather")
    pos, boxes = _to(traj.positions[:, ion_inds, :], traj.boxes, dev)
    stage_end("H2D")
    dist = torch.zeros(n, dtype=torch.int64, device=dev)
    sizes_m, effs = [], []
    for fs in _frame_blocks(pos.shape[0], 3 * n * n):
        labels = clusters_mod.connected_components(_contacts(pos[fs], boxes[fs], cutoff)).long()
        fb = labels.shape[0]
        sizes = torch.zeros_like(labels).scatter_add_(1, labels, torch.ones_like(labels))
        sizes_m.append(clusters_mod.mean_of_sizes(sizes))
        net = torch.zeros((fb, n), dtype=torch.float32, device=dev).scatter_add_(
            1, labels, q.expand(fb, -1))
        has_cation = torch.zeros_like(labels).scatter_reduce_(
            1, labels, (q > 0).long().expand(fb, -1), "amax") > 0
        n_cat = torch.clamp(has_cation.sum(dim=1), min=1)
        effs.append(torch.where(has_cation, net, 0.0).sum(dim=1) / n_cat)
        dist += clusters_mod.size_distribution(sizes, n)[:, 1:].sum(dim=0)
    stage_end("stats (device)")
    dist_np = dist.cpu().numpy()
    series = [torch.cat(s).cpu().numpy() for s in (sizes_m, effs)]
    stage_end("D2H")
    out = _stats_tail(output_dir, dist_np, series, seed)
    return out[0], out[1]


@clock.traced("call:get_neighbor_stats")
def get_neighbor_stats(
    top_file,
    traj_file,
    atom_inds,
    mol_ids,
    stride: int = 1,
    cutoff: float = 3.5,
    output_dir: str = ".",
    seed: int | None = 0,
    device="cuda",
):
    """Per-molecule coordination numbers (orderParam_lib.py:313-384):
    contacts between atoms of *different* molecules within `cutoff`
    (intra-molecular contacts zeroed, ref :352-353), folded per molecule.
    Returns [mean coordination, CI]; writes coordDistribution.txt."""
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj_file, stride)
    atom_inds = np.asarray(atom_inds, int)
    mol = clock.to_device(np.asarray(mol_ids, np.int64), device=dev)
    n_mol = int(np.max(mol_ids)) + 1
    n_bins = 20
    stage_end("host gather")
    pos, boxes = _to(traj.positions[:, atom_inds, :], traj.boxes, dev)
    stage_end("H2D")
    other = mol[:, None] != mol[None, :]
    hist = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    means = []
    for fs in _frame_blocks(pos.shape[0], 3 * len(atom_inds) ** 2):
        inter = _contacts(pos[fs], boxes[fs], cutoff) & other
        per_atom = inter.sum(dim=2).to(torch.float32)
        per_mol = torch.zeros((per_atom.shape[0], n_mol), dtype=torch.float32,
                              device=dev).index_add_(1, mol, per_atom)
        hist += histograms.masked_histogram_frames(
            per_mol, torch.ones_like(per_mol, dtype=torch.bool), n_bins, 0.0, float(n_bins)
        ).sum(dim=0)
        means.append(per_mol.mean(dim=1))
    stage_end("stats (device)")
    hist_np, means_np = hist.cpu().numpy(), torch.cat(means).cpu().numpy()
    stage_end("D2H")
    np.savetxt(os.path.join(output_dir, "coordDistribution.txt"),
               np.stack([np.arange(n_bins) + 0.5, hist_np], axis=1),
               header="coordination    frequency", fmt="%.3e")
    stage_end("savetxt")
    out = blocks.mean_and_ci(means_np, seed=seed)
    stage_end("bootstrap (host)")
    return out
