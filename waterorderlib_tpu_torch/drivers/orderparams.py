"""Trajectory-level order-parameter drivers (port of
waterorderlib_tpu.drivers.orderparams): `tet_order_calc`, `three_body_calc`,
`lsi_calc` and `hex_order_calc`.

The centers' atom span of the trajectory moves to the device in chunks of
frames, and the device gathers the (F, Nc, 3) float32 center rows from it
(`_center_rows`); each driver computes its per-center values for every
center by a certified kernel dispatch (ops/cuda/qtet2.py, angles.py,
lsi.py, psi6.py), and sub-populations are boolean masks over the center axis, so
population statistics are masked reductions over the same values. Each
driver writes the JAX package's text artifacts into `output_dir` and returns
[mean, CI] pairs from the same 20-block bootstrap (host numpy, `seed`).

`stage_times()` (core/clock.py) times the named steps of the driver calls
made inside it.
"""

from __future__ import annotations

import hashlib
import os
from time import monotonic

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
# stage_times is re-exported: callers time the drivers as orderparams.stage_times()
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end, stage_times  # noqa: F401
from waterorderlib_tpu_torch.io.streaming import iter_chunks
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory, load_system, load_topology
from waterorderlib_tpu_torch.ops import histograms, pairs
from waterorderlib_tpu_torch.ops.cuda import angles as angles_kernel
from waterorderlib_tpu_torch.ops.cuda import lsi as lsi_kernel
from waterorderlib_tpu_torch.ops.cuda import psi6 as psi6_kernel
from waterorderlib_tpu_torch.ops.cuda import qtet2
from waterorderlib_tpu_torch.order import angles as angles_mod
from waterorderlib_tpu_torch.stats import blocks
from waterorderlib_tpu_torch.utils import logging as _logging_mod


def _not_ported(mesh, max_neighbors=None, k=None, driver=""):
    """Raise for the options the port does not have yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: torch.distributed scale-out is ROADMAP "
            "queue 1 item 15"
        )
    if max_neighbors is not None and max_neighbors != k:
        raise NotImplementedError(
            f"{driver}: max_neighbors={max_neighbors} is not ported; its kernel keeps "
            f"the K={k} nearest shell neighbors (ROADMAP queue 1, the {driver} item)"
        )


def _resolve_system(top_file, traj_file, stride):
    """Accept either file paths or in-memory (Topology, Trajectory)."""
    if isinstance(top_file, Topology):
        top = top_file
        traj = traj_file if stride == 1 else traj_file.strided(stride)
    else:
        top, traj = load_system(top_file, traj_file, stride=stride)
    if traj is not None and traj.n_atoms != top.n_atoms:
        raise ValueError(
            f"topology has {top.n_atoms} atoms but trajectory frames have "
            f"{traj.n_atoms} — mismatched system files"
        )
    return top, traj


def pop_masks_from_subinds(
    sub_inds, n_frames: int, n_pops: int, row_of_atom: np.ndarray, n_rows: int
) -> np.ndarray:
    """Convert the reference's ragged per-frame population index lists
    ([[pop0_inds, pop1_inds, ...]_t, ...], global atom indices) into a dense
    (F, P, n_rows) boolean mask over center rows."""
    masks = np.zeros((n_frames, n_pops, n_rows), dtype=bool)
    if sub_inds is None:
        return masks
    for t in range(n_frames):
        for p in range(n_pops):
            rows = row_of_atom[np.asarray(sub_inds[t][p], dtype=int)]
            if np.any(rows < 0):
                raise ValueError("population index is not a center atom")
            masks[t, p, rows] = True
    return masks


def _row_of_atom(center_inds: np.ndarray, n_atoms: int) -> np.ndarray:
    out = np.full(n_atoms, -1, dtype=np.int64)
    out[center_inds] = np.arange(len(center_inds))
    return out


def _save_hist(path: str, hist: np.ndarray, n_bins: int, lo: float, hi: float, header: str):
    centers = histograms.bin_centers(n_bins, lo, hi)
    np.savetxt(path, np.stack([centers, hist], axis=1), header=header, fmt="%.3e")


def _mean_ci_rows(*per_frame: np.ndarray, seed):
    """Each per_frame: (F, P+1) -> [[mean_j], [CI_j]] as the reference
    returns, in a tuple; one bootstrap draw for every column of them."""
    cis = iter(blocks.block_average_columns(
        [a[:, j] for a in per_frame for j in range(a.shape[1])], seed=seed))
    return tuple([np.nanmean(a, axis=0), np.array([next(cis) for _ in range(a.shape[1])])]
                 for a in per_frame)


def _masks_tensor(sub_inds, n_frames, n_pops, row_map, nw, device) -> torch.Tensor:
    """(F, P+1, Nw) bool: slot 0 is every water, then the populations."""
    pops = pop_masks_from_subinds(sub_inds, n_frames, n_pops, row_map, nw)
    all_mask = np.ones((n_frames, 1, nw), dtype=bool)
    return clock.to_device(np.concatenate([all_mask, pops], axis=1), device=device)


def _centers(top, wat_res, center_select):
    """Center atom indices: the water oxygens, or `center_select(top)`."""
    if center_select is not None:
        return np.asarray(center_select(top))
    return top.get_wat_inds(wat_res)[0]


def _as_numpy(out):
    """A core's tensor or tuple of tensors as numpy arrays."""
    if isinstance(out, (tuple, list)):
        return type(out)(_as_numpy(t) for t in out)
    return out.cpu().numpy()


def _frame_spans(n_frames: int, frame_bytes: int, out_bytes: int) -> list:
    """Frame ranges [f0, f1) of near-equal size, as few as hold at most
    `out_bytes` of `frame_bytes` a frame each, and at least one frame."""
    per = max(1, out_bytes // frame_bytes)
    size = -(-n_frames // -(-n_frames // per))
    return [(f0, min(f0 + size, n_frames)) for f0 in range(0, n_frames, size)]


def _center_rows(positions, inds, lo, hi, device) -> torch.Tensor:
    """`positions[:, inds, :]` as a float32 (F, Nc, 3) tensor on `device`,
    gathered there: the host hands the device the centers' atom span
    [lo, hi) of each chunk of frames, as one run of a C-contiguous array's
    memory (no host copy) or as a row copy of a strided one; the device
    gathers rows `inds - lo` of each chunk.

    A chunk holds at most the output's bytes, so the device holds no more
    than twice the rows. Counts `block_bytes` (the memory handed over) and
    `device_gather_bytes` (the rows made) in `device_gather` spans."""
    f, n_atoms = positions.shape[:2]
    out = torch.empty((f, len(inds), 3), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    idx = clock.to_device(inds - lo, torch.int64, device)
    whole = positions.flags.c_contiguous
    step = 3 * (n_atoms if whole else hi - lo)  # elements from frame to frame
    flat = positions.reshape(-1) if whole else None
    for f0, f1 in _frame_spans(f, step * out.element_size(), out.nbytes):
        if whole:
            run = flat[(f0 * n_atoms + lo) * 3:((f1 - 1) * n_atoms + hi) * 3]
        else:
            run = np.ascontiguousarray(positions[f0:f1, lo:hi]).reshape(-1)
        # float64 frames are cast as they cross, which commutes with the gather
        block = clock.to_device(run, torch.float32, device)
        with clock.span("device_gather", device=True):
            view = block.as_strided((f1 - f0, hi - lo, 3), (step, 3, 1))
            rows = out[f0:f1]
            torch.index_select(view, 1, idx, out=rows)
            clock.count("block_bytes", block.nbytes)
            clock.count("device_gather_bytes", rows.nbytes)
        del view, block  # free this chunk before the next one is allocated
    return out


def _frames_in(positions, boxes, inds, sub_inds, n_pops, row_map, device):
    """Center rows (F, Nc, 3), boxes (F, 3) and population masks of a frame
    batch on the device."""
    lo, hi = (int(inds.min()), int(inds.max()) + 1) if len(inds) else (0, 0)
    stage_end("host gather")
    pos = _center_rows(positions, inds, lo, hi, device)
    boxes_t = clock.to_device(boxes, torch.float32, device)
    stage_end("H2D")
    masks = _masks_tensor(sub_inds, pos.shape[0], n_pops, row_map, len(inds), device)
    stage_end("masks (host + H2D)")
    return pos, boxes_t, masks


def _run_core(core, pos, boxes, masks):
    """`core(pos, boxes, masks)`'s (carry, stats) as numpy. A core may also
    return {counter: count}, counts as ints or 0-d device tensors: they are
    read after (carry, stats) have crossed, when the device has nothing left
    to do, and added to the registry (`clock.count`)."""
    carry, stats, *counts = core(pos, boxes, masks)
    out = _as_numpy((carry, stats))
    for name, n in (counts[0].items() if counts else ()):
        clock.count(name, int(n))
    stage_end("D2H")
    return out


def _run_whole(top_file, traj_file, sub_inds, n_pops, wat_res, stride, core, device,
               center_select=None):
    """Run `core(center_pos, boxes, masks)` over the whole trajectory at once;
    returns its (carry, stats) as numpy."""
    top, traj = _resolve_system(top_file, traj_file, stride)
    with clock.span("topology"):
        inds = _centers(top, wat_res, center_select)
        row_map = _row_of_atom(inds, top.n_atoms)
    return _run_core(core, *_frames_in(traj.positions, traj.boxes, inds, sub_inds, n_pops,
                                       row_map, device))


def _masked_value_pop_stats(values, masks, n_bins, lo, hi, valid=None):
    """(hist (P+1, n_bins) int64, (means (F, P+1), vars (F, P+1))) of
    per-center values (F, N) under per-population masks (F, P+1, N),
    intersected with a per-center validity mask (F, N) when one is given."""
    if valid is not None:
        masks = masks & valid[:, None, :]
    means, vars_ = histograms.masked_mean_var(values[:, None, :], masks)
    hist = torch.stack([
        histograms.masked_histogram(values, masks[:, p, :], n_bins, lo, hi)
        for p in range(masks.shape[1])
    ])
    return hist, (means, vars_)


# ---------------------------------------------------------------------------
# tetOrderCalc
# ---------------------------------------------------------------------------

def _tet_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi):
    """q + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)))."""
    q_all = qtet2.order_param_q_certified(wat_pos, boxes, low_cut, high_cut)
    stage_end("kernel stage")
    out = _masked_value_pop_stats(q_all, masks, n_bins, lo, hi)
    stage_end("stats (device)")
    return out


@clock.traced("call:tet_order_calc")
def tet_order_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 10.0,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    checkpoint: str | None = None,
    mesh=None,
    device="cuda",
):
    """Tetrahedral order parameter driver (orderParam_lib.py:1426-1503).

    Returns (avgQ, varQ): each [means (P+1,), CIs (P+1,)] where slot 0 is the
    all-water population. Writes qDistribution_j.txt per population.

    With `chunk_frames` set, the trajectory streams through the device in
    chunks of that many frames (io/streaming.py), resumable from
    `checkpoint`. `row_block` is accepted for the JAX package's signature;
    the kernel path has no row blocks. `mesh` is not ported yet.
    """
    _not_ported(mesh)
    dev = resolve_device(device)
    n_bins, lo, hi = 500, 0.0, 1.0

    def core(wat_pos, boxes, masks):
        return _tet_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi)

    if chunk_frames is not None:
        hist, (avg_q, var_q) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
            core, n_carry=1, n_stats=2, device=dev, checkpoint=checkpoint,
            fp_params=("tet", low_cut, high_cut),
        )
    else:
        hist, (avg_q, var_q) = _run_whole(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, core, dev
        )
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"qDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "qVal    frequency",
        )
    stage_end("savetxt")
    out = _mean_ci_rows(avg_q, var_q, seed=seed)
    stage_end("bootstrap (host)")
    return out


# ---------------------------------------------------------------------------
# threeBodyCalc
# ---------------------------------------------------------------------------

def _three_body_stats(ang, cnt, masks, n_bins, lo, hi, n2x):
    """Statistics of the kernel path's pair angles (F, N, 128) and shell
    counts (F, N): ((hist (P+1, n_bins), hist2d (n2x * n_bins,)),
    (frac, avg, var, ent, n_wats) each (F, P+1)). Entropy and the other
    metrics are per frame and population, from per-frame histograms."""
    valid = angles_kernel.pair_validity(cnt)  # (F, N, 128)
    per_pop = [
        angles_mod.tetrahedral_metrics_flat(ang, valid & masks[:, p, :, None], n_bins, lo, hi)
        for p in range(masks.shape[1])
    ]
    hist = torch.stack([m.hist.sum(dim=0) for m in per_pop])
    frac, avg, var, ent = (
        torch.stack([getattr(m, name) for m in per_pop], dim=1)
        for name in ("frac_tet", "avg_cos", "var_cos", "entropy")
    )
    n_wats = masks.sum(dim=-1).to(torch.float32)
    # 2-D histogram: per valid angle, x = the center's neighbor count - 1;
    # the angle bin is floor(ang / (hi / n_bins)), the JAX package's rule here
    width = torch.tensor(hi / n_bins, dtype=torch.float32, device=ang.device)
    abin = torch.clamp(torch.floor(ang / width), 0, n_bins - 1).to(torch.int64)
    cc = torch.clamp(cnt.to(torch.int64) - 1, 0, n2x - 1)
    flat_bin = cc[..., None] * n_bins + abin
    hist2d = torch.bincount(flat_bin[valid], minlength=n2x * n_bins)
    return (hist, hist2d), (frac, avg, var, ent, n_wats)


def _three_body_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi, n2x):
    """3-body angles + metrics for one frame batch (see _three_body_stats)."""
    ang, cnt = angles_kernel.neighbor_pair_angles_certified(wat_pos, boxes, low_cut, high_cut)
    stage_end("kernel stage")
    out = _three_body_stats(ang, cnt, masks, n_bins, lo, hi, n2x)
    stage_end("stats (device)")
    return out


@clock.traced("call:three_body_calc")
def three_body_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    n_bins: int = 500,
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 3.413,
    max_neighbors: int = 16,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    output_2d: bool = False,
    chunk_frames: int | None = None,
    checkpoint: str | None = None,
    mesh=None,
    device="cuda",
):
    """Three-body angle distribution driver (orderParam_lib.py:1269-1424).

    Returns (pTet, avgCos, varCos, entropy, nWats), each [means, CIs] over
    populations (slot 0 = all waters). Writes 3bDistribution_j.txt, and with
    output_2d also the (coordination, angle) 2-D histogram as txt and, where
    matplotlib is installed, PNG. `chunk_frames`/`checkpoint` stream the
    trajectory as in tet_order_calc. The kernel keeps the 16 nearest shell
    neighbors: other `max_neighbors`, and `mesh`, are not ported yet.
    """
    _not_ported(mesh, max_neighbors, angles_kernel.K, "three_body_calc")
    dev = resolve_device(device)
    lo, hi = 0.0, 180.0
    # 2-D (coordination, angle) histogram, xedges=arange(-1.5,13.5) (ref :1390)
    n2x = 14

    def core(wat_pos, boxes, masks):
        return _three_body_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi, n2x)

    if chunk_frames is not None:
        (hist, hist2d), stats = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
            core, n_carry=2, n_stats=5, device=dev, checkpoint=checkpoint,
            fp_params=("3body", low_cut, high_cut, n_bins),
        )
    else:
        (hist, hist2d), stats = _run_whole(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, core, dev
        )
    return _three_body_outputs(
        hist, hist2d, *stats, n_pops, n_bins, lo, hi, n2x, output_dir, output_2d, seed,
    )


def _three_body_outputs(
    hist, hist2d, frac, avg, var, ent, n_wats,
    n_pops, n_bins, lo, hi, n2x, output_dir, output_2d, seed,
):
    """Artifact writing + statistics tail of three_body_calc."""
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"3bDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "3-body angle (deg)    frequency",
        )
    if output_2d:
        h2 = np.asarray(hist2d, dtype=np.float64).reshape(n2x, n_bins)
        h2 = h2 / max(h2.sum(), 1.0)
        np.savetxt(
            os.path.join(output_dir, "3bDistribution_2D.txt"), h2,
            header="rows: coordination number N_c (0..13); cols: angle bins over [0,180)",
            fmt="%.3e",
        )
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(4, 4))
            ax.imshow(
                h2, interpolation="gaussian", cmap="viridis", aspect="auto",
                origin="lower", extent=(0, 180, 0, n2x),
            )
            ax.set_xlabel(r"$\theta$ [deg]")
            ax.set_ylabel(r"$N_c$")
            fig.savefig(os.path.join(output_dir, "3bDistribution_2D.png"), dpi=120)
            plt.close(fig)
        except Exception as e:  # plotting is best-effort, but never silent
            _logging_mod.get_logger().warning("three_body_calc: 2-D PNG skipped (%r)", e)
    stage_end("savetxt")
    out = _mean_ci_rows(*map(np.asarray, (frac, avg, var, ent, n_wats)), seed=seed)
    stage_end("bootstrap (host)")
    return out


# ---------------------------------------------------------------------------
# lsiCalc
# ---------------------------------------------------------------------------

def _lsi_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi):
    """LSI + population statistics for one frame batch over the centers
    with a defined LSI: returns (hist (P+1, n_bins), (means (F, P+1),
    vars (F, P+1)))."""
    lsi_v, valid, _ = lsi_kernel.lsi_certified(wat_pos, boxes, low_cut, high_cut)
    stage_end("kernel stage")
    out = _masked_value_pop_stats(lsi_v, masks, n_bins, lo, hi, valid=valid)
    stage_end("stats (device)")
    return out


@clock.traced("call:lsi_calc")
def lsi_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 3.7,
    max_neighbors: int = 24,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    mesh=None,
    device="cuda",
):
    """LSI driver (orderParam_lib.py:1586-1663). Returns (avgLSI, varLSI),
    each [means, CIs] over populations (slot 0 = all waters); writes
    lsiDistribution_j.txt per population (500 bins over [0, 0.3] A^2).

    Each system size takes the JAX package's LSI tier (ops/cuda/lsi.py
    `split_tier`). Both packages give the same values, but for rows with
    more than 12 waters within `high_cut` on the split tier (~8.4k to
    ~140k waters at water density): the port redoes them with the
    definition's next-shell pick, the JAX package takes its K = 24 pick,
    which can miss a next-shell atom beyond the 24 nearest. `chunk_frames`
    streams the trajectory as in tet_order_calc (the JAX `lsi_calc` has no
    checkpoint). `row_block` is accepted for the JAX package's signature;
    the kernel path has no row blocks. The kernels keep the 24 nearest
    candidates: other `max_neighbors`, and `mesh`, are not ported yet.
    """
    _not_ported(mesh, max_neighbors, lsi_kernel.K, "lsi_calc")
    dev = resolve_device(device)
    n_bins, lo, hi = 500, 0.0, 0.3

    def core(wat_pos, boxes, masks):
        return _lsi_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi)

    if chunk_frames is not None:
        hist, (avg_lsi, var_lsi) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
            core, n_carry=1, n_stats=2, device=dev, fp_params=("lsi", low_cut, high_cut),
        )
    else:
        hist, (avg_lsi, var_lsi) = _run_whole(
            top_file, traj_file, sub_inds, n_pops, wat_res, stride, core, dev
        )
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"lsiDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "lsiVal [A^2]    frequency",
        )
    stage_end("savetxt")
    out = _mean_ci_rows(avg_lsi, var_lsi, seed=seed)
    stage_end("bootstrap (host)")
    return out


# ---------------------------------------------------------------------------
# hexOrderCalc
# ---------------------------------------------------------------------------

def _psi_core(end_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi):
    """psi-6 + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)), counts): the
    counters `psi6:rows`, the (frame, center) rows served, and
    `psi6:rows_over_k`, those whose full shell holds more than the K kept
    (the rows the top-K selection decides), summed on the device."""
    psi, cnt = psi6_kernel.psi6_certified(end_pos, boxes, low_cut, high_cut)
    stage_end("kernel stage")
    hist, stats = _masked_value_pop_stats(psi, masks, n_bins, lo, hi)
    counts = {"psi6:rows": cnt.numel(), "psi6:rows_over_k": (cnt > psi6_kernel.K).sum()}
    stage_end("stats (device)")
    return hist, stats, counts


@clock.traced("call:hex_order_calc")
def hex_order_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    end_res: str = "WAT",
    stride: int = 1,
    low_cut: float = 0.0,
    high_cut: float = 7.0,
    max_neighbors: int = 24,
    output_dir: str = ".",
    row_block: int = pairs.DEFAULT_ROW_BLOCK,
    seed: int | None = 0,
    chunk_frames: int | None = None,
    checkpoint: str | None = None,
    mesh=None,
    device="cuda",
):
    """psi-6 hexagonal order driver (orderParam_lib.py:1505-1584).

    Chain-end centers are every other "water" heavy index
    (endInds = watInds[1::2], ref :1527). Returns (avgPsi, varPsi); writes
    psiDistribution_j.txt per population. `chunk_frames`/`checkpoint`
    stream the trajectory as in tet_order_calc. The kernel keeps the 24
    nearest shell neighbors: other `max_neighbors`, and `mesh`, are not
    ported yet.
    """
    _not_ported(mesh, max_neighbors, psi6_kernel.K, "hex_order_calc")
    dev = resolve_device(device)
    n_bins, lo, hi = 500, 0.0, 1.0

    def core(end_pos, boxes, masks):
        return _psi_core(end_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi)

    def ends(top):
        return np.asarray(top.get_wat_inds(end_res)[0])[1::2]

    if chunk_frames is not None:
        hist, (avg_psi, var_psi) = _run_chunked(
            top_file, traj_file, sub_inds, n_pops, end_res, stride, chunk_frames,
            core, n_carry=1, n_stats=2, device=dev, checkpoint=checkpoint,
            fp_params=("psi", low_cut, high_cut, max_neighbors), center_select=ends,
        )
    else:
        hist, (avg_psi, var_psi) = _run_whole(
            top_file, traj_file, sub_inds, n_pops, end_res, stride, core, dev,
            center_select=ends,
        )
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"psiDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "psiVal    frequency",
        )
    stage_end("savetxt")
    out = _mean_ci_rows(avg_psi, var_psi, seed=seed)
    stage_end("bootstrap (host)")
    return out


def _traj_fingerprint(traj_file, fp_params, wat_res, sub_inds) -> bytes:
    """Identity of (trajectory, analysis parameters, populations) so a stale
    checkpoint from another run is discarded, not resumed into."""
    if isinstance(traj_file, (str, os.PathLike)):
        p = os.fspath(traj_file)
        try:
            st = os.stat(p)
            traj_id = f"{p}:{st.st_size}:{int(st.st_mtime)}"
        except OSError:
            traj_id = p
    elif isinstance(traj_file, Trajectory):
        # strided coordinate sample (not just the endpoints, which would
        # wrongly resume after a mid-trajectory edit): <= 16 frames x 8 atoms
        tp = np.asarray(traj_file.positions)
        sample = np.ascontiguousarray(
            tp[:: max(1, tp.shape[0] // 16), :: max(1, tp.shape[1] // 8)]
        )
        traj_id = (
            f"mem:{traj_file.n_frames}:{traj_file.n_atoms}:"
            f"{hashlib.sha256(sample.tobytes()).hexdigest()[:32]}"
        )
    else:
        traj_id = repr(type(traj_file))
    h = hashlib.sha256(repr((traj_id, tuple(fp_params), wat_res)).encode())
    if sub_inds is not None:  # population assignments shape the carry too
        for frame_pops in sub_inds:
            for pop in frame_pops:
                h.update(np.asarray(pop, np.int64).tobytes())
            h.update(b"|")
    return h.digest()[:8]


def _run_chunked(
    top_file, traj_file, sub_inds, n_pops, wat_res, stride, chunk_frames,
    core, n_carry, n_stats, device, checkpoint: str | None = None,
    fp_params: tuple = (), center_select=None,
):
    """Stream a trajectory through `core(wat_pos, boxes, masks)` in chunks.

    core returns (carry, stats), each a tensor or a tuple of tensors;
    carried histograms are summed across chunks, per-frame statistics
    concatenated. The next chunk decodes on a prefetch thread
    (io/streaming.iter_chunks) while the device computes the current one.

    With `checkpoint` set (an .npz path), partial results are written at most
    every 10 s and an interrupted scan resumes from the last completed chunk.
    The checkpoint is fingerprinted by (chunk_frames, stride, n_pops, nw)
    plus the trajectory's identity and `fp_params`; it is removed on success.
    `center_select(top) -> index array` overrides the water-oxygen centers.
    """
    top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
    with clock.span("topology"):
        wat_inds = _centers(top, wat_res, center_select)
        row_map = _row_of_atom(wat_inds, top.n_atoms)
    nw = len(wat_inds)

    carry_acc = None
    stats_parts = []
    frame0 = 0
    resume_from = 0
    last_ck = -1.0e18  # first chunk always checkpoints
    sig = _traj_fingerprint(traj_file, fp_params, wat_res, sub_inds)
    fp = np.concatenate(
        [np.array([chunk_frames, stride, n_pops, nw], np.int64), np.frombuffer(sig, np.int64)]
    )
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint, allow_pickle=False) as ck:
            if np.array_equal(ck["fingerprint"], fp):
                resume_from = int(ck["frames_done"])
                carry_acc = [ck[f"carry_{i}"] for i in range(int(ck["n_carry"]))]
                stats_parts = [
                    [ck[f"stats_{c}_{i}"] for i in range(n_stats)]
                    for c in range(int(ck["n_chunks"]))
                ]
    for pos_c, boxes_c in iter_chunks(traj_file, chunk_frames, stride, n_atoms=top.n_atoms):
        fc = pos_c.shape[0]
        if frame0 + fc <= resume_from:
            frame0 += fc
            continue  # chunk already in the checkpoint
        sub_c = sub_inds[frame0 : frame0 + fc] if sub_inds is not None else None
        carry, stats = _run_core(
            core, *_frames_in(pos_c, boxes_c, wat_inds, sub_c, n_pops, row_map, device)
        )
        carry = list(carry) if isinstance(carry, (tuple, list)) else [carry]
        stats = list(stats) if isinstance(stats, (tuple, list)) else [stats]
        carry_acc = carry if carry_acc is None else [a + c for a, c in zip(carry_acc, carry)]
        stats_parts.append(stats)
        frame0 += fc
        now = monotonic()
        if checkpoint and now - last_ck > 10.0:
            last_ck = now
            payload = {
                "fingerprint": fp,
                "frames_done": np.array(frame0),
                "n_carry": np.array(len(carry_acc)),
                "n_chunks": np.array(len(stats_parts)),
            }
            payload.update({f"carry_{i}": c for i, c in enumerate(carry_acc)})
            for c, part in enumerate(stats_parts):
                payload.update({f"stats_{c}_{i}": s for i, s in enumerate(part)})
            np.savez(checkpoint + ".tmp", **payload)  # np.savez appends .npz
            os.replace(checkpoint + ".tmp.npz", checkpoint)
    if checkpoint and os.path.exists(checkpoint):
        os.remove(checkpoint)
    stats_cat = [np.concatenate([p[i] for p in stats_parts], axis=0) for i in range(n_stats)]
    if n_carry == 1:
        return carry_acc[0], (stats_cat if n_stats > 1 else stats_cat[0])
    return tuple(carry_acc), (stats_cat if n_stats > 1 else stats_cat[0])
