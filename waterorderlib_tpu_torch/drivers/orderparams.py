"""Trajectory-level order-parameter drivers (port of
waterorderlib_tpu.drivers.orderparams; the q_tet driver so far).

The whole trajectory moves to the device once as an (F, Nw, 3) float32
tensor; q is computed for every water by the certified slab dispatch
(ops/cuda/qtet2.py), and sub-populations are boolean masks over the water
axis, so population statistics are masked reductions over the same values.
Writes `qDistribution_j.txt` into `output_dir` and returns [mean, CI] pairs
from the same 20-block bootstrap (host numpy, `seed`) as the JAX package.
"""

from __future__ import annotations

import hashlib
import os
from time import monotonic

import numpy as np
import torch

from waterorderlib_tpu.io.streaming import iter_chunks
from waterorderlib_tpu.io.topology import Topology
from waterorderlib_tpu.io.trajectory import Trajectory, load_system, load_topology
from waterorderlib_tpu.stats import blocks
from waterorderlib_tpu.utils import logging as _logging_mod
from waterorderlib_tpu_torch.ops import histograms, pairs
from waterorderlib_tpu_torch.ops.cuda import qtet2


def _device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch finds no CUDA device; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    return dev


def _log_tier(driver: str, tier: str) -> None:
    """Record (once per driver+tier) which kernel tier served a driver call."""
    _logging_mod.log_once(
        ("waterorderlib_tpu_torch", driver, tier), "%s: serving tier=%s", driver, tier
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


def _mean_ci_rows(per_frame: np.ndarray, seed):
    """per_frame: (F, P+1) -> ([mean_j], [CI_j]) as the reference returns."""
    means = np.nanmean(per_frame, axis=0)
    cis = np.array(
        [blocks.block_average(per_frame[:, j], seed=seed) for j in range(per_frame.shape[1])]
    )
    return [means, cis]


def _masks_tensor(sub_inds, n_frames, n_pops, row_map, nw, device) -> torch.Tensor:
    """(F, P+1, Nw) bool: slot 0 is every water, then the populations."""
    pops = pop_masks_from_subinds(sub_inds, n_frames, n_pops, row_map, nw)
    all_mask = np.ones((n_frames, 1, nw), dtype=bool)
    return torch.as_tensor(np.concatenate([all_mask, pops], axis=1), device=device)


# ---------------------------------------------------------------------------
# tetOrderCalc
# ---------------------------------------------------------------------------

def _q_pop_stats(q_all, masks, n_bins, lo, hi):
    """Masked population statistics over precomputed q (F, Nw): returns
    (hist (P+1, n_bins) int64, (means (F, P+1), vars (F, P+1)))."""
    means, vars_ = histograms.masked_mean_var(q_all[:, None, :], masks)
    hist = torch.stack([
        histograms.masked_histogram(q_all, masks[:, p, :], n_bins, lo, hi)
        for p in range(masks.shape[1])
    ])
    return hist, (means, vars_)


def _tet_core(wat_pos, boxes, masks, low_cut, high_cut, n_bins, lo, hi):
    """q + population statistics for one frame batch: returns
    (hist (P+1, n_bins), (means (F, P+1), vars (F, P+1)))."""
    q_all = qtet2.order_param_q_certified(wat_pos, boxes, low_cut, high_cut)
    _log_tier("tet_order_calc", qtet2.last_tier)
    return _q_pop_stats(q_all, masks, n_bins, lo, hi)


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
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: torch.distributed scale-out is ROADMAP "
            "queue 1 item 15"
        )
    dev = _device(device)
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
        top, traj = _resolve_system(top_file, traj_file, stride)
        wat_inds, _, _ = top.get_wat_inds(wat_res)
        nw = len(wat_inds)
        # trajectories may hold float64 frames; the kernels take float32
        wat_pos = torch.as_tensor(traj.positions[:, wat_inds, :], dtype=torch.float32, device=dev)
        boxes = torch.as_tensor(traj.boxes, dtype=torch.float32, device=dev)
        masks = _masks_tensor(
            sub_inds, traj.n_frames, n_pops, _row_of_atom(wat_inds, top.n_atoms), nw, dev
        )
        hist, (avg_q, var_q) = core(wat_pos, boxes, masks)
        hist, avg_q, var_q = (t.cpu().numpy() for t in (hist, avg_q, var_q))
    for j in range(n_pops + 1):
        _save_hist(
            os.path.join(output_dir, f"qDistribution_{j}.txt"),
            hist[j], n_bins, lo, hi, "qVal    frequency",
        )
    return _mean_ci_rows(avg_q, seed), _mean_ci_rows(var_q, seed)


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
    fp_params: tuple = (),
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
    """
    top = top_file if isinstance(top_file, Topology) else load_topology(top_file)
    wat_inds, _, _ = top.get_wat_inds(wat_res)
    nw = len(wat_inds)
    row_map = _row_of_atom(wat_inds, top.n_atoms)

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
        masks_c = _masks_tensor(sub_c, fc, n_pops, row_map, nw, device)
        carry, stats = core(
            torch.as_tensor(pos_c[:, wat_inds, :], dtype=torch.float32, device=device),
            torch.as_tensor(boxes_c, dtype=torch.float32, device=device),
            masks_c,
        )
        carry = [c.cpu().numpy() for c in (carry if isinstance(carry, (tuple, list)) else (carry,))]
        stats = [s.cpu().numpy() for s in (stats if isinstance(stats, (tuple, list)) else (stats,))]
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
