"""Voronoi drivers (port of waterorderlib_tpu.drivers.voronoi_driver):
per-water Voronoi volume, area and asphericity (`voronoi_calc`,
orderParam_lib.py:964-1111), the solute's contact areas
(`contact_area_calc`, :1794-1942) and its hydrated volume
(`hydrated_volume_calc`, the JAX package's completion of :1113-1267).

engine="device" runs the certified device cells
(surface/voronoi_device.py) on float32 coordinates, frames batched in
chunks; engine="host" runs the float64 Qhull tessellation
(surface/voronoi.py) frame by frame. The contact drivers read only the
solute's rows of the contact matrix, so the device engine builds those rows
alone. Statistics, histograms and the bootstrap are host numpy, as in the
JAX package. `stage_times()` (core/clock.py) times the named steps of a
call made inside it.
"""

from __future__ import annotations

import os

import numpy as np

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end
from waterorderlib_tpu_torch.drivers.orderparams import (
    _mean_ci_rows,
    _not_ported,
    _resolve_system,
    _save_hist,
)
from waterorderlib_tpu_torch.stats import blocks
from waterorderlib_tpu_torch.utils import logging as _logging_mod

# point count from which "auto" takes the device cells on a CUDA device;
# below it, and on the CPU, the host Qhull tessellation (exact in float64,
# and there the clip builder's plain PyTorch loses to Qhull)
_DEVICE_MIN_POINTS = 2048


def _pick_engine(engine: str, n_points: int, device) -> str:
    if engine == "auto":
        cuda = resolve_device(device).type == "cuda"
        return "device" if cuda and n_points >= _DEVICE_MIN_POINTS else "host"
    if engine not in ("host", "device"):
        raise ValueError(f"engine must be auto|host|device, got {engine!r}")
    return engine


def _log_engine_once(driver: str, engine: str, extra: str = ""):
    _logging_mod.log_once(
        (driver, engine), "%s: voronoi engine=%s%s", driver, engine, extra
    )


def _gather(traj, c0, c1, heavy):
    """The heavy atoms of frames c0:c1 as float32, in a `gather` span."""
    with clock.span("gather"):
        pos_b = np.asarray(traj.positions[c0:c1][:, heavy], np.float32)
        clock.count("gather_bytes", pos_b.nbytes)
    return pos_b


def _masked_stats(vals):
    vals = vals[~np.isinf(vals)]
    if len(vals) == 0:
        return np.nan, np.nan, vals
    return float(np.mean(vals)), float(np.var(vals)), vals


@clock.traced("call:voronoi_calc")
def voronoi_calc(
    top_file,
    traj_file,
    sub_inds=None,
    n_pops: int = 0,
    wat_res: str = "WAT",
    stride: int = 1,
    output_dir: str = ".",
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
    device="cuda",
):
    """Per-water Voronoi volume/area/asphericity eta = A^3/(36 pi V^2)
    (orderParam_lib.py:964-1111). Returns (avgVol, varVol, avgArea, varArea,
    avgEta, varEta), each [means (P+1,), CIs (P+1,)]; writes
    {Vol,Area,Eta}Distribution_j.txt.

    engine: "host" = Qhull tessellation (float64-exact); "device" =
    certified cells on `device` with the escalation ladder and a per-atom
    host close; "auto" = device on a CUDA device at >= 2048 points, else
    host. The device engine batches frames in chunks of `chunk_frames`
    (default min(F, 16)): one search launch and one clip build for tier 1
    of a chunk, one launch per escalation tier; one frame is a batch of
    one."""
    _not_ported(mesh)
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj_file, stride)
    with clock.span("topology"):
        wat_inds, _, _ = top.get_wat_inds(wat_res)
        sol_inds, *_ = top.get_sol_inds(wat_res)
        heavy = np.concatenate([wat_inds, sol_inds])
        row_of_wat = {int(w): i for i, w in enumerate(wat_inds)}
    F = traj.n_frames
    nw = len(wat_inds)
    eng = _pick_engine(engine, len(heavy), dev)
    _log_engine_once("voronoi_calc", eng)
    vol_b = np.zeros((F, nw))
    area_b = np.zeros((F, nw))
    if eng == "device":
        from waterorderlib_tpu_torch.surface.voronoi_device import voronoi_volumes_hybrid_frames

        cf = int(chunk_frames) if chunk_frames else min(F, 16)
        n_cert_tot = 0
        for c0 in range(0, F, cf):
            c1 = min(c0 + cf, F)
            pos_b = _gather(traj, c0, c1, heavy)
            box_ls = np.asarray(traj.boxes[c0:c1, 0], np.float64)
            stage_end("host gather")
            vol_b[c0:c1], area_b[c0:c1], n_c = voronoi_volumes_hybrid_frames(
                pos_b, box_ls, nw, device=dev
            )
            n_cert_tot += int(n_c)
        _log_engine_once(
            "voronoi_calc.cert", "device",
            f" ({n_cert_tot}/{F * nw} cells device-certified, frames "
            f"batched in chunks of {cf})",
        )
    else:
        from waterorderlib_tpu_torch.surface.voronoi import voronoi_volumes

        for t in range(F):
            pos = traj.positions[t].astype(np.float64)
            vol_b[t], area_b[t] = voronoi_volumes(pos[heavy], float(traj.boxes[t][0]), nw)
            stage_end("host tessellation")

    stats = {k: np.zeros((F, n_pops + 1)) for k in
             ("avgV", "varV", "avgA", "varA", "avgE", "varE")}
    val_lists = {k: [[] for _ in range(n_pops + 1)] for k in ("V", "A", "E")}

    for t in range(F):
        vol, area = vol_b[t], area_b[t]
        eta = np.where(
            np.isinf(vol) | np.isinf(area), np.inf,
            area**3 / (36.0 * np.pi * np.maximum(vol, 1e-300) ** 2),
        )
        pops = [np.arange(nw)]
        if sub_inds is not None:
            pops += [np.array([row_of_wat[int(a)] for a in sub_inds[t][p]], int)
                     for p in range(n_pops)]
        for j, rows in enumerate(pops):
            m_v, v_v, vv = _masked_stats(vol[rows])
            m_a, v_a, aa = _masked_stats(area[rows])
            m_e, v_e, ee = _masked_stats(eta[rows])
            stats["avgV"][t, j], stats["varV"][t, j] = m_v, v_v
            stats["avgA"][t, j], stats["varA"][t, j] = m_a, v_a
            stats["avgE"][t, j], stats["varE"][t, j] = m_e, v_e
            val_lists["V"][j].append(vv)
            val_lists["A"][j].append(aa)
            val_lists["E"][j].append(ee)
    stage_end("statistics and histograms")

    for j in range(n_pops + 1):
        for key, fname, rng, header in (
            ("V", f"VolDistribution_{j}.txt", (10.0, 60.0), "water volume (A^3)    frequency"),
            ("A", f"AreaDistribution_{j}.txt", (10.0, 100.0), "water area (A^2)    frequency"),
            ("E", f"EtaDistribution_{j}.txt", (1.0, 2.5), "asphericity    frequency"),
        ):
            vals = np.concatenate(val_lists[key][j]) if val_lists[key][j] else np.zeros(0)
            hist, _ = np.histogram(vals, bins=500, range=rng)
            _save_hist(os.path.join(output_dir, fname), hist, 500, rng[0], rng[1], header)
    stage_end("savetxt")

    res = _mean_ci_rows(*(stats[key] for key in ("avgV", "varV", "avgA", "varA", "avgE", "varE")),
                        seed=seed)
    stage_end("bootstrap CIs")
    return res


def _contact_rows_iter(eng, traj, heavy, sol_rows, chunk_frames, device):
    """Per frame (the solute rows of the symmetrized contact matrix
    (n_sol, num), atom_vol (1, num), wat_area of those rows (n_sol,)),
    frame by frame: the device engine's frame batches in chunks of
    `chunk_frames` (default min(F, 16)), or the host Qhull tessellation."""
    F, num = traj.n_frames, len(heavy)
    if eng == "device":
        from waterorderlib_tpu_torch.surface.voronoi_device import DEFAULT_TIERS, _contacts_frames

        cf = int(chunk_frames) if chunk_frames else min(F, 16)
        for c0 in range(0, F, cf):
            c1 = min(c0 + cf, F)
            pos_b = _gather(traj, c0, c1, heavy)
            box_ls = np.asarray(traj.boxes[c0:c1, 0], np.float64)
            stage_end("host gather")
            for rows, _, wat_rows, atom_vol, n_cert in _contacts_frames(
                    pos_b, box_ls, num, sol_rows, DEFAULT_TIERS, 256, 96, "clip", device, False):
                if c0 == 0:
                    _log_engine_once("contacts.cert", "device",
                                     f" ({n_cert}/{len(sol_rows)} solute cells device-certified "
                                     f"on frame 0, frames batched in chunks of {cf})")
                yield rows, atom_vol, wat_rows
        return
    from waterorderlib_tpu_torch.surface.voronoi import voronoi_contacts

    for t in range(F):
        pos = traj.positions[t].astype(np.float64)
        contacts, _, wat_area, atom_vol = voronoi_contacts(pos[heavy], float(traj.boxes[t][0]),
                                                           num)
        stage_end("host tessellation")
        yield contacts[sol_rows], atom_vol, wat_area[0, sol_rows]


@clock.traced("call:contact_area_calc")
def contact_area_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    cutoff: float = 4.0,
    hb_dist: float = 3.0,
    hb_ang: float = 150.0,
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
    device="cuda",
):
    """Fraction of the solute's Voronoi surface in contact with
    phobic/philic/bound/wrap atoms (orderParam_lib.py:1794-1942).

    Returns (totArea, totArea_CI, fracArea, fracArea_CI) in the reference's
    ordering: totArea = [tot, phobic, philic, bound, wrap]; fracArea =
    [phobic, philic, bound, wrap]. Contact areas are halved to undo the
    double-sided hull.area convention (ref getTotArea :1899-1910);
    intra-solute-residue contacts are excluded from the target sums.

    engine: "host" (Qhull) | "device" (certified cells on `device`, frames
    batched in chunks of `chunk_frames`, default min(F, 16)) | "auto" (as
    in `voronoi_calc`). The bound/wrap masks come from `get_bound_wrap` on
    `device`."""
    _not_ported(mesh)
    dev = resolve_device(device)
    from waterorderlib_tpu_torch.drivers.hbonds_driver import get_bound_wrap

    top, traj = _resolve_system(top_file, traj_file, stride)
    with clock.span("topology"):
        heavy = top.get_heavy_inds()
        sol_inds, *_ = top.get_sol_inds(wat_res)
        phobic = top.get_phobic_inds()
        philic = top.get_philic_inds()

        heavy_row = {int(a): i for i, a in enumerate(heavy)}
        to_rows = lambda inds: np.array([heavy_row[int(a)] for a in inds if int(a) in heavy_row],
                                        int)
        sol_rows = to_rows(sol_inds)
        phobic_rows = to_rows(phobic)
        philic_rows = to_rows(philic)
        # heavy atoms of each solute atom's own residue (excluded from targets)
        sol_res_rows = []
        for a in sol_inds:
            res = top.res_ids[a]
            members = np.where((top.res_ids == res) & (top.elements != "H"))[0]
            sol_res_rows.append(set(to_rows(members).tolist()))
    stage_end("host gather")

    bw = get_bound_wrap(top, traj, wat_res=wat_res, cutoff=cutoff, hb_dist=hb_dist,
                        hb_ang=hb_ang, device=dev)
    stage_end("bound/wrap")

    F = traj.n_frames
    out = {k: np.zeros(F) for k in ("tot", "phobic", "philic", "bound", "wrap")}

    def tot_area(rows, target_rows, with_total=False):
        tot_target = 0.0
        tot = 0.0
        for i in range(len(sol_rows)):
            row = rows[i]
            tot += row.sum() / 2.0
            mask = np.zeros(len(row), bool)
            mask[target_rows] = True
            for r in sol_res_rows[i]:
                mask[r] = False
            tot_target += row[mask].sum() / 2.0
        return (tot_target, tot) if with_total else tot_target

    eng = _pick_engine(engine, len(heavy), dev)
    _log_engine_once("contact_area_calc", eng)
    frames = _contact_rows_iter(eng, traj, heavy, sol_rows, chunk_frames, dev)
    for t, (rows, _, _) in enumerate(frames):
        bound_rows = to_rows(bw[t][0])
        wrap_rows = to_rows(bw[t][1])
        out["phobic"][t], out["tot"][t] = tot_area(rows, phobic_rows, with_total=True)
        out["philic"][t] = tot_area(rows, philic_rows)
        out["bound"][t] = tot_area(rows, bound_rows)
        out["wrap"][t] = tot_area(rows, wrap_rows)
        stage_end("statistics")

    tot = out["tot"]
    safe_tot = np.where(tot > 0, tot, 1.0)
    fracs = {k: out[k] / safe_tot for k in ("phobic", "philic", "bound", "wrap")}
    keys = ("phobic", "philic", "bound", "wrap")
    tot_area_res = [float(np.mean(tot))] + [float(np.mean(out[k])) for k in keys]
    cis = blocks.block_average_columns([tot] + [out[k] for k in keys] + [fracs[k] for k in keys],
                                       seed=seed)
    tot_ci, frac_ci = cis[:5], cis[5:]
    frac_res = [float(np.mean(fracs[k])) for k in keys]
    stage_end("bootstrap CIs")
    return tot_area_res, tot_ci, frac_res, frac_ci


@clock.traced("call:hydrated_volume_calc")
def hydrated_volume_calc(
    top_file,
    traj_file,
    wat_res: str = "WAT",
    stride: int = 1,
    seed: int | None = 0,
    engine: str = "auto",
    mesh=None,
    chunk_frames: int | None = None,
    device="cuda",
):
    """The JAX package's completed hydratedVolumeCalc (the reference's is
    unfinished, orderParam_lib.py:1113-1267): per-frame total Voronoi cell
    volume and exposed (water-facing) area of the solute heavy atoms.
    Returns ([mean vol, CI], [mean water-exposed area, CI]). engine,
    chunk_frames and device as in `contact_area_calc`."""
    _not_ported(mesh)
    dev = resolve_device(device)
    top, traj = _resolve_system(top_file, traj_file, stride)
    with clock.span("topology"):
        heavy = top.get_heavy_inds()
        sol_inds, *_ = top.get_sol_inds(wat_res)
        heavy_row = {int(a): i for i, a in enumerate(heavy)}
        sol_rows = np.array([heavy_row[int(a)] for a in sol_inds], int)
    F = traj.n_frames
    vols = np.zeros(F)
    areas = np.zeros(F)
    eng = _pick_engine(engine, len(heavy), dev)
    _log_engine_once("hydrated_volume_calc", eng)
    frames = _contact_rows_iter(eng, traj, heavy, sol_rows, chunk_frames, dev)
    for t, (_, atom_vol, wat_rows) in enumerate(frames):
        vols[t] = atom_vol[0, sol_rows].sum()
        areas[t] = wat_rows.sum()
        stage_end("statistics")
    res = tuple(blocks.mean_and_ci_columns([vols, areas], seed=seed))
    stage_end("bootstrap CIs")
    return res
