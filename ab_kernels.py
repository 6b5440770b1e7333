"""Time kernels of the device paths as one checkout of this repository builds
them, on the card, each at launches captured from its driver, so that two
checkouts can be compared on the same inputs in turns.

- `voronoi`: the Voronoi kernels at the launches of one 16-frame chunk of
  `voronoi_calc`'s system (12,288 waters and a 6-atom solute, 12,294
  points): `voronoi_cellgrid_topk` at each tier's search launch (tier 1 and
  the escalation tiers, their arguments captured from
  `voronoi_volumes_hybrid_frames(cell_impl="pallas")`), `voronoi_cells_fused`
  at that run's tier-1 launch (196,608 rows at (32, 64)) and at (40, 96) on
  a 2,048-row subset, and `voronoi_window_topk` at (a) that run's last-tier
  full scan (64 rows a frame x 49,176 candidates, k 256) and at the three
  launches of the same call on 2,048 waters x 16 frames (seed 5, no
  solute): (b) tier 1 on the z-window form, (c) and (d) the (48, 96) and
  (64, 128) full scans; then at (a) and (d) cut to their first 1, 2, 4 and
  8 frames (64 to 512 rows: the last tier of a call with `chunk_frames`
  below 16, or of its trailing partial chunk).
- `hbond`: `hbond_dense` at the water-water launch of `hb_calc` on 4096
  waters and a 6-atom solute x 1024 frames, and `hbond_slab` at the launch
  of `hb_calc` on 16,384 waters x 64 frames.
- `lsi`: `lsi_window` at the launch of `lsi_calc` on 4096 waters x 1024
  frames.
- `qtet`: `q_window` at the launch of `tet_order_calc` on 4096 waters x
  1024 frames and at the certified dispatch's slab launches on one frame
  of 131,072 and 1,048,576 atoms (chip_smoke.py's large lattices), and
  `q_window_hist` at `order_param_q_dense`'s one-frame launch on 4096
  waters of chip_smoke.py's seed-1 lattice (the dense q of the earlier q
  kernels).
- `lsi_split`: `lsi_split_window` at the launch of `lsi_calc` on 16,384
  waters x 64 frames whose oxygens sit on chip_smoke.py's `_split_traj`
  lattice (the split tier), and at `lsi_certified`'s launch on one frame
  of 131,072 atoms of that lattice.
For `qtet` and `lsi_split` the driver's kernel stage (the stage clock of
`orderparams.stage_times`, 3 warm calls) is recorded too, and for
`voronoi` the 16-frame chunk's `escalation (128, 256)` stage.

Every launch is first compared with its plain version, exactly (the window
search's in full, the H-bond,
LSI and q launches on their first frames, the 131k and 1M launches on
their first and last row tiles). Prints one JSON line: the label,
the card, and per launch the shape and the kernel's ms (CUDA events, warm,
the mean of `--iters` launches).

The wrappers keep their signatures across checkouts, so the same inputs go
to an older and a newer kernel. To compare two checkouts on one card, run
this file once for each, in turns, within one call:

    python3 ab_kernels.py --repo OLD --label old
    python3 ab_kernels.py --repo . --label new

(then new and old again); `--kernels hbond,lsi` picks the groups.
`--mappings` also times each cell-grid mapping (direct, and grouped at 8 to
64 rows a block) and each cell-kernel block size, where the checkout has
them, the window search at each number of warps a row its checkout
compiles (`WINDOW_SPLITS`; 1, 2, 4 and 8 where it has no such list) and,
at (a)-(d), with its nearest-first scan and stop cut out of the source
(NO_STOP: each window in z order from its start, every chunk offered), and
each block shape of `hbond.cu` (acceptors a thread, kAcc 2, 4, 8 and 16),
of `lsi_window.cu` (the K = 24 kernel's rows a warp,
kRowsPerWarp 1, 2, 4 and 8; the split kernel's rows a block, kRowsS 32, 64
and 128) and of `qtet_window.cu` (the row form's rows a block, kRows 32, 64
and 128; the lane form's rows a warp, kLaneRows 2, 4 and 8; kRowFormMin 0
and 2^60, which force the row and the lane form), built from the
checkout's sources with that one constant changed; for a checkout whose q
kernel still runs the serial 4-slot ladder (the first port's), also that
kernel with the ladder cut out (its q is wrong and not compared: the time
of the scan without the ladder);
`--profile` adds each call's device time by kernel name (torch.profiler),
the wrapper's own PyTorch work apart from the kernel. Needs one CUDA
device; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

# the block-shape constants `--mappings` sweeps: (source, its line, values)
SHAPES = {"hbond": ("hbond", "constexpr int kAcc = {};", (2, 4, 8, 16)),
          "lsi": ("lsi_window", "constexpr int kRowsPerWarp = {};", (1, 2, 4, 8)),
          "lsi_split": ("lsi_window", "constexpr int kRowsS = {};", (32, 64, 128)),
          "qtet": ("qtet_window", "constexpr int kRows = {};", (32, 64, 128)),
          "qtet_lane": ("qtet_window", "constexpr int kLaneRows = {};", (2, 4, 8)),
          "qtet_form": ("qtet_window", "constexpr long long kRowFormMin = {};",
                        ("0", "65536", "1LL << 60"))}
# the window kernel's nearest-first scan and exact stop, cut out: each row
# scans its window from its start, and no side stops
NO_STOP = (("const int c = z_place(ext, s, e, cz);", "const int c = s;"),
           ("if (__shfl_sync(kFull, __float_as_uint(dz2), 0) > (unsigned)(bound >> 32))",
            "if (false)"))
# the serial q kernel's 4-slot ladder, from its first test to its last slot
LADDER = ("      if (!(dsq < d3)) continue;\n",
          "        d3 = dsq; x3 = dx; y3 = dy; z3 = dz;\n      }\n")


def _ms(fn, args, iters, kw=None):
    import torch

    kw = kw or {}
    fn(*args, **kw)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args, **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _profile(label, fn, args, kw=None, calls=3):
    """Device time by kernel name over `calls` calls (torch.profiler), the
    largest first: {name: ms a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = kw or {}
    fn(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args, **kw)
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            rows[ev.key] = t / 1e3 / calls
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1])[:8])
    print(f"[profile] {label}: " + "; ".join(f"{k[:60]} {v:.5f} ms" for k, v in top.items()),
          flush=True)
    return top


def _equal(got, want, keys):
    import torch

    return all(torch.equal(torch.nan_to_num(got[k], 7.0), torch.nan_to_num(want[k], 7.0))
               if got[k].dtype.is_floating_point else torch.equal(got[k], want[k]) for k in keys)


def _voronoi(a, build, record):
    import numpy as np
    import torch
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vc
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vt
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    top, traj = make_water_box(12288, n_frames=16, seed=0,
                               solute_elements=["C", "C", "O", "C", "C", "O"])
    heavy = np.concatenate([top.get_wat_inds("WAT")[0], top.get_sol_inds("WAT")[0]])
    pos, box = traj.positions[:, heavy], traj.boxes[:, 0].astype(np.float64)

    # the launches of one chunk, their arguments captured
    seen = {"cellgrid": [], "cells": [], "window": []}
    ck, kk, wk = vt.voronoi_cellgrid_topk, vc.voronoi_cells_fused, vt.voronoi_window_topk

    def cap_ck(*args):
        seen["cellgrid"].append(args)
        return ck(*args)

    def cap_kk(*args, **kw):
        seen["cells"].append((args, kw))
        return kk(*args, **kw)

    def cap_wk(*args):
        seen["window"].append(args)
        return wk(*args)

    vt.voronoi_cellgrid_topk, vt.voronoi_window_topk = cap_ck, cap_wk
    vc.voronoi_cells_fused = cap_kk
    try:
        vd.voronoi_volumes_hybrid_frames(pos, box, 12288, cell_impl="pallas", device="cuda")
    finally:
        vt.voronoi_cellgrid_topk, vt.voronoi_window_topk, vc.voronoi_cells_fused = ck, wk, kk
    record("voronoi_volumes_hybrid_frames escalation (128, 256) stage", ms=_stage_ms(
        lambda: vd.voronoi_volumes_hybrid_frames(pos, box, 12288, cell_impl="pallas",
                                                 device="cuda"), stage="escalation (128, 256)"))
    for n, args in enumerate(seen["cellgrid"]):
        centers, _, _, tbl_idx, n_side, k = args
        got, want = ck(*args), vt.voronoi_cellgrid_topk_plain(*args)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        shape = (f"{centers.shape[0]} x {centers.shape[1]} rows, grid ({n_side}, "
                 f"{tbl_idx.shape[-1]}), k {k}")
        v = {"shape": shape, "equal": same, "ms": _ms(ck, args, a.iters)}
        if a.mappings and hasattr(vt, "_cellgrid_grouped"):
            pick = vt._cellgrid_grouped
            for mode in (True, False):
                if mode and vt.grouped_smem(tbl_idx.shape[-1]) > vt.SMEM_MAX:
                    continue
                vt._cellgrid_grouped = lambda *_, m=mode: m
                rows0 = getattr(vt, "GROUP_ROWS", None)
                try:
                    for g_rows in ((8, 16, 32, 64) if mode and rows0 else (rows0,)):
                        vt.GROUP_ROWS = g_rows
                        tag = f"grouped {g_rows}" if mode else "direct"
                        g = ck(*args)
                        v[f"{tag} equal"] = (torch.equal(g[0], want[0])
                                             and torch.equal(g[1], want[1]))
                        v[f"{tag} ms"] = _ms(ck, args, a.iters)
                finally:
                    vt._cellgrid_grouped, vt.GROUP_ROWS = pick, rows0
        if a.profile:
            v["profile"] = _profile(f"{a.label} cellgrid launch {n}", ck, args)
        record(f"cellgrid launch {n}", **v)
        del got, want
    keys = ("vol", "area", "r_cell", "closure_err", "ok_shape", "extra_cut", "neg_face",
            "face_area", "face_nverts")
    ext = vd.mirror_points_device(torch.as_tensor(pos[:1], device="cuda"),
                                  torch.as_tensor(box[:1], device="cuda"))
    pb = torch.as_tensor(pos[:1], device="cuda")
    rows = torch.as_tensor(np.random.RandomState(4).choice(12288, 2048, replace=False),
                           device="cuda")
    cg = vd._suggest_cellgrid(pb.shape[1], float(box[0]), 96)
    (_, idx, valid, _), _, rel = vd._search_rows(pb[:, rows], ext, 96, 256, cg=cg,
                                                 box_l=torch.as_tensor(box[:1], device="cuda"))
    wide = (*vd._fused_inputs(rel, valid.reshape(2048, 96), idx.reshape(2048, 96), 40,
                              ext.shape[1]), 40, 1e-4)
    for name, (args, kw) in (("cells tier 1", seen["cells"][0]), ("cells (40, 96)", (wide, {}))):
        got, want = kk(*args, **kw), vc.voronoi_cells_fused_plain(*args, **kw)
        v = {"shape": f"{args[0].shape[0]} rows at ({args[3]}, {args[0].shape[1]})",
             "equal": _equal(got, want, keys), "ms": _ms(kk, args, a.iters, kw)}
        if a.mappings and hasattr(vc, "rows_per_block"):
            pick = vc.rows_per_block
            for r in (1, 2, 4):
                vc.rows_per_block = lambda *_, r=r: r
                try:
                    v[f"rows_per_block {r} ms"] = _ms(kk, args, a.iters, kw)
                finally:
                    vc.rows_per_block = pick
        if a.profile:
            v["profile"] = _profile(f"{a.label} {name}", kk, args, kw)
        record(name, **v)
    del seen["cellgrid"], seen["cells"]
    torch.cuda.empty_cache()
    top, traj = make_water_box(2048, n_frames=16, seed=5)
    heavy = np.concatenate([top.get_wat_inds("WAT")[0], top.get_sol_inds("WAT")[0]])
    small = _captured(vt, "voronoi_window_topk", lambda: vd.voronoi_volumes_hybrid_frames(
        traj.positions[:, heavy], traj.boxes[:, 0].astype(np.float64), 2048, device="cuda"))
    launches = dict(zip("abcd", seen["window"] + small))
    for tag in "ad":
        for nf in (1, 2, 4, 8):
            launches[f"{tag}, first {nf} frames"] = _first(launches[tag], nf)
    no_stop = None
    if a.mappings:
        with tempfile.TemporaryDirectory() as tmp:  # a loaded library outlives its file
            no_stop = _swapped(build, "voronoi_topk", NO_STOP, tmp)
    for tag, args in launches.items():
        cs, exts, _, k, _, win = args
        want = vt.voronoi_window_topk_plain(*args)
        v = {"shape": f"{cs.shape[0]} frames x {cs.shape[1]} rows x win {win} of "
                      f"{exts.shape[1]}, k {k}",
             "equal": _same(wk(*args), want), "ms": _ms(wk, args, a.iters)}
        if a.mappings and hasattr(vt, "_window_split"):
            pick = vt._window_split
            try:
                for split in getattr(vt, "WINDOW_SPLITS", (1, 2, 4, 8)):
                    vt._window_split = lambda _, s=split: s
                    v[f"split {split} equal"] = _same(wk(*args), want)
                    v[f"split {split} ms"] = _ms(wk, args, a.iters)
            finally:
                vt._window_split = pick
        if no_stop is not None and len(tag) == 1:
            real = build._LOADED["voronoi_topk"]
            build._LOADED["voronoi_topk"] = no_stop
            try:
                v["no stop equal"] = _same(wk(*args), want)
                v["no stop ms"] = _ms(wk, args, a.iters)
            finally:
                build._LOADED["voronoi_topk"] = real
        if a.profile:
            v["profile"] = _profile(f"{a.label} window launch ({tag})", wk, args)
        record(f"window launch ({tag})", **v)
        del want


def _same(got, want):
    import torch

    return all(torch.equal(g, w) for g, w in zip(got, want))


def _swapped(build, source, swaps, tmp):
    """csrc/<source>.cu built in the directory `tmp` with each (old, new)
    of `swaps` replaced (the checkout's flags), loaded; None where the
    source lacks one of them."""
    text = (build.CSRC / f"{source}.cu").read_text()
    if not all(old in text for old, _ in swaps):
        return None
    for old, new in swaps:
        text = text.replace(old, new)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, tmp)
    src, out = (os.path.join(tmp, f"{name}{source}_swapped{ext}")
                for name, ext in (("", ".cu"), ("lib", ".so")))
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(out)


def _variants(build, source, line, values, tmp):
    """{value: loaded library} of csrc/<source>.cu built in the directory
    `tmp` with `line`'s constant set to each value (the checkout's flags,
    one nvcc each, all started together), or {} where the source has no
    such line."""
    text = (build.CSRC / f"{source}.cu").read_text()
    default = next((v for v in values if line.format(v) in text), None)
    if default is None:
        return {}
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, tmp)
    jobs = {}
    for v in values:
        src = os.path.join(tmp, f"{source}_{v}.cu")
        with open(src, "w") as f:
            f.write(text.replace(line.format(default), line.format(v)))
        out = os.path.join(tmp, f"lib{source}_{v}.so")
        jobs[v] = (out, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True))
    libs = {}
    for v, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} with {line.format(v)}:\n{err}")
        for text_line in err.splitlines():
            if "registers" in text_line or "spill" in text_line:
                print(f"[ptxas] {line.format(v)} {source}: {text_line.strip()}", flush=True)
        libs[v] = ctypes.CDLL(out)
    return libs


def _shapes(build, key, fn, args, want, a):
    """{f"{constant} ms": ..., f"{constant} equal": ...} of `fn` on `args`
    with each block shape of SHAPES[key] loaded in turn."""
    import torch

    source, line, values = SHAPES[key]
    real = build._LOADED.get(source)
    v_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for v, lib in _variants(build, source, line, values, tmp).items():
                build._LOADED[source] = lib
                got = fn(*args)
                tag = line.split("=")[0].split()[-1] + f" {v}"
                v_out[f"{tag} equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
                v_out[f"{tag} ms"] = _ms(fn, args, a.iters)
        finally:
            if real is None:
                build._LOADED.pop(source, None)
            else:
                build._LOADED[source] = real
    return v_out


def _captured(module, name, fn):
    """Run fn; the arguments of every launch it made of module.<name> (each
    launch runs as usual, counted by the wrapper)."""
    real, seen = getattr(module, name), []

    def record(*args):
        seen.append(args)
        return real(*args)

    setattr(module, name, record)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return seen


def _first(args, nf):
    """The launch's arguments cut to its first nf frames."""
    import torch

    return tuple(x[:nf].contiguous() if torch.is_tensor(x) and x.dim() >= 2 else x
                 for x in args)


def _hbond(a, build, record):
    import torch
    from waterorderlib_tpu_torch.drivers import hbonds_driver
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import hbond

    with tempfile.TemporaryDirectory() as d:
        top, traj = make_water_box(4096, n_frames=1024, seed=0,
                                   solute_elements=["C", "O", "H", "N", "H", "C"])
        dense = _captured(hbond, "hbond_dense",
                          lambda: hbonds_driver.hb_calc(top, traj, output_dir=d, device="cuda"))
        top, traj = make_water_box(16384, n_frames=64, seed=0)
        slab = _captured(hbond, "hbond_slab",
                         lambda: hbonds_driver.hb_calc(top, traj, output_dir=d, device="cuda"))
    del top, traj
    ww = max(dense, key=lambda args: args[0].shape[2] * args[1].shape[2])  # water-water
    for name, fn, plain, args in (("hbond_dense", hbond.hbond_dense, hbond.hbond_dense_plain, ww),
                                  ("hbond_slab", hbond.hbond_slab, hbond.hbond_slab_plain,
                                   slab[0])):
        sub = _first(args, 4)
        got, want = fn(*sub), plain(*sub)
        v = {"shape": f"{args[0].shape[2]} acceptors x {args[1].shape[2]} donor columns"
                      + (f", w {args[6]}" if name == "hbond_slab" else "")
                      + f" x {args[0].shape[0]} frames",
             "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
             "ms": _ms(fn, args, a.iters)}
        if a.mappings:
            v.update(_shapes(build, "hbond", fn, args, fn(*args), a))
        if a.profile:
            v["profile"] = _profile(f"{a.label} {name}", fn, args)
        record(name, **v)
        del got, want, sub


def _lsi(a, build, record):
    import torch
    from waterorderlib_tpu_torch.drivers import orderparams
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import lsi

    top, traj = make_water_box(4096, n_frames=1024, seed=0)
    with tempfile.TemporaryDirectory() as d:
        seen = _captured(lsi, "lsi_window",
                         lambda: orderparams.lsi_calc(top, traj, output_dir=d, device="cuda"))
    del top, traj
    args = seen[0]
    sub = _first(args, 16)
    got, want = lsi.lsi_window(*sub), lsi.lsi_window_plain(*sub)
    v = {"shape": f"{args[0].shape[2]} rows, w {args[4]} x {args[0].shape[0]} frames",
         "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
         "ms": _ms(lsi.lsi_window, args, a.iters)}
    if a.mappings:
        v.update(_shapes(build, "lsi", lsi.lsi_window, args, lsi.lsi_window(*args), a))
    if a.profile:
        v["profile"] = _profile(f"{a.label} lsi_window", lsi.lsi_window, args)
    record("lsi_window", **v)


def _ladder_cut_ms(build, fn, args, a):
    """ms of `fn` with the checkout's q kernel built without its serial
    ladder (the serial kernel; the shell count stays, q is wrong), or None for a
    kernel without it."""
    text = (build.CSRC / "qtet_window.cu").read_text()
    if LADDER[0] not in text:
        return None
    i, j = text.index(LADDER[0]), text.index(LADDER[1]) + len(LADDER[1])
    real = build._LOADED.get("qtet_window")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "qtet_window_cut.cu"), os.path.join(tmp, "libcut.so")
        with open(src, "w") as f:
            f.write(text[:i] + "      d3 = fminf(d3, dsq);\n" + text[j:])
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src], check=True,
                       capture_output=True)
        build._LOADED["qtet_window"] = ctypes.CDLL(out)
        try:
            return _ms(fn, args, a.iters)
        finally:
            build._LOADED["qtet_window"] = real


def _stage_ms(drive, calls=3, stage="kernel stage"):
    """The driver's step `stage` on its own stage clock, ms, in each of
    `calls` warm calls."""
    from waterorderlib_tpu_torch.core.clock import stage_times

    out = []
    for _ in range(calls):
        with stage_times() as t:
            drive()
        out.append(t[stage])
    return out


def _qtet(a, build, record):
    import torch
    from chip_smoke import _lattice_traj
    from waterorderlib_tpu_torch.drivers import orderparams
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import qtet2, qtet_kernel

    top, traj = make_water_box(4096, n_frames=1024, seed=0)
    with tempfile.TemporaryDirectory() as d:
        seen = _captured(qtet2, "q_window",
                         lambda: orderparams.tet_order_calc(top, traj, output_dir=d, device="cuda"))
        record("tet_order_calc kernel stage", ms=_stage_ms(
            lambda: orderparams.tet_order_calc(top, traj, output_dir=d, device="cuda")))
    del top, traj
    pos, boxes = (torch.from_numpy(x).to("cuda") for x in _lattice_traj(4096, 1, seed=1))
    dense = _captured(qtet2, "q_window_hist",
                      lambda: qtet_kernel.order_param_q_dense(pos[0], boxes[0]))
    for name, fn, plain, args, nf in (
            ("q_window", qtet2.q_window, qtet2.q_window_plain, seen[0], 16),
            ("q_window_hist", qtet2.q_window_hist, qtet2.q_window_hist_plain, dense[0], 1)):
        sub = _first(args, nf)
        got, want = fn(*sub), plain(*sub)
        v = {"shape": f"{args[0].shape[2]} rows, w {args[4]} x {args[0].shape[0]} frames",
             "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
             "ms": _ms(fn, args, a.iters)}
        if a.mappings:
            full = fn(*args)
            for key in ("qtet", "qtet_lane", "qtet_form"):
                v.update(_shapes(build, key, fn, args, full, a))
            cut = _ladder_cut_ms(build, fn, args, a)
            if cut is not None:
                v["ladder cut out ms"] = cut
        if a.profile:
            v["profile"] = _profile(f"{a.label} {name}", fn, args)
        record(name, **v)
    for n in (131_072, 1_048_576):
        pos, boxes = (torch.from_numpy(x).to("cuda") for x in _lattice_traj(n, 1, seed=n % 997))
        args = _captured(qtet2, "q_window",
                         lambda: qtet2.order_param_q_certified(pos, boxes))[0]
        _record_large(a, record, f"q_window {n} atoms", qtet2.q_window, qtet2.q_window_plain,
                      args, ((0,), (2,)))
        del pos, boxes, args
        torch.cuda.empty_cache()


def _record_large(a, record, key, fn, plain, args, cut_at):
    """A one-frame launch at scale: equal to the plain version on its first
    and last row tiles (chip_smoke.py's `_two_tiles`), then timed."""
    import torch
    from chip_smoke import _two_tiles

    rows, rt = args[0], args[5]
    n = rows.shape[2]
    sub, _ = _two_tiles(args, -(-n // rt), n, rt, cut_at)
    got, want = fn(*sub), plain(*sub)
    record(key, shape=f"{n} rows, w {args[4]}", ms=_ms(fn, args, a.iters),
           equal=all(torch.equal(g, w) for g, w in zip(got, want)))


def _lsi_split(a, build, record):
    import torch
    from chip_smoke import _split_traj
    from waterorderlib_tpu_torch.drivers import orderparams
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.io.trajectory import Trajectory
    from waterorderlib_tpu_torch.ops.cuda import lsi

    n, nf = 16384, 64
    top, traj = make_water_box(n, n_frames=nf, seed=0)
    ox, _ = _split_traj(n, nf, seed=0)
    waters = traj.positions.reshape(nf, n, 3, 3)
    traj = Trajectory((waters - waters[:, :, :1] + ox[:, :, None]).reshape(nf, 3 * n, 3),
                      traj.boxes)
    with tempfile.TemporaryDirectory() as d:
        seen = _captured(lsi, "lsi_split_window",
                         lambda: orderparams.lsi_calc(top, traj, output_dir=d, device="cuda"))
        record("lsi_calc split-tier kernel stage", ms=_stage_ms(
            lambda: orderparams.lsi_calc(top, traj, output_dir=d, device="cuda")))
    del top, traj
    args = seen[0]
    sub = _first(args, 4)
    got, want = lsi.lsi_split_window(*sub), lsi.lsi_split_window_plain(*sub)
    v = {"shape": f"{args[0].shape[2]} rows, w {args[4]} / {args[9]} x {args[0].shape[0]} frames",
         "equal": all(torch.equal(g, w) for g, w in zip(got, want)),
         "ms": _ms(lsi.lsi_split_window, args, a.iters)}
    if a.mappings:
        v.update(_shapes(build, "lsi_split", lsi.lsi_split_window, args,
                         lsi.lsi_split_window(*args), a))
    if a.profile:
        v["profile"] = _profile(f"{a.label} lsi_split_window", lsi.lsi_split_window, args)
    record("lsi_split_window", **v)
    n = 131_072
    ox, boxes = (torch.from_numpy(x).to("cuda") for x in _split_traj(n, 1, seed=n % 997))
    args = _captured(lsi, "lsi_split_window", lambda: lsi.lsi_certified(ox, boxes))[0]
    _record_large(a, record, f"lsi_split_window {n} atoms", lsi.lsi_split_window,
                  lsi.lsi_split_window_plain, args, ((0, 6), (2, 8)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=".", help="the checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels", default="voronoi,hbond,lsi,qtet,lsi_split",
                    help="comma-separated groups: voronoi, hbond, lsi, qtet, lsi_split")
    ap.add_argument("--mappings", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="also each launch's device time by kernel name (torch.profiler)")
    a = ap.parse_args()
    repo = os.path.abspath(a.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: torch finds no CUDA device", file=sys.stderr)
        return 1
    import waterorderlib_tpu_torch
    from waterorderlib_tpu_torch.ops.cuda import build

    where = os.path.dirname(os.path.dirname(os.path.abspath(waterorderlib_tpu_torch.__file__)))
    if where != repo:
        raise SystemExit(f"imported the package from {where}, not {repo}")
    groups = a.kernels.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = {"voronoi": ["voronoi_topk", "voronoi_cells"], "hbond": ["hbond"],
               "lsi": ["lsi_window"], "qtet": ["qtet_window"], "lsi_split": ["lsi_window"]}
    build.build_all([src for g in groups for src in sources[g]])
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"[ptxas] {a.label} {name}: {line.strip()}", flush=True)
    out = {"label": a.label, "repo": repo, "card": card, "times": {}}

    def record(key, **v):
        out["times"][key] = v
        print(f"[ab] {a.label} {key}: {v}", flush=True)

    for g in groups:
        {"voronoi": _voronoi, "hbond": _hbond, "lsi": _lsi, "qtet": _qtet,
         "lsi_split": _lsi_split}[g](a, build, record)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
