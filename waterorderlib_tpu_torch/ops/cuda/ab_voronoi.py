"""Time kernels of the device paths as one checkout of this repository builds
them, on the card, each at launches captured from its driver, so that two
checkouts can be compared on the same inputs in turns.

- `voronoi`: the two Voronoi kernels at the launches of one 16-frame chunk
  of `voronoi_calc`'s system (12,288 waters and a 6-atom solute, 12,294
  points): `voronoi_cellgrid_topk` at each tier's search launch (tier 1 and
  the escalation tiers, their arguments captured from
  `voronoi_volumes_hybrid_frames(cell_impl="pallas")`), and
  `voronoi_cells_fused` at that run's tier-1 launch (196,608 rows at (32,
  64)) and at (40, 96) on a 2,048-row subset.
- `hbond`: `hbond_dense` at the water-water launch of `hb_calc` on 4096
  waters and a 6-atom solute x 1024 frames, and `hbond_slab` at the launch
  of `hb_calc` on 16,384 waters x 64 frames.
- `lsi`: `lsi_window` at the launch of `lsi_calc` on 4096 waters x 1024
  frames.

Every launch is first compared with its plain version, exactly (the H-bond
and LSI launches on their first frames). Prints one JSON line: the label,
the card, and per launch the shape and the kernel's ms (CUDA events, warm,
the mean of `--iters` launches).

The wrappers keep their signatures across checkouts, so the same inputs go
to an older and a newer kernel. To compare two checkouts on one card, run
this file once for each, in turns, within one call:

    python3 waterorderlib_tpu_torch/ops/cuda/ab_voronoi.py --repo OLD --label old
    python3 waterorderlib_tpu_torch/ops/cuda/ab_voronoi.py --repo . --label new

(then new and old again); `--kernels hbond,lsi` picks the groups.
`--mappings` also times each cell-grid mapping (direct, and grouped at 8 to
64 rows a block) and each cell-kernel block size, where the checkout has
them, and each block shape of `hbond.cu` (acceptors a thread, kAcc 2, 4,
8 and 16) and of `lsi_window.cu` (rows a warp, kRowsPerWarp 1, 2, 4 and 8),
built from the checkout's sources with that one constant changed;
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
          "lsi": ("lsi_window", "constexpr int kRowsPerWarp = {};", (1, 2, 4, 8))}


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
    seen = {"cellgrid": [], "cells": []}
    ck, kk = vt.voronoi_cellgrid_topk, vc.voronoi_cells_fused

    def cap_ck(*args):
        seen["cellgrid"].append(args)
        return ck(*args)

    def cap_kk(*args, **kw):
        seen["cells"].append((args, kw))
        return kk(*args, **kw)

    # each wrapper counts its launches on the module's name for it
    cap_ck.launches = cap_kk.launches = 0
    vt.voronoi_cellgrid_topk, vc.voronoi_cells_fused = cap_ck, cap_kk
    try:
        vd.voronoi_volumes_hybrid_frames(pos, box, 12288, cell_impl="pallas", device="cuda")
    finally:
        vt.voronoi_cellgrid_topk, vc.voronoi_cells_fused = ck, kk
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
                tag = line.split()[2] + f" {v}"
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
    launch runs as usual; the wrapper counts it on the module's name)."""
    real, seen = getattr(module, name), []

    def record(*args):
        seen.append(args)
        return real(*args)

    record.launches = 0
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=".", help="the checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels", default="voronoi,hbond,lsi",
                    help="comma-separated groups: voronoi, hbond, lsi")
    ap.add_argument("--mappings", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="also each launch's device time by kernel name (torch.profiler)")
    a = ap.parse_args()
    repo = os.path.abspath(a.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("ab_voronoi: torch finds no CUDA device", file=sys.stderr)
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
               "lsi": ["lsi_window"]}
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
        {"voronoi": _voronoi, "hbond": _hbond, "lsi": _lsi}[g](a, build, record)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
