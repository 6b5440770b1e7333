"""Time the two Voronoi kernels of the device path as one checkout of this
repository builds them, on the card, at the launches of one 16-frame chunk
of `voronoi_calc`'s system (12,288 waters and a 6-atom solute, 12,294
points): `voronoi_cellgrid_topk` at each tier's search launch (tier 1 and
the escalation tiers, their arguments captured from
`voronoi_volumes_hybrid_frames(cell_impl="pallas")`), and
`voronoi_cells_fused` at that run's tier-1 launch (196,608 rows at (32, 64))
and at (40, 96) on a 2,048-row subset. Every launch is first compared with
its plain version, exactly. Prints one JSON line: the label, the card, and
per launch the shape and the kernel's ms (CUDA events, warm, the mean of
`--iters` launches).

Both wrappers keep their signatures across checkouts, so the same inputs go
to an older and a newer kernel. To compare two checkouts on one card, run
this file once for each, in turns, within one call:

    python3 waterorderlib_tpu_torch/ops/cuda/ab_voronoi.py --repo OLD --label old
    python3 waterorderlib_tpu_torch/ops/cuda/ab_voronoi.py --repo . --label new

(then new and old again). `--mappings` also times each cell-grid mapping
(direct, and grouped at 8 to 64 rows a block) and each cell-kernel block
size, where the checkout has them; `--profile` adds each call's device time by kernel name
(torch.profiler), the wrapper's own PyTorch work apart from the kernel.
Needs one CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=".", help="the checkout whose package is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mappings", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="also each launch's device time by kernel name (torch.profiler)")
    a = ap.parse_args()
    repo = os.path.abspath(a.repo)
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_voronoi: torch finds no CUDA device", file=sys.stderr)
        return 1
    import waterorderlib_tpu_torch
    from waterorderlib_tpu_torch.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.ops.cuda import build
    from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vc
    from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vt
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    where = os.path.dirname(os.path.dirname(os.path.abspath(waterorderlib_tpu_torch.__file__)))
    if where != repo:
        raise SystemExit(f"imported the package from {where}, not {repo}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(["voronoi_topk", "voronoi_cells"])
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"[ptxas] {a.label} {name}: {line.strip()}", flush=True)
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
    out = {"label": a.label, "repo": repo, "card": card, "times": {}}

    def record(key, **v):
        out["times"][key] = v
        print(f"[ab] {a.label} {key}: {v}", flush=True)

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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
