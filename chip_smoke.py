#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
1. the card's name and power limit, and the build of every CUDA kernel on
   the path from the sources in this checkout;
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes (4096 waters, 8 frames): the slab form, the brute form, the
   straggler patch, and a sparse 512-atom box that must take the brute tier;
3. the slice: `tet_order_calc` on a 4096-water, 1024-frame box with one
   sub-population, device="cuda"; it must take the slab tier, launch the
   kernel and never call the plain version; its q on 16 frames must match
   the plain PyTorch q path. Prints the q stage's frames/s, the driver's
   wall time, and the kernel's and plain version's ms per frame at the
   slice's launch shape.

The last line is one JSON object, {"ok": true, "device": {...}}; before it
come a JSON line of the kernels' launches in the slice, largest error and
times ("ms", "plain_ms": per frame), and the card's name and power
limit. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_WATERS = 4096
N_FRAMES_CMP = 8
N_FRAMES_SLICE = 1024
TOL = 1e-5  # float32 q; kernel and plain version do the same operations
# modules of the JAX package that import no jax, which the port reuses
JAX_FREE = {"io", "stats", "utils", "constants"}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _lattice_traj(n, f, seed):
    """bench.py-style jittered lattice: frames of a 4096-water box, f32."""
    import numpy as np
    from waterorderlib_tpu.io.synthetic import water_oxygen_lattice

    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    pos = np.stack(
        [np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len) for _ in range(f)]
    ).astype(np.float32)
    boxes = np.tile(np.array([box_len] * 3, np.float32), (f, 1))
    return pos, boxes


def _ms(fn, args, iters):
    import torch

    fn(*args)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _compare(name, args, qtet2):
    """Kernel vs plain version on the same inputs; returns max|dq|."""
    import torch

    qk, okk = qtet2.q_window(*args)
    qp, okp = qtet2.q_window_plain(*args)
    torch.cuda.synchronize()
    err = float((qk - qp).abs().max())
    mism = int((okk != okp).sum())
    print(f"[kernel] {name}: max|dq|={err:.3e} ok_mismatches={mism}", flush=True)
    _check(bool(torch.isfinite(qk).all()), f"{name}: kernel q not finite")
    _check(err <= TOL, f"{name}: max|dq| {err} > {TOL}")
    _check(mism == 0, f"{name}: {mism} ok mismatches")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import waterorderlib_tpu_torch
    from waterorderlib_tpu.io.synthetic import make_water_box
    from waterorderlib_tpu_torch.drivers import orderparams
    from waterorderlib_tpu_torch.ops import pairs
    from waterorderlib_tpu_torch.ops.cuda import build, qtet2, slab
    from waterorderlib_tpu_torch.order import qtet

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(waterorderlib_tpu_torch.__file__)))
    _check(pkg_dir == REPO, f"the port was imported from {pkg_dir}, not this checkout")

    # 1. the card and the build
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    t0 = time.perf_counter()
    build.load("qtet_window")
    print(f"[build] qtet_window.cu built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    dev = torch.device("cuda")

    # 2. kernel against plain version, at the main path's shapes
    pos_np, boxes_np = _lattice_traj(N_WATERS, N_FRAMES_CMP, seed=0)
    pos, boxes = torch.from_numpy(pos_np).to(dev), torch.from_numpy(boxes_np).to(dev)
    n, box_l, rt = N_WATERS, float(boxes_np[0, 2]), 256
    window = qtet2.suggest_window(n, box_l, margin=4.5, row_tile=rt)
    pad = slab.suggest_pad(n, box_l, 4.5 + 2.0)
    prep = slab.slab_prep_traj(pos, boxes, 4.5, rt, window, pad)
    _check(bool(prep.covered.all()), "slab prep not covered")
    slab_args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts, boxes, prep.w, rt,
                 0.0, 100.0, 4.5 * 4.5)
    err_slab = _compare(f"slab form (w={prep.w})", slab_args, qtet2)
    ext = torch.remainder(pos, boxes[:, None, :]).transpose(1, 2).contiguous()
    starts0 = torch.zeros(-(-n // rt), dtype=torch.int32, device=dev)
    brute_args = (ext, ext, starts0, boxes, n, rt, 0.0, 100.0, 100.0)
    err_brute = _compare("brute form", brute_args, qtet2)
    q_brute_plain, _ = qtet2.q_window_plain(*brute_args)

    # straggler patch: a margin just under the 3 largest 4th-neighbor
    # distances leaves 3 uncertified rows, patched by the brute form
    d4 = torch.cat([pairs.topk_neighbors(pos[f], pos[f], boxes[f], 4, 0.0, 10.0).dist[:, 3]
                    for f in range(N_FRAMES_CMP)])
    top4 = torch.sort(d4).values[-4:-2]
    margin = float(top4.mean())
    before = qtet2.q_window.launches
    q_cert = qtet2.order_param_q_certified(pos, boxes, 0.0, 10.0, margin=margin)
    patched = qtet2.q_window.launches - before - 1
    err_patch = float((q_cert - q_brute_plain).abs().max())
    print(f"[kernel] straggler patch: margin={margin:.4f} tier={qtet2.last_tier} "
          f"patch launches={patched} max|dq| vs plain brute={err_patch:.3e}", flush=True)
    _check(qtet2.last_tier == "slab" and patched >= 1, "straggler patch did not run")
    _check(err_patch <= TOL, f"straggler patch: max|dq| {err_patch} > {TOL}")

    rs = np.random.RandomState(13)
    sp_pos = torch.as_tensor(rs.uniform(0, 200.0, (2, 512, 3)), dtype=torch.float32, device=dev)
    sp_boxes = torch.full((2, 3), 200.0, device=dev)
    q_sp = qtet2.order_param_q_certified(sp_pos, sp_boxes, 0.0, 50.0)
    sp_ext = torch.remainder(sp_pos, sp_boxes[:, None, :]).transpose(1, 2).contiguous()
    q_sp_plain, _ = qtet2.q_window_plain(
        sp_ext, sp_ext, torch.zeros(2, dtype=torch.int32, device=dev), sp_boxes, 512, rt,
        0.0, 2500.0, 2500.0,
    )
    err_sparse = float((q_sp - q_sp_plain).abs().max())
    print(f"[kernel] sparse 512-atom box: tier={qtet2.last_tier} max|dq|={err_sparse:.3e}",
          flush=True)
    _check(qtet2.last_tier == "brute", "sparse box did not take the brute tier")
    _check(err_sparse <= TOL, f"sparse box: max|dq| {err_sparse} > {TOL}")

    # 3. the slice, through the user's entry point
    top, traj = make_water_box(N_WATERS, n_frames=N_FRAMES_SLICE, seed=0)
    wat_inds, _, _ = top.get_wat_inds()
    sub_inds = [[wat_inds[::2]] for _ in range(N_FRAMES_SLICE)]
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        qtet2.q_window.launches = 0
        qtet2.q_window_plain.calls = 0
        t0 = time.perf_counter()
        avg_q, var_q = orderparams.tet_order_calc(
            top, traj, sub_inds=sub_inds, n_pops=1, output_dir=out_dir, device="cuda"
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = qtet2.q_window.launches, qtet2.q_window_plain.calls
        tier = qtet2.last_tier
        hists = [np.loadtxt(os.path.join(out_dir, f"qDistribution_{j}.txt")) for j in (0, 1)]
    print(f"[slice] tet_order_calc {N_WATERS} waters x {N_FRAMES_SLICE} frames: tier={tier} "
          f"q_window launches={launches} plain calls={plain_calls} wall={wall:.3f} s "
          f"avgQ={avg_q[0].tolist()} varQ={var_q[0].tolist()}", flush=True)
    _check(tier == "slab", f"slice took tier {tier}, not slab")
    _check(launches > 0, "the slice never launched the kernel")
    _check(plain_calls == 0, "the slice called the plain version")
    _check(all(h.shape == (500, 2) for h in hists), "qDistribution files are not (500, 2)")
    _check(int(hists[0][:, 1].sum()) > 0, "empty q histogram")
    _check(all(np.all(np.isfinite(np.asarray(a))) for a in (*avg_q, *var_q)),
           "averages not finite")

    wat_pos = torch.as_tensor(traj.positions[:, wat_inds, :], dtype=torch.float32, device=dev)
    wat_boxes = torch.as_tensor(traj.boxes, dtype=torch.float32, device=dev)
    q_all = qtet2.order_param_q_certified(wat_pos, wat_boxes)  # warm-up
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        q_all = qtet2.order_param_q_certified(wat_pos, wat_boxes)
    torch.cuda.synchronize()
    fps = reps * N_FRAMES_SLICE / (time.perf_counter() - t0)
    q_ref = torch.stack([qtet.order_param_q(wat_pos[f], wat_pos[f], wat_boxes[f])
                         for f in range(16)])
    err_slice = float((q_all[:16] - q_ref).abs().max())
    print(f"[slice] q stage: {fps:.1f} frames/s ({N_WATERS} waters, F={N_FRAMES_SLICE}, "
          f"{card}); q of 16 frames vs plain PyTorch q: max|dq|={err_slice:.3e}", flush=True)
    _check(err_slice <= TOL, f"slice q: max|dq| {err_slice} > {TOL}")

    # the kernel's time at the slice's own launch (all 1024 frames in one
    # launch, slab form); the plain version on 64 of those frames, per frame
    box_z = float(wat_boxes[0, 2])
    window = qtet2.suggest_window(n, box_z)
    pad = slab.suggest_pad(n, box_z, 4.5 + 2.0)
    prep = slab.slab_prep_traj(wat_pos, wat_boxes, 4.5, rt, window, pad)
    main_args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts, wat_boxes,
                 prep.w, rt, 0.0, 100.0, 4.5 * 4.5)
    sub_args = (main_args[0][:64], prep.ext_t[:64], prep.starts, wat_boxes[:64], *main_args[4:])
    err_main = _compare("slab form, slice frames 0-63", sub_args, qtet2)
    ms = _ms(qtet2.q_window, main_args, 10) / N_FRAMES_SLICE
    plain_ms = _ms(qtet2.q_window_plain, sub_args, 2) / 64
    print(f"[time] slab form at the slice's launch (w={prep.w}): kernel {ms:.5f} ms/frame "
          f"(F={N_FRAMES_SLICE}), plain version {plain_ms:.5f} ms/frame (F=64); {card}",
          flush=True)

    # no jax: of the JAX package only its jax-free modules were imported
    _check("jax" not in sys.modules, "jax was imported")
    shared = sorted(m for m in sys.modules if m.startswith("waterorderlib_tpu."))
    _check(all(m.split(".")[1] in JAX_FREE for m in shared),
           f"imported JAX-package modules beyond the jax-free ones: {shared}")

    print(json.dumps({"kernels": [{
        "name": "qtet_window",
        "route": "cuda",
        "source": "waterorderlib_tpu_torch/ops/cuda/csrc/qtet_window.cu",
        "replaces": "waterorderlib_tpu/ops/pallas/qtet2.py:111",
        "launches": launches,
        "max_abs_err": max(err_slab, err_brute, err_patch, err_sparse, err_slice, err_main),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
