"""Command-line interface of the port (the subcommands ported so far).

    python -m waterorderlib_tpu_torch generate --waters 216 --frames 50 --out sys
    python -m waterorderlib_tpu_torch tet sys.json sys.npz --output-dir out/ --device cuda
    python -m waterorderlib_tpu_torch 3body sys.json sys.npz --output-dir out/
    python -m waterorderlib_tpu_torch psi sys.json sys.npz --output-dir out/
    python -m waterorderlib_tpu_torch lsi sys.json sys.npz --output-dir out/
    python -m waterorderlib_tpu_torch hb sys.json sys.npz --output-dir out/
    python -m waterorderlib_tpu_torch boundwrap sys.json sys.npz --cache bw.npz
    python -m waterorderlib_tpu_torch voronoi sys.json sys.npz --engine device
    python -m waterorderlib_tpu_torch contactarea sys.json sys.npz --engine device

Every analysis subcommand takes `--trace-out PATH`: the call is recorded
(`core.clock.stage_times`) and its spans and counters are written to PATH
as a Chrome trace (`core.clock.export_chrome`).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_common(p):
    p.add_argument("top", help="topology: .json, .npz (embedded), or AMBER .prmtop/.parm7/.top")
    p.add_argument("traj", help="trajectory: .npz, .dcd, AMBER NetCDF .nc, or AMBER ASCII .mdcrd/.crd")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--wat-res", default="WAT")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--chunk-frames", type=int, default=0,
                   help="stream the trajectory in chunks of this many frames "
                        "(larger-than-memory support; 0 = load whole)")
    p.add_argument("--mesh", default="", help="device mesh, e.g. 4x2 (not ported yet)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--trace-out", default="",
                   help="record the call and write its spans and counters to this path as a "
                        "Chrome trace (Perfetto, chrome://tracing)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="waterorderlib_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a synthetic water box system")
    g.add_argument("--waters", type=int, default=216)
    g.add_argument("--frames", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--solute", default="", help="comma-separated solute elements, e.g. C,C,O")
    g.add_argument("--out", default="system", help="basename for .json/.npz outputs")

    for name, helptext, extra in [
        ("tet", "tetrahedral order parameter q", [("--high-cut", float, 10.0)]),
        ("3body", "3-body angle distribution",
         [("--high-cut", float, 3.413), ("--max-neighbors", int, 16)]),
        ("psi", "hexagonal order parameter psi6", [("--high-cut", float, 7.0)]),
        ("lsi", "local structure index", [("--high-cut", float, 3.7)]),
        ("hb", "H-bonds per water and per cosolvent molecule",
         [("--dist-cut", float, 3.5), ("--ang-cut", float, 120.0)]),
        ("boundwrap", "bound/wrap/shell/non-shell waters per frame",
         [("--cutoff", float, 4.0), ("--cache", str, "")]),
        ("voronoi", "Voronoi volume, area and asphericity per water",
         [("--engine", str, "auto")]),
        ("contactarea", "the solute's Voronoi contact areas (phobic/philic/bound/wrap)",
         [("--cutoff", float, 4.0), ("--engine", str, "auto")]),
    ]:
        p = sub.add_parser(name, help=helptext)
        _add_common(p)
        for flag, typ, dflt in extra:
            p.add_argument(flag, type=typ, default=dflt)

    args = ap.parse_args(argv)

    if args.cmd == "generate":
        from waterorderlib_tpu_torch.io.synthetic import make_water_box

        sol = [s for s in args.solute.split(",") if s]
        top, traj = make_water_box(
            args.waters, n_frames=args.frames, seed=args.seed,
            solute_elements=sol or None,
        )
        top.to_json(args.out + ".json")
        traj.save(args.out + ".npz", topology=top)
        print(f"wrote {args.out}.json and {args.out}.npz "
              f"({traj.n_frames} frames, {traj.n_atoms} atoms)")
        return 0
    if not args.trace_out:
        return _analyse(args)

    from waterorderlib_tpu_torch.core import clock

    with clock.stage_times():
        rc = _analyse(args)
    n = clock.export_chrome(args.trace_out)
    print(f"wrote {n} spans to {args.trace_out}", file=sys.stderr)
    return rc


def _analyse(args) -> int:
    """Run the analysis subcommand `args.cmd` and print its JSON line."""
    if args.cmd == "hb":
        from waterorderlib_tpu_torch.drivers.hbonds_driver import hb_calc

        avg_wat, avg_sol = hb_calc(
            args.top, args.traj, wat_res=args.wat_res, stride=args.stride,
            dist_cut=args.dist_cut, ang_cut=args.ang_cut, output_dir=args.output_dir,
            chunk_frames=args.chunk_frames or None, mesh=args.mesh or None, device=args.device,
        )
        print(json.dumps({"avgWatHBs": avg_wat, "avgSolHBs": avg_sol}))
        return 0
    if args.cmd == "boundwrap":
        from waterorderlib_tpu_torch.drivers.hbonds_driver import get_bound_wrap

        res = get_bound_wrap(args.top, args.traj, wat_res=args.wat_res, cutoff=args.cutoff,
                             device=args.device)
        if args.cache:
            np.savez_compressed(
                args.cache,
                **{f"frame{t}_{k}": np.asarray(v) for t, frame in enumerate(res)
                   for k, v in zip(("bound", "wrap", "shell", "nonshell"), frame)},
            )
        print(json.dumps({"sizes_per_frame": [[len(x) for x in frame] for frame in res]}))
        return 0

    if args.cmd == "voronoi":
        from waterorderlib_tpu_torch.drivers.voronoi_driver import voronoi_calc

        avg_v, var_v, avg_a, var_a, avg_e, var_e = voronoi_calc(
            args.top, args.traj, wat_res=args.wat_res, stride=args.stride,
            output_dir=args.output_dir, engine=args.engine,
            chunk_frames=args.chunk_frames or None, mesh=args.mesh or None, device=args.device,
        )
        print(json.dumps({"avgVol": avg_v[0].tolist(), "avgArea": avg_a[0].tolist(),
                          "avgEta": avg_e[0].tolist()}))
        return 0

    if args.cmd == "contactarea":
        from waterorderlib_tpu_torch.drivers.voronoi_driver import contact_area_calc

        tot, tot_ci, frac, frac_ci = contact_area_calc(
            args.top, args.traj, wat_res=args.wat_res, stride=args.stride, cutoff=args.cutoff,
            engine=args.engine, chunk_frames=args.chunk_frames or None, mesh=args.mesh or None,
            device=args.device,
        )
        print(json.dumps({"totArea": tot, "fracArea": frac}))
        return 0

    from waterorderlib_tpu_torch.drivers import orderparams

    common = dict(stride=args.stride, output_dir=args.output_dir, device=args.device,
                  high_cut=args.high_cut, chunk_frames=args.chunk_frames or None,
                  mesh=args.mesh or None)
    if args.cmd == "tet":
        avg_q, var_q = orderparams.tet_order_calc(
            args.top, args.traj, wat_res=args.wat_res, **common
        )
        print(json.dumps({"avgQ": avg_q[0].tolist(), "avgQ_CI": avg_q[1].tolist(),
                          "varQ": var_q[0].tolist()}))
    elif args.cmd == "3body":
        p_tet, avg_cos, var_cos, entropy, n_wats = orderparams.three_body_calc(
            args.top, args.traj, wat_res=args.wat_res, max_neighbors=args.max_neighbors,
            **common,
        )
        print(json.dumps({"pTet": p_tet[0].tolist(), "entropy": entropy[0].tolist()}))
    elif args.cmd == "lsi":
        avg_lsi, var_lsi = orderparams.lsi_calc(
            args.top, args.traj, wat_res=args.wat_res, **common
        )
        print(json.dumps({"avgLSI": avg_lsi[0].tolist(), "varLSI": var_lsi[0].tolist()}))
    else:
        avg_psi, var_psi = orderparams.hex_order_calc(
            args.top, args.traj, end_res=args.wat_res, **common
        )
        print(json.dumps({"avgPsi": avg_psi[0].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
