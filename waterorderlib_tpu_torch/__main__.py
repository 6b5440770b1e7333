"""Command-line interface of the port (the subcommands ported so far).

    python -m waterorderlib_tpu_torch generate --waters 216 --frames 50 --out sys
    python -m waterorderlib_tpu_torch tet sys.json sys.npz --output-dir out/ --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="waterorderlib_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a synthetic water box system")
    g.add_argument("--waters", type=int, default=216)
    g.add_argument("--frames", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--solute", default="", help="comma-separated solute elements, e.g. C,C,O")
    g.add_argument("--out", default="system", help="basename for .json/.npz outputs")

    p = sub.add_parser("tet", help="tetrahedral order parameter q")
    p.add_argument("top", help="topology: .json, .npz (embedded), or AMBER .prmtop/.parm7/.top")
    p.add_argument("traj", help="trajectory: .npz, .dcd, AMBER NetCDF .nc, or AMBER ASCII .mdcrd/.crd")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--wat-res", default="WAT")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--chunk-frames", type=int, default=0,
                   help="stream the trajectory in chunks of this many frames "
                        "(larger-than-memory support; 0 = load whole)")
    p.add_argument("--mesh", default="", help="device mesh, e.g. 4x2 (not ported yet)")
    p.add_argument("--high-cut", type=float, default=10.0)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")

    args = ap.parse_args(argv)

    if args.cmd == "generate":
        from waterorderlib_tpu.io.synthetic import make_water_box

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

    from waterorderlib_tpu_torch.drivers.orderparams import tet_order_calc

    avg_q, var_q = tet_order_calc(
        args.top, args.traj, stride=args.stride, output_dir=args.output_dir,
        wat_res=args.wat_res, high_cut=args.high_cut, device=args.device,
        chunk_frames=args.chunk_frames or None, mesh=args.mesh or None,
    )
    print(json.dumps({"avgQ": avg_q[0].tolist(), "avgQ_CI": avg_q[1].tolist(),
                      "varQ": var_q[0].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
