#!/usr/bin/env python3
"""Planted faults at a cell's own size, on the card.

    python3 bench_torch/faults.py --workload <cell> --fault <fault> \\
        [--tier <tier>] --seeds <n> [<n> ...] [--seconds 6]

Runs the cell as run.py does, one run a seed in this process, with the
fault planted (core/faults.py): `answer_altered` or `half_the_batch` at
the check's `FAULT_AT`, or with `--tier` at the launch of that tier of its
`TIER_FAULTS` (the tier the cell takes on the card where the tiny CPU cell
takes another); `y_record_from_x` or `box_b_from_gamma` in the program's
DCD reader. Prints one JSON line a seed: whether the run came out correct,
which it must not, and each number compared."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_torch.core import faults, spec  # noqa: E402
from bench_torch.run import Run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(faults.AT_POINT)
                    + sorted(faults.IN_READER))
    ap.add_argument("--tier", default="")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    at = faults.points(spec.check_module(cell["check"]))[args.tier]["at"]
    for seed in args.seeds:
        t = time.perf_counter()
        planted = faults.plant(args.fault, at)
        try:
            res = Run(cell, seed, args.seconds, False, "cuda").execute()
            rec = {"correct": res["correct"], "attempted": res["attempted"],
                   "checks": {k: c["value"] for k, c in res["checks"].items()}}
        except Exception as e:  # a run that crashes has failed too
            rec = {"correct": False, "error": repr(e)[:500]}
        finally:
            faults.undo(planted)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "tier": args.tier,
                          "at": ":".join(at) if args.fault in faults.AT_POINT else
                          "streaming:LazyDCD.read", "seed": seed, **rec,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
