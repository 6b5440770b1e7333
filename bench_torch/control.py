#!/usr/bin/env python3
"""The output check's control, at a cell's own size.

    python3 bench_torch/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's pool of frames as a run does, takes the
first call a run would make, and compares the plain reference computed
in the control's precision (TF32, the nearest below the configurations'
float32) with the reference itself, by the cell's own check. Each number
is printed beside the cell's limit; the control has to exceed at least one.
The program is not run. Prints one JSON line per seed."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_torch.core import spec  # noqa: E402
from bench_torch.run import Run  # noqa: E402


def control_readings(cell: dict, seed: int, device) -> dict:
    """The check's numbers for the control on the first call a run with
    this seed would make."""
    run = Run(cell, seed, 0.0, False, device, bench={})
    run.make_pool()
    rec = run.next_record()
    ref = run.check.reference_answers(rec, "float64")
    ctl = run.check.reference_answers(rec, "tf32")
    return run.check.compare(ctl, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        got = control_readings(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "fails": [k for k, v in got.items() if v > cell["limits"][k]],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
