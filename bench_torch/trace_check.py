#!/usr/bin/env python3
"""The program's tracer held against the harness's own clocks, on the card,
in one cell.

    python3 bench_torch/trace_check.py --workload spc4096.tet --seed 7 \\
        [--calls 3] [--seconds 20] [--rounds 2] [--repo PATH]

Sets the cell up as run.py does (`--repo`: the checkout whose harness and
program to run, default this one), then:

1. clocks: profiles `--calls` calls with torch.profiler while the program
   records them, the dispatch entry point inside the harness's
   `bench.dispatch` range. For the `bench.dispatch` ranges and the
   program's `wol.dispatch:*` ranges, the kernels launched in them and
   their device time (attributed by correlation id, as core/trace.py
   does); for the program's `wol.h2d` ranges, the device time of the HtoD
   copies launched in them against the CUDA-event time of the recorded
   `h2d` spans;
2. cost: `--rounds` pairs of windows of `--seconds` each, untraced and
   inside the program's `stage_times()`, frames/s of each;
3. split: over the traced windows' recorded calls, the cell's
   `host_prep_ms` stages against the `topology` spans' self time, the
   `device_gather` spans (the order-parameter drivers' gather of center
   rows on the card), the `h2d` spans and the self time of the masks
   stage.

Parts 1 and 3 report nothing on a program without the tracer. The last line
of standard output is one JSON object."""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path


def _device_in(events, prefix):
    """{range name: [kernels, device ms, HtoD copy ms]} of the device
    operations launched inside the ranges whose name starts with prefix."""
    from bench_torch.core.trace import DEVICE_CATS, RUNTIME_CATS

    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    out = defaultdict(lambda: [0, 0.0, 0.0])
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        names = {n for a, b, n in ranges if ts is not None and a <= ts <= b}
        for n in names:
            out[n][0] += e["cat"] == "kernel"
            out[n][1] += e["dur"] * 1e-3
            out[n][2] += e["dur"] * 1e-3 if "HtoD" in e["name"] else 0.0
    return dict(out)


def clocks(run, n_calls):
    import torch

    from bench_torch.run import CallRecord
    from waterorderlib_tpu_torch.core import clock

    if not hasattr(clock, "recorded_calls"):
        return None
    draw = getattr(run, "draw_offset", None) or (  # a harness without file sources lacks it
        lambda: int(run.offset_rng.integers(0, run.boxes.shape[0] - run.frames_per_call + 1)))
    recs = [CallRecord(run, -2 - i, draw()) for i in range(n_calls)]
    clock.recorded_calls()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    run.profiling = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with clock.stage_times():
                for rec in recs:
                    with torch.profiler.record_function("bench.call"):
                        run.call(rec)
            torch.cuda.synchronize()
    finally:
        run.profiling = False
    calls = clock.recorded_calls()
    path = os.path.join(tempfile.mkdtemp(prefix="trace_check_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    bench = _device_in(events, "bench.dispatch")
    wol = _device_in(events, "wol.dispatch:")
    h2d = _device_in(events, "wol.h2d").get("wol.h2d", [0, 0.0, 0.0])
    h2d_spans = [s for c in calls for s in c.named("h2d")]
    return {
        "calls": len(calls),
        "bench.dispatch": {"kernels": sum(v[0] for v in bench.values()),
                           "device_ms": sum(v[1] for v in bench.values())},
        "wol.dispatch": {n: {"kernels": v[0], "device_ms": v[1]} for n, v in wol.items()},
        "h2d": {"spans": len(h2d_spans),
                "bytes": sum(s.counts.get("h2d_bytes", 0) for s in h2d_spans),
                "event_ms": sum(s.device_ms or 0.0 for s in h2d_spans),
                "profiler_htod_ms": h2d[2]},
    }


def cost(run, seconds, rounds):
    from bench_torch.core.window import frames_per_s

    out = {"untraced": [], "traced": []}
    run.seconds = seconds
    for _ in range(rounds):
        for key in ("untraced", "traced"):
            run.window = []
            run.run_window(stage_clock=key == "traced")
            out[key].append(frames_per_s(run.window))
    return out


def split(run, calls):
    if calls is None:
        return None
    prep = run.cell["layers"]["host_prep_ms"]
    rows = []
    for st, c in zip(run.stage_calls, calls):
        host = sum(st.get(n, 0.0) for n in prep)
        topo = sum(c.self_ms(s) for s in c.named("topology"))
        gather = sum(s.ms for s in c.named("device_gather"))
        h2d = sum(s.ms for s in c.named("h2d") if _stage_of(c, s) in prep)
        masks = sum(c.self_ms(s) for s in c.named("stage:masks (host + H2D)"))
        rows.append((host, topo, gather, h2d, masks))
    n = len(rows)
    mean = [sum(r[i] for r in rows) / n for i in range(5)]
    return {"calls": n, "host_prep_ms": mean[0], "topology_ms": mean[1], "device_gather_ms": mean[2],
            "h2d_ms": mean[3], "masks_self_ms": mean[4],
            "share": sum(mean[1:]) / mean[0] if mean[0] else None}


def _stage_of(call, span):
    """The name of the stage that holds `span`, or None."""
    by_id = {s.id: s for s in call.spans}
    p = by_id.get(span.parent)
    while p is not None and not p.name.startswith("stage:"):
        p = by_id.get(p.parent)
    return p.name[6:] if p is not None else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.repo))
    os.chdir(a.repo)
    import torch

    from bench_torch.core import peaks, spec
    from bench_torch.run import Run
    from waterorderlib_tpu_torch.core import clock

    if not torch.cuda.is_available():
        print("trace_check needs a CUDA device", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    run = Run(spec.cell(a.workload), a.seed, a.seconds, False, "cuda")
    try:
        run.setup()
        res = {"workload": a.workload, "seed": a.seed, "repo": a.repo,
               "card": peaks.card_power(), "setup_s": time.perf_counter() - t0,
               "clocks": clocks(run, a.calls)}
        take = getattr(clock, "recorded_calls", None)
        if take:
            take()
        res["cost"] = cost(run, a.seconds, a.rounds)
        res["split"] = split(run, take() if take else None)
    finally:
        run.restore()
        shutil.rmtree(getattr(run, "out_root", ""), ignore_errors=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
