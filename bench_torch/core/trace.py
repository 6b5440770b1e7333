"""Reading a torch.profiler trace of a few calls.

The harness marks each call with a `bench.call` range, the dispatch entry
point with `bench.dispatch`, and each end of a program stage with an
instant range `bench.stage:<name>`. From the Chrome trace that
`export_chrome_trace` writes, `read` attributes every device operation
(kernel, copy, memset) to the host range that launched it, through the
runtime call that shares its correlation id, and takes:

- the device time and the kernel count inside the dispatch ranges, summed
  over every range (a call of a chunked driver holds one a chunk), and the
  number of ranges;
- the union of device intervals over the calls' span (busy time) and that
  span's length, from which the idle share follows;
- the device operations that took most time, by name;
- the idle time of the device, split by the program stage the host was in.

Kernel names are only reported, never used to select or attribute time."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class Profile(NamedTuple):
    dispatch_s: float           # device time of the operations launched in dispatch ranges
    dispatch_kernels: int       # kernels launched in dispatch ranges
    dispatch_ranges: int        # the dispatch ranges of the profiled calls
    busy_s: float               # union of device intervals within the calls' span
    window_s: float             # the span from the first call's start to the last one's end
    device_ops: list            # [[name, seconds], ...], most time first, at most 10
    idle_by_stage: list         # [[stage, seconds], ...], most idle first, at most 10

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _ranges(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def _inside(t, ranges) -> bool:
    return any(a <= t <= b for a, b in ranges)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(path: str) -> Profile:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls = _ranges(events, "bench.call")
    dispatch = _ranges(events, "bench.dispatch")
    if not calls:
        raise RuntimeError("the trace holds no bench.call range")
    t0, t1 = calls[0][0], calls[-1][1]

    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    dispatch_us, kernels = 0.0, 0
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
        ts = launched_at.get(e.get("args", {}).get("correlation"))
        if ts is not None and _inside(ts, dispatch):
            dispatch_us += e["dur"]
            kernels += e.get("cat") == "kernel"

    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device
                  if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy_us = sum(b - a for a, b in busy)

    # host stages: each `bench.stage:<name>` mark ends the stage <name>,
    # which began at the previous mark or at its call's start
    marks = sorted((e["ts"], e["name"].split(":", 1)[1]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("bench.stage:"))
    stages = []
    for a, b in calls:
        prev = a
        for ts, name in marks:
            if a <= ts <= b:
                stages.append((prev, ts, name))
                prev = ts
        stages.append((prev, b, "(after the last stage)"))
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    idle = defaultdict(float)
    for ga, gb in gaps:
        for sa, sb, name in stages:
            overlap = min(gb, sb) - max(ga, sa)
            if overlap > 0:
                idle[name] += overlap
        between = (gb - ga) - sum(max(0.0, min(gb, sb) - max(ga, sa)) for sa, sb, _ in stages)
        if between > 0:
            idle["(between calls)"] += between

    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return Profile(dispatch_us * 1e-6, kernels, len(dispatch), busy_us * 1e-6,
                   (t1 - t0) * 1e-6, top(by_name), top(idle))
