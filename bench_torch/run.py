#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json` and the port,
`waterorderlib_tpu_torch/`. The cell's files (spec.py says which) give the
water box, the driver and how it is called. Set-up makes a pool of frames
on the card from the seed, copies it to the host as the float32 trajectory
a user's loader would give, and warms the driver with one call. Where the
traffic sets `structures`, the pool is the same for every seed
(core/waterbox.py) and the seed draws the order in which the calls visit
its whole calls, each once a round, so that every seed asks the same work
of tiers that depend on the data. The window
then calls the driver back to back (a closed loop), each call on its own
frames of the pool, for `--seconds`.

Where the traffic's `source` is "dcd", set-up also writes the pool to DCD
files in the run's scratch directory (core/dcd.py), one a call's worth of
frames, every atom, as an MD engine writes them; each call is handed the
path of the file its frames are in, drawn from the seed, and the driver
reads it. The output check still takes the call's frames from the pool in
memory, so it holds what the program read from the file against the frames
that were written. Nothing drops the page cache: set-up reads each file
once through an mmap, and its note gives that read's rate and the type of
the filesystem, so the calls read files the OS holds, as a job that runs
several analyses over one trajectory does.

With `--trace 0` the last line of standard output holds the end-to-end
metrics. With `--trace 1` the run first profiles a few calls with
torch.profiler, then runs the window with the program's stage clock, and
reports the per-layer metrics. Either way, once the window has closed and
the memory peak is read, a sample of the window's calls drawn from the seed
is compared with the plain reference; the numbers compared, each beside
its limit, end standard error and the result line.

Exits non-zero, printing no result, where torch finds no CUDA device or
fewer than the cell asks for, or where the process holds JAX or the JAX
package once the window has closed (`foreign_modules`).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# one host thread for the CPU math libraries: the calls' host work runs on the
# main thread, and idle worker threads only take cores from it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

# kernel caches at fixed places inside the checkout, so that only a
# checkout's first run of a cell builds or compiles anything
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch.core import peaks, spec, waterbox  # noqa: E402
from bench_torch.core.window import Call  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class CallRecord:
    """One driver call: its frames of the pool, output directory, return
    value, and what the dispatch entry point produced in it."""

    def __init__(self, run, index: int, offset: int):
        self.run, self.index, self.offset = run, index, offset
        self.frames = run.frames_per_call
        self.out_dir = os.path.join(run.out_root, f"call{index}")
        self.result = None
        self.captured = []
        self.kwargs = run.traffic.get("kwargs", {})

    @property
    def sub_inds(self):
        return self.run.sub_inds[self.offset:self.offset + self.frames]

    def inputs(self):
        """Positions (F, atoms, 3) and boxes (F, 3), float32 on the device."""
        sl = slice(self.offset, self.offset + self.frames)
        return (torch.as_tensor(self.run.pool[sl], device=self.run.device),
                torch.as_tensor(self.run.boxes[sl], device=self.run.device))


class Run:
    """One run of a cell; `execute` returns the result line's object."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
                 bench: dict | None = None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.config, self.traffic = cell["config_spec"], cell["traffic_spec"]
        self.frames_per_call = int(self.traffic["frames_per_call"])
        self.source = spec.source(self.traffic)
        self.files: list[str] = []
        self.bench = bench if bench is not None else spec.benchmark()
        self.window: list[Call] = []
        self.records: list[CallRecord] = []
        self.stage_calls: list[dict] = []
        self.profile = None
        self.profiled: list[CallRecord] = []
        self.capturing: CallRecord | None = None
        self.latest: CallRecord | None = None
        self.check = spec.check_module(cell["check"])
        self._patched: list = []

    # -- set-up ---------------------------------------------------------
    def make_pool(self) -> None:
        """The frames the calls draw from, made from the seed on the device
        and held on the host; the populations; the calls' offsets and the
        sample of calls to check, drawn from the seed."""
        tr = self.traffic
        pool_frames = int(tr["pool_frames"])
        pos, box = waterbox.make_frames(self.config, pool_frames, self.seed, self.device,
                                        tr.get("structures"))
        pop = tr.get("population")
        self.sub_inds = (waterbox.shell_population(pos, box, pop["radius_A"]) if pop else None)
        self.pool = pos.cpu().numpy()
        del pos
        self.boxes = np.full((pool_frames, 3), box, dtype=np.float32)
        self.out_root = tempfile.mkdtemp(prefix="bench_torch_out_")
        self.offset_rng = np.random.default_rng([self.seed, 1])
        self.round: list[int] = []
        picks = np.random.default_rng([self.seed, 2]).choice(
            int(tr["min_calls"]), size=int(tr["check_calls"]), replace=False)
        self.sample = set(int(i) for i in picks)

    def write_files(self) -> str:
        """With a "dcd" source, the pool as DCD files in the run's scratch
        directory: file i holds frames [i F, (i + 1) F) of F a call. Each
        file is then read through a fresh mmap, timed, so that the calls
        find it in memory and the set-up note shows they do. Returns the
        note's part, or ""."""
        if self.source != "dcd":
            return ""
        from bench_torch.core import dcd

        f = self.frames_per_call
        t0 = time.perf_counter()
        for i in range(self.boxes.shape[0] // f):
            path = os.path.join(self.out_root, f"pool{i}.dcd")
            dcd.write(path, self.pool[i * f:(i + 1) * f], self.boxes[i * f:(i + 1) * f])
            self.files.append(path)
        t1 = time.perf_counter()
        mapped = sum(dcd.touch(path) for path in self.files)
        t2 = time.perf_counter()
        return (f", {len(self.files)} files written {t1 - t0:.3f} s to {self.out_root} "
                f"({dcd.fs_type(self.out_root)}), read {mapped / 1e9:.3f} GB through mmap "
                f"{t2 - t1:.3f} s ({mapped / 1e9 / (t2 - t1):.2f} GB/s)")

    def draw_offset(self) -> int:
        """A call's first frame of the pool, from the offset stream: any
        frame that leaves room for a call; with a "dcd" source the first
        frame of a file; with `structures` the first frame of one of the
        pool's whole calls, visited in rounds, each round every whole call
        once in an order drawn anew, so that every seed's window holds the
        same calls as often, to within its last round."""
        f, pool = self.frames_per_call, self.boxes.shape[0]
        if self.source == "dcd":
            return f * int(self.offset_rng.integers(0, pool // f))
        if self.traffic.get("structures") is not None:
            if not self.round:
                self.round = [f * int(i) for i in self.offset_rng.permutation(pool // f)]
            return self.round.pop()
        return int(self.offset_rng.integers(0, pool - f + 1))

    def setup(self) -> None:
        from waterorderlib_tpu_torch.io.topology import Topology
        from waterorderlib_tpu_torch.io.trajectory import Trajectory

        t0 = time.perf_counter()
        self.make_pool()
        tf = time.perf_counter()
        files = self.write_files()
        t1 = time.perf_counter()
        self.Trajectory = Trajectory
        self.top = Topology(**waterbox.topology_arrays(self.config["n_waters"]))
        _, _, self.driver = spec.attr(self.traffic["driver"])
        self._wrap_dispatch()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.call(CallRecord(self, -1, 0))  # warm-up: builds and loads every kernel it uses
        self.note(f"set-up: imports and start {t0 - T_PROCESS:.3f} s, pool {tf - t0:.3f} s"
                  f"{files}, warm-up call {time.perf_counter() - t1:.3f} s")

    def _patch(self, mod, name, value):
        self._patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def restore(self) -> None:
        for mod, name, value in reversed(self._patched):
            setattr(mod, name, value)
        self._patched.clear()

    def _wrap_dispatch(self) -> None:
        """Wrap the dispatch entry point the driver calls: a profiler range
        while profiling, and the capture of its output for sampled calls."""
        mod, name, orig = spec.attr(self.cell["dispatch"])
        run = self

        def dispatch(*args, **kwargs):
            if run.profiling:
                with torch.profiler.record_function("bench.dispatch"):
                    out = orig(*args, **kwargs)
            else:
                out = orig(*args, **kwargs)
            if run.capturing is not None:
                run.capturing.captured.append(run.check.capture(out))
            return out

        self.profiling = False
        self._patch(mod, name, dispatch)

    def _mark_stages(self) -> None:
        """Emit an instant profiler range at each stage end of the program."""
        from waterorderlib_tpu_torch.core import clock

        orig = clock.stage_end

        def stage_end(name):
            orig(name)
            with torch.profiler.record_function(f"bench.stage:{name}"):
                pass

        for mod in [m for k, m in sys.modules.items() if k.startswith("waterorderlib_tpu_torch")]:
            if getattr(mod, "stage_end", None) is orig:
                self._patch(mod, "stage_end", stage_end)

    # -- calls ----------------------------------------------------------
    def next_record(self) -> CallRecord:
        rec = CallRecord(self, len(self.records), self.draw_offset())
        self.records.append(rec)
        return rec

    def call(self, rec: CallRecord):
        os.makedirs(rec.out_dir, exist_ok=True)
        sl = slice(rec.offset, rec.offset + rec.frames)
        kwargs = dict(rec.kwargs, output_dir=rec.out_dir, device=str(self.device))
        if self.sub_inds is not None:
            kwargs.update(sub_inds=self.sub_inds[sl], n_pops=1)
        traj = (self.files[rec.offset // rec.frames] if self.source == "dcd"
                else self.Trajectory(self.pool[sl], self.boxes[sl]))
        self.capturing = rec
        try:
            rec.result = self.driver(self.top, traj, **kwargs)
        finally:
            self.capturing = None
        # keep what the sampled calls and the latest call produced, nothing else
        if rec.index < 0:
            rec.captured = []
        elif rec.index not in self.sample:
            if self.latest is not None:
                self.latest.captured = []
            self.latest = rec

    def counters(self, key: str, field: str) -> int:
        return sum(getattr(spec.attr(c)[2], field) for c in self.cell.get(key, []))

    def run_window(self, stage_clock: bool) -> int:
        """Calls back to back for `seconds`; returns the failed calls."""
        from waterorderlib_tpu_torch.core import clock

        failed = 0
        t0 = time.perf_counter()
        self.t_window = t0
        while time.perf_counter() - t0 < self.seconds:
            rec = self.next_record()
            ts = time.perf_counter()
            try:
                if stage_clock:
                    with clock.stage_times() as st:
                        self.call(rec)
                    self.stage_calls.append(dict(st))
                else:
                    self.call(rec)
            except Exception:
                log(traceback.format_exc())
                failed += 1
                rec.result = None
            te = time.perf_counter()
            self.window.append(Call(ts - t0, te - t0, rec.frames))
        return failed

    def run_profile(self) -> None:
        """Profile a fixed few calls early in the run; fails where the
        profiler saw fewer kernels in the dispatch ranges than the wrappers
        counted launches."""
        from bench_torch.core import trace as trace_mod

        n = int(self.cell["profile_calls"])
        recs = [CallRecord(self, -2 - i, self.draw_offset()) for i in range(n)]
        self._mark_stages()
        launches0 = self.counters("launch_counters", "launches")
        path = os.path.join(self.out_root, "trace.json")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.profiling = True
        try:
            with torch.profiler.profile(activities=acts) as prof:
                for rec in recs:
                    with torch.profiler.record_function("bench.call"):
                        self.call(rec)
                torch.cuda.synchronize()
        finally:
            self.profiling = False
        launches = self.counters("launch_counters", "launches") - launches0
        prof.export_chrome_trace(path)
        self.profile = trace_mod.read(path)
        os.remove(path)
        self.profiled = recs
        self.note(f"profile: {n} calls, window {self.profile.window_s:.6f} s, busy "
                  f"{self.profile.busy_s:.6f} s, dispatch {self.profile.dispatch_s:.6f} s in "
                  f"{self.profile.dispatch_ranges} dispatch ranges, "
                  f"{self.profile.dispatch_kernels} kernels in dispatch against {launches} "
                  f"launches counted")
        if self.profile.dispatch_kernels < launches or (launches and self.profile.dispatch_s <= 0):
            raise RuntimeError(f"the profiler saw {self.profile.dispatch_kernels} kernels in the "
                               f"dispatch ranges, the wrappers counted {launches} launches")
        self.restore()
        self._wrap_dispatch()

    def note(self, msg: str) -> None:
        log(msg)

    # -- output check ---------------------------------------------------
    def checked_records(self) -> list[CallRecord]:
        """The sampled calls of the window that returned, and the latest."""
        keep = [r for r in self.records if r.index in self.sample and r.result is not None]
        if self.latest is not None and self.latest.result is not None:
            keep.append(self.latest)
        return keep

    def check_outputs(self, failed: int) -> dict:
        """Each number compared, with its limit: the worst over the sampled
        calls of the check's numbers, the failed calls, and (on the card)
        the plain versions' calls in the window."""
        limits = self.cell["limits"]
        worst = {name: 0 for name in self.check.NAMES}
        recs = self.checked_records()
        for rec in recs:
            got = self.check.compare(self.check.program_answers(rec),
                                     self.check.reference_answers(rec, "float64"))
            for k, v in got.items():
                worst[k] = max(worst[k], v) if not math.isnan(v) else math.inf
            rec.captured = []
        out = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
        out["checked_calls"] = {"value": len(recs), "limit": ">=1"}
        out["failed_calls"] = {"value": failed, "limit": 0}
        if self.device.type == "cuda":
            out["plain_calls"] = {"value": self.plain_in_window, "limit": 0}
        return out

    @staticmethod
    def passes(checks: dict) -> bool:
        ok = True
        for k, c in checks.items():
            if k == "checked_calls":
                ok &= c["value"] >= 1
            else:
                ok &= c["value"] <= c["limit"]
        return ok

    # -- the run --------------------------------------------------------
    def execute(self) -> dict:
        try:
            return self._execute()
        finally:
            self.restore()
            shutil.rmtree(getattr(self, "out_root", ""), ignore_errors=True)

    def _execute(self) -> dict:
        self.note(f"cell {self.cell['name']}: seed {self.seed}, {self.seconds} s, trace "
                  f"{int(self.trace)}; card: {peaks.card_power() if self.device.type == 'cuda' else 'cpu'}")
        self.setup()
        if self.trace:
            self.run_profile()
        plain0 = self.counters("plain_counters", "calls")
        self.setup_s = time.perf_counter() - T_PROCESS
        failed = self.run_window(stage_clock=self.trace)
        self.plain_in_window = self.counters("plain_counters", "calls") - plain0
        for dotted in self.cell.get("report", []):
            self.note(f"{dotted}: {spec.attr(dotted)[2]!r}")
        device = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                  "count": 1}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
            self.memory_peak_bytes = device["memory_peak_bytes"]
        if self.trace and self.profile is not None:
            device["busy_s"] = self.profile.busy_s
            device["window_s"] = self.profile.window_s
        self.restore()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = self.check_outputs(failed)
        self.note(f"output check: {time.perf_counter() - t_check:.3f} s")
        correct = self.passes(checks)
        e2e, layer = spec.metrics_of(self.bench, self.cell["name"])
        metrics = {}
        for m in (layer if self.trace else e2e):
            value = spec.metric_reader(m["name"]).read(self)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"correct": bool(correct), "attempted": len(self.window), "failed": failed,
                  "metrics": metrics, "device": device}
        if self.trace and self.profile is not None:
            result["breakdown"] = {"device_ops": self.profile.device_ops,
                                   "idle_gaps": self.profile.idle_by_stage}
        result["checks"] = checks
        frames = sum(c.frames for c in self.window)
        if len(self.window) >= 4:
            walls = sorted((c.end - c.start) * 1e3 for c in self.window)
            tenth = max(1, len(self.window) // 10)
            self.note("call walls ms: quartiles " + " / ".join(
                f"{q:.3f}" for q in statistics.quantiles(walls, n=4)) + f", first {tenth} "
                f"{np.mean([(c.end - c.start) * 1e3 for c in self.window[:tenth]]):.3f}, last "
                f"{tenth} {np.mean([(c.end - c.start) * 1e3 for c in self.window[-tenth:]]):.3f}")
        self.note(f"window: {len(self.window)} calls, {frames} frames, last end "
                  f"{self.window[-1].end if self.window else 0:.6f} s; setup {self.setup_s:.6f} s")
        for k, c in checks.items():
            log(f"check {k}: {c['value']} (limit {c['limit']})")
        return result


# top-level modules that no run may load: the port runs without JAX, and
# the JAX package (whose name the port's begins with) is not measured
FOREIGN = frozenset({"jax", "jaxlib", "flax", "waterorderlib_tpu"})


def foreign_modules(modules=None) -> list[str]:
    """The top-level names in `modules` (default sys.modules) that are in
    FOREIGN, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & FOREIGN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(entry[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); torch finds "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = Run(spec.cell(args.workload), args.seed, args.seconds, bool(args.trace),
                 "cuda", bench).execute()
    found = foreign_modules()
    if found:
        log(f"the run loaded {found}: no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
