"""Finding a cell's files by name.

`BENCHMARK.json` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one cell, configuration, traffic mix or
metric sits in a file of its own under `bench_torch/`:

- `configs/<config>.json`: the deployment (box, water model, precision);
- `traffic/<traffic>.json`: the driver entry, its keyword arguments, frames
  per call, the pool the calls draw their frames from, the population (the
  waters within `radius_A` of the box centre), the calls to check, and the
  `source` of each call's trajectory: "memory" (the default) hands the
  driver the call's frames of the pool as an in-memory `Trajectory`,
  "dcd" the path of one of the DCD files that set-up wrote the pool to, one
  file a call's worth of frames (`pool_frames` a multiple of
  `frames_per_call`); and optionally `structures` = {"count", "seed"}: the
  whole pool made from a fixed seed, the same for every run, each of its
  `count` lattices in every call equally often (`count` divides
  `frames_per_call`), and the calls taking the pool's whole calls in rounds
  (`pool_frames` a multiple of `frames_per_call`), so that the run's seed
  changes the order and not the work (core/waterbox.py, run.py
  `draw_offset`); a key the harness does not read, or another source, is
  refused;
- `workloads/<cell>.json`: the configuration and traffic, the stage-clock
  names of each layer metric, the dispatch entry point that the traced run
  wraps, the wrappers' launch and plain-call counters, the output check and
  its limits;
- `metrics/<metric>.py`: the metric's reader, `read(run) -> float | None`;
- `checks/<check>.py`: the comparison with the plain reference: `NAMES`
  (the numbers compared, each with a limit in the cell's file), `capture`,
  `program_answers`, `reference_answers`, `compare`, and `FAULT_AT`, the
  ("module", "attribute") of the kernel wrapper or dispatch whose output
  the benchmark's tests alter to see the check fail;
- `reference/<check>.py`: the plain reference the check compares with.

A later cell, mix, metric or check is added by adding such files and
entries to `BENCHMARK.json`; no file already there needs an edit, since
everything the harness and its tests know of a check is in its own module.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


TRAFFIC_KEYS = {"driver", "kwargs", "frames_per_call", "pool_frames", "population",
                "min_calls", "check_calls", "source", "structures", "why"}
POPULATION_KEYS = {"radius_A"}
STRUCTURE_KEYS = {"count", "seed"}
SOURCES = ("memory", "dcd")


def source(tr: dict) -> str:
    """Where the traffic's calls read their frames: "memory" or "dcd"."""
    return tr.get("source", "memory")


def check_traffic(name: str, tr: dict) -> dict:
    """`tr` as read, or ValueError where it holds a key the harness does not
    read (a setting that nothing reads would be silently ignored), a source
    it does not know, a file source whose pool does not split into whole
    calls, or lattices that a call would not hold equally often or a pool
    of them that does not split into whole calls."""
    unread = set(tr) - TRAFFIC_KEYS
    unread |= {f"population.{k}" for k in set(tr.get("population") or {}) - POPULATION_KEYS}
    st = tr.get("structures")
    if st is not None:
        unread |= {f"structures.{k}" for k in set(st) ^ STRUCTURE_KEYS}
    if unread:
        raise ValueError(f"traffic {name}: keys the harness does not read or lacks: "
                         f"{sorted(unread)}")
    if st is not None and (int(st["count"]) < 1 or int(tr["frames_per_call"]) % int(st["count"])):
        raise ValueError(f"traffic {name}: structures.count {st['count']} does not divide "
                         f"frames_per_call {tr['frames_per_call']}, so a call would not hold "
                         f"each lattice equally often")
    if st is not None and int(tr["pool_frames"]) % int(tr["frames_per_call"]):
        raise ValueError(f"traffic {name}: pool_frames {tr['pool_frames']} is not a multiple "
                         f"of frames_per_call {tr['frames_per_call']}, so the pool would not "
                         f"split into whole calls")
    if source(tr) not in SOURCES:
        raise ValueError(f"traffic {name}: source {source(tr)!r} is none of {SOURCES}")
    if source(tr) == "dcd" and int(tr["pool_frames"]) % int(tr["frames_per_call"]):
        raise ValueError(f"traffic {name}: pool_frames {tr['pool_frames']} is not a multiple "
                         f"of frames_per_call {tr['frames_per_call']}, one file a call")
    return tr


def traffic(name: str) -> dict:
    return check_traffic(name, _json(BENCH / "traffic" / f"{name}.json"))


def cell(name: str) -> dict:
    """The cell's own file, with its configuration and traffic read in
    under "config_spec" and "traffic_spec"."""
    spec = _json(BENCH / "workloads" / f"{name}.json")
    spec["name"] = name
    spec["config_spec"] = config(spec["config"])
    spec["traffic_spec"] = traffic(spec["traffic"])
    return spec


def metrics_of(bench: dict, cell_name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that `cell_name` reports: an
    entry without "workloads" is reported in every cell."""
    def mine(m):
        return "workloads" not in m or cell_name in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def _module_from(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """metrics/<name>.py as a module (names may hold dots)."""
    return _module_from(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


def check_module(name: str):
    return _module_from(BENCH / "checks" / f"{name}.py", f"bench_check_{name}")


def attr(dotted: str):
    """'package.module:attr' -> (module, attribute name, value)."""
    mod_name, _, name = dotted.partition(":")
    mod = importlib.import_module(mod_name)
    return mod, name, getattr(mod, name)
