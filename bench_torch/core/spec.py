"""Finding a cell's files by name.

`BENCHMARK.json` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one cell, configuration, traffic mix or
metric sits in a file of its own under `bench_torch/`:

- `configs/<config>.json`: the deployment (box, water model, precision);
- `traffic/<traffic>.json`: the driver entry, its keyword arguments, frames
  per call, the pool the calls draw their frames from, the population (the
  waters within `radius_A` of the box centre), the calls to check; a key
  the harness does not read is refused;
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
                "min_calls", "check_calls", "why"}
POPULATION_KEYS = {"radius_A"}


def check_traffic(name: str, tr: dict) -> dict:
    """`tr` as read, or ValueError where it holds a key the harness does not
    read: a setting that nothing reads would be silently ignored."""
    unread = set(tr) - TRAFFIC_KEYS
    unread |= {f"population.{k}" for k in set(tr.get("population") or {}) - POPULATION_KEYS}
    if unread:
        raise ValueError(f"traffic {name}: keys the harness does not read: {sorted(unread)}")
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
