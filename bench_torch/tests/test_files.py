"""Every cell, configuration, traffic mix, metric and check loads by name,
and BENCHMARK.json keeps the contract's form."""

import ast
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_torch.core import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    cell = spec.cell(w["name"])
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert w["chips"] == 1
    assert spec.attr(cell["traffic_spec"]["driver"])[2] is not None
    assert spec.attr(cell["dispatch"])[2] is not None
    for c in cell["launch_counters"]:
        assert isinstance(spec.attr(c)[2].launches, int)
    for c in cell["plain_counters"]:
        assert isinstance(spec.attr(c)[2].calls, int)
    check = spec.check_module(cell["check"])
    assert set(cell["limits"]) == set(check.NAMES)
    mod_name, name = check.FAULT_AT
    assert spec.attr(f"{mod_name}:{name}")[2] is not None
    e2e, layer = spec.metrics_of(BENCH, w["name"])
    reported = {m["name"] for m in e2e}
    assert "setup_s" in reported and len(reported) >= 2
    assert layer and all(m["moves"] in reported for m in layer)
    for m in layer:
        if m["source"] == "program_span":
            # a metric split by the cells it is in (`<metric>.<kind>`) reads the metric's stages
            assert m["name"] in cell["layers"] or m["name"].split(".")[0] in cell["layers"], m["name"]


@pytest.mark.parametrize("path", sorted((spec.BENCH / "checks").glob("[!_]*.py")),
                         ids=lambda p: p.stem)
def test_check_names_its_fault_point(path):
    """Every check module says where the benchmark's tests plant a fault,
    and that attribute exists in the program."""
    check = spec.check_module(path.stem)
    mod_name, name = check.FAULT_AT
    _, _, target = spec.attr(f"{mod_name}:{name}")
    assert callable(target)
    assert set(check.NAMES) and all(callable(getattr(check, f)) for f in
                                    ("capture", "program_answers", "reference_answers", "compare"))


@pytest.mark.parametrize("key", ["loop", "population.rule"])
def test_traffic_with_an_unread_key_is_refused(key):
    tr = dict(spec.traffic("tet_shell12_f1024"), population={"radius_A": 12.0})
    if key == "loop":
        tr["loop"] = "open"
    else:
        tr["population"]["rule"] = "slab"
    with pytest.raises(ValueError, match=key.split(".")[-1]):
        spec.check_traffic("tet_shell12_f1024", tr)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_files_load(m):
    reader = spec.metric_reader(m["name"])
    assert callable(reader.read)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


SPLIT_READS = ("host_prep_ms", "dispatch_ms", "stats_ms", "device_idle_share", "frames_per_s")


@pytest.mark.parametrize("base", SPLIT_READS)
def test_split_metric_reads_as_the_metric(base):
    from bench_torch.core.window import Call

    run = SimpleNamespace(cell={"layers": {base: ["host gather", "H2D"]}},
                          stage_calls=[{"host gather": 5.0, "H2D": 1.0}, {"host gather": 7.0}],
                          profile=SimpleNamespace(window_s=2.0, idle_share=0.25),
                          window=[Call(0.0, 0.5, 32), Call(0.5, 2.0, 32)])
    got = spec.metric_reader(f"{base}.host_bound").read(run)
    assert got is not None and got == spec.metric_reader(base).read(run)


def test_memory_peak_in_mib():
    reader = spec.metric_reader("memory_peak_mib")
    assert reader.read(SimpleNamespace(memory_peak_bytes=3 * 2**20)) == 3.0
    assert reader.read(SimpleNamespace()) is None  # nothing read on the CPU


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = spec.config(c["name"])
    assert Path(spec.ROOT / c["file"]).exists() and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] and len(c["source"]) <= 200


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


FORBIDDEN = ("jax", "waterorderlib_tpu", "bench", "chip_smoke")


@pytest.mark.parametrize("path", sorted(spec.BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_imports_no_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {n}"
