"""The readers of the program's recorded calls (core/program_trace.py) on
hand-built calls: each metric's value, and None where the cell has no such
span or counter, or the program no tracer."""

from types import SimpleNamespace

import pytest

from bench_torch.core import program_trace, spec
from waterorderlib_tpu_torch.core import clock


def _span(name, parent, t0_ms, t1_ms, counts=None, device_ms=None):
    s = clock.Span(name, parent, int(t0_ms * 1e6))
    s.t1 = int(t1_ms * 1e6)
    s.counts = dict(counts or {})
    s._device_ms = device_ms
    return s


def _call(name, build, counts=None):
    """A recorded call: root `name` over [0, 100] ms; build(root) -> the
    other spans."""
    root = _span(name, None, 0.0, 100.0)
    return clock.Call(root, [root] + build(root), dict(counts or {}))


def _tet_call():
    def build(root):
        gather_stage = _span("stage:host gather", root, 0.0, 40.0)
        topo = _span("topology", gather_stage, 1.0, 4.0)
        sub = _span("topology", topo, 2.0, 3.0)  # a child: not in topo's self time
        host_gather = _span("gather", gather_stage, 5.0, 25.0, {"gather_bytes": 9})  # not read
        h2d_stage = _span("stage:H2D", root, 40.0, 50.0)
        h2d = _span("h2d", h2d_stage, 40.0, 45.0, {"h2d_bytes": 8_000_000}, device_ms=1.0)
        gather = _span("device_gather", h2d_stage, 45.0, 48.0,
                       {"device_gather_bytes": 10_000_000, "block_bytes": 30_000_000},
                       device_ms=0.025)
        gather_cpu = _span("device_gather", h2d_stage, 48.0, 49.0,
                           {"device_gather_bytes": 7})  # no events
        h2d_cpu = _span("h2d", h2d_stage, 49.0, 50.0, {"h2d_bytes": 5})  # no events
        return [topo, sub, gather_stage, host_gather, h2d, gather, gather_cpu, h2d_cpu, h2d_stage]

    return _call("call:tet_order_calc", build,
                 {"device_gather_bytes": 10_000_007, "block_bytes": 30_000_000})


def _voronoi_call(rows, cert):
    return _call("call:voronoi_calc", lambda root: [],
                 {"voronoi:escalation:rows": rows, "voronoi:escalation:certified": cert})


def _run(calls):
    return SimpleNamespace(program_calls=calls)


def _read(name, run):
    return spec.metric_reader(name).read(run)


# metric -> (value on two tet calls and a Voronoi call, value with no such span)
EXPECTED = {
    "topology_ms": (2 * (2.0 + 1.0) / 3, None),  # (3 - 1) + 1 ms of self time over 3 calls
    # 20 MB over 0.05 ms of device time: 400 GB/s; the spans without events
    # and the host `gather` are left out
    "gather_gbps": (20_000_000 / (0.05 * 1e6), None),
    "h2d_gbps": (16_000_000 / (2.0 * 1e6), None),  # the span without events is left out
    "voronoi_escalation_yield": (100.0 * 30 / 120, None),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_recorded_calls(name):
    calls = [_tet_call(), _tet_call(), _voronoi_call(120, 30)]
    assert _read(name, _run(calls)) == pytest.approx(EXPECTED[name][0])
    bare = [_call("call:hb_calc", lambda root: [])]
    assert _read(name, _run(bare)) is EXPECTED[name][1]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_a_tracer(name, monkeypatch):
    monkeypatch.delattr(clock, "recorded_calls")
    assert _read(name, SimpleNamespace()) is None


def test_calls_are_taken_once_and_kept(monkeypatch):
    taken = []
    calls = [_tet_call(), _call("dispatch:order_param_q_certified", lambda root: [])]
    monkeypatch.setattr(clock, "recorded_calls", lambda: taken.append(1) or list(calls))
    run = SimpleNamespace()
    assert program_trace.calls(run) == calls[:1]  # driver calls alone
    assert program_trace.calls(run) == calls[:1] and taken == [1]
    assert [s.name for _, s in program_trace.spans(run, "gather")] == ["gather"]
    assert program_trace.spans(run, "kernel:q_window") is None


def test_new_metrics_name_cells_that_report_what_they_move():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    reported = {c: {e["name"] for e in spec.metrics_of(bench, c)[0]} for c in cells}
    for m in bench["per_layer"]:
        if m["name"] in EXPECTED:
            assert m["source"] == "program_counter"
            assert set(m["workloads"]) <= cells
            assert all(m["moves"] in reported[c] for c in m["workloads"])
