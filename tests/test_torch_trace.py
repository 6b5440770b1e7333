"""The port's tracer (core/clock.py) on the CPU: the span tree of a driver
call, the stage dict it still yields, the host-prep spans and their byte
counts, the off path, the profiler ranges, the Chrome export, and the
counter registry behind the wrappers' legacy counts."""

import json
import os

import numpy as np
import pytest
import torch

from waterorderlib_tpu_torch import __main__ as cli
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import hbonds_driver, orderparams, voronoi_driver
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.io.trajectory import Trajectory
from waterorderlib_tpu_torch.ops.cuda import hbond, lsi, qtet2, voronoi_cells, voronoi_topk
from waterorderlib_tpu_torch.surface import voronoi_device

torch.set_num_threads(1)

N_WAT, N_FRAMES = 216, 2


@pytest.fixture(scope="module")
def system():
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=5)
    wat = top.get_wat_inds()[0]
    return top, traj, [[wat[::3]] for _ in range(N_FRAMES)]


def _tet(top, traj, pops, out):
    return orderparams.tet_order_calc(top, traj, sub_inds=pops, n_pops=1, output_dir=out,
                                      device="cpu")


def _hb(top, traj, pops, out):
    return hbonds_driver.hb_calc(top, traj, output_dir=out, device="cpu")


def _voronoi(top, traj, pops, out):
    return voronoi_driver.voronoi_calc(top, traj, output_dir=out, engine="device", device="cpu")


# driver, its root span, the stages it ends (escalation tiers aside), the
# wrappers whose legacy counts the registry backs, and its tier module
DRIVERS = {
    "tet": (_tet, "call:tet_order_calc",
            ["host gather", "H2D", "masks (host + H2D)", "kernel stage", "stats (device)", "D2H",
             "savetxt", "bootstrap (host)"],
            [qtet2.q_window, qtet2.q_window_hist, qtet2.q_window_plain,
             qtet2.q_window_hist_plain], (qtet2, "order_param_q_certified")),
    "hb": (_hb, "call:hb_calc",
           ["host gather", "H2D", "kernel stage", "stats (device)", "D2H", "savetxt"],
           [hbond.hbond_dense, hbond.hbond_slab, hbond.hbond_dense_plain, hbond.hbond_slab_plain],
           (hbond, "hbond_counts_certified")),
    "voronoi": (_voronoi, "call:voronoi_calc",
                ["host gather", "H2D", "mirrors and grid", "tier-1 search", "tier-1 cells",
                 "host close", "statistics and histograms", "savetxt", "bootstrap CIs"],
                [voronoi_topk.voronoi_window_topk, voronoi_topk.voronoi_cellgrid_topk,
                 voronoi_cells.voronoi_cells_fused, voronoi_topk.voronoi_window_topk_plain,
                 voronoi_topk.voronoi_cellgrid_topk_plain, voronoi_cells.voronoi_cells_fused_plain],
                None),
}


def _legacy(wrappers):
    return [w.launches if hasattr(w, "launches") else w.calls for w in wrappers]


_RUNS = {}


def _recorded(name, system, tmp_path_factory):
    """One recorded call of the driver `name` (cached per module): (stage
    dict, [Call], legacy count deltas, tier_stats after, tier served)."""
    if name not in _RUNS:
        fn, _, _, wrappers, _ = DRIVERS[name]
        out = str(tmp_path_factory.mktemp(name))
        clock.recorded_calls()
        voronoi_device.tier_stats.clear()
        before = _legacy(wrappers)
        with clock.stage_times() as st:
            fn(*system, out)
        deltas = [b - a for a, b in zip(before, _legacy(wrappers))]
        tier = DRIVERS[name][4]
        _RUNS[name] = (dict(st), clock.recorded_calls(), deltas,
                       {k: dict(v) for k, v in voronoi_device.tier_stats.items()},
                       tier[0].last_tier if tier else None)
    return _RUNS[name]


@pytest.fixture(params=sorted(DRIVERS))
def run(request, system, tmp_path_factory):
    return request.param, _recorded(request.param, system, tmp_path_factory)


def test_one_call_root_and_a_sound_tree(run):
    name, (_, calls, _, _, _) = run
    assert len(calls) == 1
    call = calls[0]
    assert call.root.name == DRIVERS[name][1] and call.root.parent is None
    by_id = {s.id: s for s in call.spans}
    assert len(by_id) == len(call.spans)
    for s in call.spans:
        assert s.call == call.root.id
        if s is call.root:
            continue
        parent = by_id[s.parent]  # the parent is in the same call
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, (s.name, parent.name)


def test_stage_dict_keeps_its_names_and_sums_the_stage_spans(run):
    name, (st, calls, _, _, _) = run
    assert [k for k in st if not k.startswith("escalation (")] == DRIVERS[name][2]
    sums = {}
    for s in calls[0].spans:
        if s.name.startswith("stage:"):
            sums[s.name[6:]] = sums.get(s.name[6:], 0.0) + s.ms
    assert sums.keys() == st.keys()
    for k, ms in st.items():
        assert sums[k] == pytest.approx(ms, rel=1e-9, abs=1e-9)


def test_host_prep_spans_and_their_bytes(run, system):
    name, (_, calls, _, _, _) = run
    top, traj, _ = system
    call = calls[0]
    by_id = {s.id: s for s in call.spans}
    assert call.named("topology")
    for s in (call.named("topology") + call.named("gather") + call.named("device_gather")
              + call.named("h2d")):
        assert by_id[s.parent].name.startswith(("stage:", "dispatch:")), s.name
    h2d = sum(s.counts.get("h2d_bytes", 0) for s in call.named("h2d"))
    assert h2d == call.counts["h2d_bytes"]
    f, n = traj.n_frames, top.n_atoms
    nw = len(top.get_wat_inds()[0])
    if name == "tet":
        # the oxygens' atom span of the frames, boxes (F, 3) f32, masks (F, 2, Nw)
        # bool, the centers' int64 indices; the device gathers (F, Nw, 3) f32
        assert "gather_bytes" not in call.counts
        assert call.counts["device_gather_bytes"] == f * nw * 12
        # the rows fill a third of a frame: a chunk a frame, atoms 0 to the last oxygen
        assert call.counts["block_bytes"] == f * (3 * nw - 2) * 12
        assert len(call.named("device_gather")) == f
        assert h2d == call.counts["block_bytes"] + f * 12 + f * 2 * nw + nw * 8
    elif name == "hb":
        # every atom (F, N, 3) f32, boxes, and the water triplets' int64 indices
        triplets = top.get_hb_inds(np.array([], int), top.get_wat_inds()[0])[0]
        idx = sum(len(a) * 8 for a in triplets)
        assert "gather_bytes" not in call.counts
        assert h2d == f * n * 12 + f * 12 + idx
    else:
        # heavy atoms (F, Nh, 3) f32 gathered and moved, boxes, escalation rows
        heavy = f * nw * 12
        assert call.counts["gather_bytes"] == heavy
        assert call.named("h2d")[0].counts["h2d_bytes"] == heavy
    assert call.named("gather") if name == "voronoi" else not call.named("gather")


def test_registry_backs_the_legacy_counts(run):
    name, (_, calls, deltas, tiers, tier) = run
    counts = calls[0].counts
    for w, d in zip(DRIVERS[name][3], deltas):
        key = f"launches:{w.__name__}" if hasattr(w, "launches") else f"calls:{w.__name__}"
        assert counts.get(key, 0) == d, key
    assert sum(deltas) >= 1  # the CPU runs the plain versions
    if DRIVERS[name][4]:
        entry = DRIVERS[name][4][1]
        assert [k for k in counts if k.startswith("tier:")] == [f"tier:{entry}:{tier}"]
        assert counts[f"tier:{entry}:{tier}"] == 1
    else:  # tier_stats reads the registry's Voronoi counters
        for (k, ks), entry in ((key, v) for key, v in tiers.items() if key != "host"):
            for field in ("launches", "rows", "certified", "kernel_rows"):
                assert counts[f"voronoi:{k}x{ks}:{field}"] == entry[field]
        esc = [v for key, v in tiers.items() if key != "host" and key != (32, 64)]
        assert counts.get("voronoi:escalation:rows", 0) == sum(v["rows"] for v in esc)
        assert counts.get("voronoi:escalation:certified", 0) == sum(v["certified"] for v in esc)


def test_off_path_records_nothing(system, tmp_path):
    clock.recorded_calls()
    assert clock.span("topology") is clock.span("h2d", device=True)
    _tet(*system, str(tmp_path))
    assert clock.recorded_calls() == []
    assert clock._rec is None and clock._stage_ms is None


def test_profiler_ranges_nest_as_the_spans(system, tmp_path):
    clock.recorded_calls()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with clock.stage_times():
            _tet(*system, str(tmp_path))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("wol.")]
    (call,) = clock.recorded_calls()
    spans = sorted((s for s in call.spans if not s.name.startswith("stage:")),
                   key=lambda s: s.t0)
    ranges = sorted((e for e in events if not e["name"].startswith("wol.stage:")),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [f"wol.{s.name}" for s in spans]
    marks = [e["name"][10:] for e in sorted(events, key=lambda e: e["ts"])
             if e["name"].startswith("wol.stage:")]
    assert marks == [s.name[6:] for s in sorted(call.spans, key=lambda s: s.t1)
                     if s.name.startswith("stage:")]
    by_id = {s.id: s for s in call.spans}
    rng = {s.id: e for s, e in zip(spans, ranges)}
    for s in spans[1:]:
        anc = by_id[s.parent]
        while anc.id not in rng:  # the nearest ancestor with a range
            anc = by_id[anc.parent]
        inner, outer = rng[s.id], rng[anc.id]
        assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= (
            outer["ts"] + outer["dur"]), (s.name, anc.name)

    # the export joins the profiler's trace on its time axis: each span lies
    # in its range, to the two clocks' offset (1 ms)
    merged = str(tmp_path / "merged.json")
    assert clock.export_chrome(merged, [call], profiler_trace=path) == len(call.spans)
    with open(merged) as f:
        joined = json.load(f)["traceEvents"]
    mine = {e["args"]["id"]: e for e in joined if e.get("cat") == "wol"}
    assert len(mine) == len(call.spans) and len(joined) > len(mine)
    for s in spans:
        e, r = mine[s.id], rng[s.id]
        assert r["ts"] - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"] + 1e3, s.name


def test_export_chrome_and_the_cli_option(system, tmp_path):
    top, traj, _ = system
    base = str(tmp_path / "sys")
    top.to_json(base + ".json")
    traj.save(base + ".npz", topology=top)
    out = str(tmp_path / "spans.json")
    assert cli.main(["tet", base + ".json", base + ".npz", "--device", "cpu", "--output-dir",
                     str(tmp_path), "--trace-out", out]) == 0
    assert clock.recorded_calls() == []  # the export took the recorded call
    with open(out) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ids = {e["args"]["id"]: e for e in spans}
    (root,) = [e for e in spans if e["args"]["parent"] is None]
    assert root["name"] == "call:tet_order_calc" and "baseTimeNanoseconds" in trace
    for e in spans:
        assert e["args"]["call"] == root["args"]["id"]
        if e is not root:
            p = ids[e["args"]["parent"]]
            assert p["ts"] <= e["ts"] + 1e-3 and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert {e["name"] for e in spans} >= {"topology", "device_gather", "h2d", "stage:host gather",
                                          "dispatch:order_param_q_certified", "kernel:q_window"}
    assert os.path.exists(os.path.join(tmp_path, "qDistribution_0.txt"))


def test_counts_reach_totals_spans_and_calls():
    clock.recorded_calls()
    before = clock.total("test:x")
    clock.count("test:x", 3)  # nothing recording: the process total alone
    with clock.stage_times():
        with clock.span("outer"):
            clock.count("test:x")
            with clock.span("inner"):
                clock.count("test:x", 2)
            clock.stage_end("first")
            clock.count("test:x", 4)
    (call,) = clock.recorded_calls()
    assert clock.total("test:x") == before + 10
    assert call.counts == {"test:x": 7}
    (inner,), (stage,) = call.named("inner"), call.named("stage:first")
    assert inner.counts == {"test:x": 2} and stage.counts == {"test:x": 1}
    assert inner.parent == stage.id and call.root.counts == {"test:x": 4}
    assert call.self_ms(stage) == pytest.approx(stage.ms - inner.ms, abs=1e-9)


def test_legacy_counts_take_a_reset():
    w = qtet2.q_window_plain
    w.calls = 5
    assert w.calls == 5 == clock.total("calls:q_window_plain")
    w.calls = 0
    assert w.calls == 0 and isinstance(w.calls, int)
    assert qtet2.q_window.__name__ == "q_window" and callable(qtet2.q_window)
    with pytest.raises(AttributeError):
        qtet2.no_such_name  # noqa: B018


def test_lsi_escalation_span_and_counters(monkeypatch, tmp_path):
    """`lsi_calc` on the split tier, on 512 waters with 40 of them moved
    (whole) to 1.0-3.6 A of the first oxygen: rows overfill the split
    kernel's 12 in-shell slots and some the escalation's first rung of 32.
    The call records a `lsi:escalation` span under its dispatch, holding
    the kernel spans of the redo, and counts the rows redone
    (`lsi:escalation:rows`) and those that took the last rung
    (`lsi:escalation:last`) on the call."""
    top, traj = make_water_box(512, n_frames=1, seed=9)
    wat = top.get_wat_inds()[0]
    pos = traj.positions.copy()
    rs = np.random.RandomState(9)
    dirs = rs.normal(size=(40, 3))
    off = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * rs.uniform(1.0, 3.6, (40, 1))
    movers = wat[-40:]
    pos[0, movers[:, None] + np.arange(3)] += (pos[0, wat[0]] + off - pos[0, movers])[:, None]
    monkeypatch.setattr(lsi, "split_tier", lambda *a: True)
    clock.recorded_calls()
    with clock.stage_times():
        orderparams.lsi_calc(top, Trajectory(pos, traj.boxes), output_dir=str(tmp_path),
                             device="cpu")
    (call,) = clock.recorded_calls()
    assert lsi.last_tier == "slab-split"
    assert call.counts["lsi:escalation:rows"] >= 40 and call.counts["lsi:escalation:last"] >= 1
    (esc,) = call.named("lsi:escalation")
    (disp,) = call.named("dispatch:lsi_certified")
    assert esc.parent == disp.id and esc.counts["lsi:escalation:last"] >= 1
    kernels = [s for s in call.named("kernel:lsi_split_window") if s.parent == esc.id]
    assert len(kernels) == 2  # the first rung and the last
    assert esc.device_ms is None  # on the CPU no CUDA events
