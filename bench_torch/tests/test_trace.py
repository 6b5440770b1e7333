"""The profiler trace reader on a synthetic Chrome trace: device work is
attributed to the dispatch range through its runtime call, busy time is a
union, and idle time is split by the program stage the host was in."""

import json

import pytest

from bench_torch.core import trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read(tmp_path):
    ev = [
        _x("user_annotation", "bench.call", 0, 1000),
        _x("user_annotation", "bench.stage:host gather", 300, 0),
        _x("user_annotation", "bench.dispatch", 300, 200),
        _x("user_annotation", "bench.stage:kernel stage", 500, 0),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 5, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 100, 5, corr=3),
        _x("kernel", "k_one", 400, 50, corr=1),
        _x("kernel", "k_two", 440, 30, corr=2),      # overlaps k_one: busy is a union
        _x("gpu_memcpy", "Memcpy HtoD", 150, 100, corr=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    p = trace.read(str(path))
    assert p.dispatch_s == pytest.approx(80e-6) and p.dispatch_kernels == 2
    assert p.busy_s == pytest.approx(170e-6) and p.window_s == pytest.approx(1000e-6)
    assert p.idle_share == pytest.approx(1 - 0.17)
    idle = dict(p.idle_by_stage)
    # idle 0-150, 250-400 and 470-1000: host gather ends at 300, the kernel stage at 500
    assert idle["host gather"] == pytest.approx(200e-6)
    assert idle["kernel stage"] == pytest.approx(130e-6)
    assert idle["(after the last stage)"] == pytest.approx(500e-6)
    assert dict(p.device_ops)["Memcpy HtoD"] == pytest.approx(100e-6)


def test_no_call_range_raises(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(RuntimeError):
        trace.read(str(path))


def test_every_dispatch_range_is_summed(tmp_path):
    """A chunked driver's call holds one dispatch range a chunk: the work
    and kernels of each count, not the first range's alone."""
    ev = [_x("user_annotation", "bench.call", 0, 1000)]
    for i in range(4):
        t = 100 + 200 * i
        ev += [_x("user_annotation", "bench.dispatch", t, 50),
               _x("cuda_runtime", "cudaLaunchKernel", t + 10, 5, corr=i),
               _x("kernel", f"k{i}", t + 60, 20 + i, corr=i)]
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 950, 5, corr=9))  # outside any range
    ev.append(_x("kernel", "k_out", 960, 10, corr=9))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    p = trace.read(str(path))
    assert p.dispatch_ranges == 4 and p.dispatch_kernels == 4
    assert p.dispatch_s == pytest.approx((20 + 21 + 22 + 23) * 1e-6)
