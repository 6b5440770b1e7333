"""The traffic's file source: a DCD file that core/dcd.py writes reads back
bit for bit through the program's readers; the traffic keys are held to
their values; a tiny run of the file cell streams each call in several
chunks and is correct; faults planted in the program's DCD reader come out
not correct."""

import numpy as np
import pytest

from bench_torch import run as run_mod
from bench_torch.core import dcd, faults, spec

CELL = "spc4096.tet_dcd"


def _frames(n_frames=37, n_atoms=23, seed=5):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n_frames, n_atoms, 3)) * 40 - 5).astype(np.float32)
    boxes = (30 + rng.random((n_frames, 3)) * 5).astype(np.float32)
    return pos, boxes


def test_header_and_size(tmp_path):
    pos, boxes = _frames()
    path = tmp_path / "t.dcd"
    n = dcd.write(str(path), pos, boxes)
    data = path.read_bytes()
    assert n == len(data) == len(dcd.header(37, 23)) + 37 * (56 + 3 * (4 * 23 + 8))
    assert data[4:8] == b"CORD"
    icntrl = np.frombuffer(data, "<i4", count=20, offset=8)
    assert icntrl[0] == 37 and icntrl[10] == 1 and icntrl[19] == dcd.CHARMM_VERSION


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_reads_back_through_the_streaming_reader(tmp_path, chunk):
    from waterorderlib_tpu_torch.io import streaming

    pos, boxes = _frames()
    path = str(tmp_path / "t.dcd")
    dcd.write(path, pos, boxes)
    got = list(streaming.iter_chunks(path, chunk))
    assert len(got) == -(-37 // chunk)
    assert np.array_equal(np.concatenate([p for p, _ in got]), pos)
    assert np.array_equal(np.concatenate([b for _, b in got]), boxes)


@pytest.mark.parametrize("native", [True, False], ids=["native_if_built", "numpy"])
def test_reads_back_through_read_dcd(tmp_path, monkeypatch, native):
    from waterorderlib_tpu_torch.io import dcd as program_dcd

    if not native:
        monkeypatch.setattr(program_dcd, "_NATIVE", False)
    pos, boxes = _frames(n_frames=300)  # more than one of the writer's blocks
    path = str(tmp_path / "t.dcd")
    dcd.write(path, pos, boxes)
    traj = program_dcd.read_dcd(path)
    assert np.array_equal(traj.positions, pos) and np.array_equal(traj.boxes, boxes)


@pytest.mark.parametrize("value", ["file", "DCD", "netcdf", None])
def test_an_unknown_source_is_refused(value):
    tr = dict(spec.traffic(spec.cell(CELL)["traffic"]), source=value)
    with pytest.raises(ValueError, match="source"):
        spec.check_traffic("t", tr)


@pytest.mark.parametrize("pool", [4097, 6144, 2048 + 1])
def test_a_pool_of_part_files_is_refused(pool):
    tr = dict(spec.traffic(spec.cell(CELL)["traffic"]), pool_frames=pool)
    with pytest.raises(ValueError, match="multiple"):
        spec.check_traffic("t", tr)


def test_memory_is_the_default_source():
    for w in spec.benchmark()["workloads"]:
        tr = spec.cell(w["name"])["traffic_spec"]
        assert spec.source(tr) == ("dcd" if w["name"] == CELL else "memory")
        assert ("source" in tr) == (w["name"] == CELL)


def _chunked(tiny, frames=4):
    cell = tiny(CELL, frames=frames)
    cell["traffic_spec"]["kwargs"]["chunk_frames"] = 1
    return cell


def test_tiny_run_reads_the_files_in_chunks(tiny, monkeypatch):
    from waterorderlib_tpu_torch.io import streaming

    reads, opened = [], []
    orig_read, orig_init = streaming.LazyDCD.read, streaming.LazyDCD.__init__

    def init(self, path):
        opened.append(path)
        orig_init(self, path)

    def read(self, start, count):
        reads.append(count)
        return orig_read(self, start, count)

    monkeypatch.setattr(streaming.LazyDCD, "__init__", init)
    monkeypatch.setattr(streaming.LazyDCD, "read", read)
    r = run_mod.Run(_chunked(tiny), 2**31 + 11, 0.5, False, "cpu")
    res = r.execute()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["checks"]["checked_calls"]["value"] >= 1
    calls = 1 + res["attempted"]  # the warm-up call and the window's
    assert len(opened) == calls and set(opened) <= set(r.files) and len(r.files) == 2
    assert reads == [1] * 4 * calls  # four chunks of one frame a call
    assert all(rec.offset % 4 == 0 for rec in r.records)


@pytest.mark.parametrize("fault", ["y_record_from_x", "box_b_from_gamma"])
def test_a_fault_in_the_program_reader_is_not_correct(tiny, monkeypatch, fault):
    """The Y record read where the X record is, or the unit cell's B edge
    read from gamma (90 degrees). Swapping the Y and Z records would be no
    test: on a cubic box it mirrors the frame, which leaves every q as it
    is."""
    faults.plant(fault, set_attr=monkeypatch.setattr)
    res = run_mod.Run(_chunked(tiny), 2**31 + 12, 0.5, False, "cpu").execute()
    assert not res["correct"], res["checks"]
