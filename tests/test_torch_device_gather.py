"""The order-parameter drivers' center rows, gathered on the device
(`orderparams._center_rows` inside `_frames_in`): bit for bit numpy's
`positions[:, inds, :]` cast to float32, for every selection and frame
layout, with the counters that say what was handed over; and the drivers'
outputs the same as with the rows gathered by numpy."""

import os

import numpy as np
import pytest
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import orderparams as op
from waterorderlib_tpu_torch.io.dcd import write_dcd
from waterorderlib_tpu_torch.io.synthetic import make_water_box

torch.set_num_threads(1)

N_WAT, N_FRAMES, N_SOLUTE = 64, 7, 5


@pytest.fixture(scope="module")
def box():
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=11)
    return top, traj, top.get_wat_inds()[0]


def _oxygens(pos, wat):
    return pos, wat


def _solute_ahead(pos, wat):
    solute = np.random.default_rng(3).normal(size=(pos.shape[0], N_SOLUTE, 3))
    return np.concatenate([solute.astype(np.float32), pos], axis=1), wat + N_SOLUTE


def _scattered(pos, wat):
    rs = np.random.default_rng(4)
    picks = rs.choice(pos.shape[1], size=100, replace=False)
    return pos, np.concatenate([picks, picks[[3, 17]]])  # unsorted, two duplicates


def _strided(pos, wat):
    return pos[::2], wat


def _one_atom(pos, wat):
    return pos, wat[[9]]


# name: (positions, centers) from the box; whether the memory is one run;
# the number of chunks. 7 frames of 192 atoms: the 64 oxygens' rows fill 2
# frames (chunks of 2, 2, 2, 1), 102 scattered rows 3 (3, 3, 1); the 4
# strided frames and one atom's rows fill less than one
CASES = {
    "oxygens": (_oxygens, True, 4),
    "solute_ahead": (_solute_ahead, True, 4),
    "scattered": (_scattered, True, 3),
    "strided": (_strided, False, 4),
    "one_frame_chunks": (_one_atom, True, N_FRAMES),
}


def _spy_to_device(monkeypatch):
    """Record each float array handed to `clock.to_device` (the frame runs
    and the boxes)."""
    handed = []
    orig = clock.to_device

    def to_device(x, dtype=None, device=None):
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            handed.append(x)
        return orig(x, dtype, device)

    monkeypatch.setattr(clock, "to_device", to_device)
    return handed


def _frames_in_recorded(pos, inds, sub_inds=None, n_pops=0):
    row_map = op._row_of_atom(inds, pos.shape[1])
    boxes = np.full((pos.shape[0], 3), 13.0, np.float32)
    with clock.stage_times():
        with clock.span("call:test"):
            got = op._frames_in(pos, boxes, inds, sub_inds, n_pops, row_map, "cpu")
    (call,) = clock.recorded_calls()
    return got, call


@pytest.mark.parametrize("case", sorted(CASES))
def test_center_rows_are_numpys_gather_bit_for_bit(case, box, monkeypatch):
    make, one_run, n_chunks = CASES[case]
    top, traj, wat = box
    pos, inds = make(traj.positions, wat)
    handed = _spy_to_device(monkeypatch)
    clock.recorded_calls()
    (rows, boxes_t, masks), call = _frames_in_recorded(pos, inds)
    f, nc = pos.shape[0], len(inds)
    want = pos[:, inds, :].astype(np.float32)
    assert rows.dtype == torch.float32 and rows.shape == want.shape
    assert np.array_equal(rows.numpy(), want)
    assert int(inds.min()) == (N_SOLUTE if case == "solute_ahead" else inds.min())

    runs = [a for a in handed if a.ndim == 1]
    assert len(runs) == n_chunks and len(handed) == n_chunks + 1  # and the boxes
    lo, hi = int(inds.min()), int(inds.max()) + 1
    frames, f0 = [], 0
    for run in runs:
        assert run.nbytes <= f * nc * 12  # a chunk holds at most the rows' bytes
        if one_run:  # the trajectory's own memory, atom lo of one frame to hi of another
            assert np.shares_memory(run, pos)
            frames.append((run.size // 3 - (hi - lo)) // pos.shape[1] + 1)
            flat = pos.reshape(-1)
            a = (f0 * pos.shape[1] + lo) * 3
            want_run = flat[a:a + ((frames[-1] - 1) * pos.shape[1] + hi - lo) * 3]
        else:  # the span's rows of each frame
            frames.append(run.size // ((hi - lo) * 3))
            want_run = pos[f0:f0 + frames[-1], lo:hi].reshape(-1)
        assert np.array_equal(run, want_run)
        f0 += frames[-1]
    assert f0 == f and set(frames[:-1]) <= {frames[0]} and frames[-1] <= frames[0]

    counts = call.counts
    assert counts["device_gather_bytes"] == f * nc * 12
    assert counts["block_bytes"] == sum(r.nbytes for r in runs)
    assert counts["h2d_bytes"] == (counts["block_bytes"] + f * 12 + f * nc + nc * 8)
    by_id = {s.id: s for s in call.spans}
    spans = call.named("device_gather")
    assert len(spans) == n_chunks
    assert sum(s.counts["device_gather_bytes"] for s in spans) == f * nc * 12
    assert sum(s.counts["block_bytes"] for s in spans) == counts["block_bytes"]
    assert all(by_id[s.parent].name == "stage:H2D" for s in spans)
    assert not call.named("gather") and "gather_bytes" not in counts


def test_float64_frames_are_cast_after_the_gather(box):
    _, traj, wat = box
    pos = traj.positions.astype(np.float64) + 1e-9  # values float32 rounds
    (rows, _, _), call = _frames_in_recorded(pos, wat)
    assert np.array_equal(rows.numpy(), pos[:, wat, :].astype(np.float32))
    assert call.counts["device_gather_bytes"] == N_FRAMES * len(wat) * 12


def test_masks_follow_the_populations(box):
    _, traj, wat = box
    pops = [[wat[f::4]] for f in range(N_FRAMES)]
    (_, _, masks), call = _frames_in_recorded(traj.positions, wat, pops, 1)
    assert masks.shape == (N_FRAMES, 2, len(wat)) and bool(masks[:, 0].all())
    for f in range(N_FRAMES):
        assert np.array_equal(np.flatnonzero(masks[f, 1].numpy()), np.arange(f, len(wat), 4))


def _numpy_gather(positions, inds, lo, hi, device):
    """The rows as numpy gathered them before the device gather."""
    return torch.as_tensor(positions[:, inds, :], dtype=torch.float32, device=device)


def _tet(top, traj, out, **kw):
    return op.tet_order_calc(top, traj, output_dir=out, device="cpu", **kw)


def _three_body(top, traj, out, **kw):
    return op.three_body_calc(top, traj, output_dir=out, device="cpu", **kw)


def _lsi(top, traj, out, **kw):
    return op.lsi_calc(top, traj, output_dir=out, device="cpu", **kw)


def _hex(top, traj, out, sub_inds, n_pops):
    # its centers are every other oxygen: a population of those
    ends = top.get_wat_inds()[0][1::2]
    return op.hex_order_calc(top, traj, sub_inds=[[ends[f::3]] for f in range(len(sub_inds))],
                             n_pops=n_pops, output_dir=out, device="cpu")


DRIVERS = {"tet": (_tet, "qDistribution"), "three_body": (_three_body, "3bDistribution"),
           "lsi": (_lsi, "lsiDistribution"), "hex": (_hex, "psiDistribution")}


def _outputs(fn, top, traj, out, **kw):
    os.makedirs(out)
    got = fn(top, traj, out, **kw)
    files = {name: open(os.path.join(out, name), "rb").read() for name in sorted(os.listdir(out))}
    return got, files


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_give_what_the_numpy_gather_gives(driver, box, tmp_path, monkeypatch):
    fn, stem = DRIVERS[driver]
    top, traj, wat = box
    kw = dict(sub_inds=[[wat[f::3]] for f in range(N_FRAMES)], n_pops=1)
    got, files = _outputs(fn, top, traj, str(tmp_path / "device"), **kw)
    monkeypatch.setattr(op, "_center_rows", _numpy_gather)
    want, want_files = _outputs(fn, top, traj, str(tmp_path / "numpy"), **kw)
    assert _same(got, want)
    assert files == want_files and any(name.startswith(stem) for name in files)


def test_streamed_dcd_chunks_are_gathered_on_the_device(box, tmp_path, monkeypatch):
    top, traj, wat = box
    path = str(tmp_path / "traj.dcd")
    write_dcd(path, traj)
    pops = [[wat[f::3]] for f in range(N_FRAMES)]
    chunks = []
    orig = op._center_rows

    def center_rows(positions, inds, lo, hi, device):
        rows = orig(positions, inds, lo, hi, device)
        chunks.append(np.array_equal(rows.numpy(), positions[:, inds, :]))
        return rows

    monkeypatch.setattr(op, "_center_rows", center_rows)
    clock.recorded_calls()
    with clock.stage_times():
        got, files = _outputs(_tet, top, path, str(tmp_path / "device"), sub_inds=pops,
                              n_pops=1, chunk_frames=3)
    (call,) = clock.recorded_calls()
    assert chunks == [True, True, True]  # 3 + 3 + 1 frames
    assert call.counts["device_gather_bytes"] == N_FRAMES * len(wat) * 12
    assert len(call.named("device_gather")) >= 3

    monkeypatch.setattr(op, "_center_rows", _numpy_gather)
    want, want_files = _outputs(_tet, top, path, str(tmp_path / "numpy"), sub_inds=pops,
                                n_pops=1, chunk_frames=3)
    assert _same(got, want) and files == want_files
