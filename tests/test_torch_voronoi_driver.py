"""The port's voronoi_calc (drivers/voronoi_driver.py) and the `voronoi`
CLI against waterorderlib_tpu.drivers.voronoi_driver.voronoi_calc.

Tolerances: the host engine is the same float64 Qhull code on the same
positions, so its six [means, CIs] and histogram files equal the JAX
driver's exactly. The device engine's cells agree with the JAX package's
within 1e-5 relative (XLA's fmas against the port's plain products, see
tests/test_torch_voronoi_device.py), so its means and CIs agree within
1e-5 relative (1e-6 absolute where a value is near 0) and each histogram
file may put a value on a bin edge into the neighboring bin: such flips
are listed, at most 2 a file. Chunking changes nothing: exactly equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from waterorderlib_tpu.drivers import voronoi_driver as jdrv
from waterorderlib_tpu.io.synthetic import make_water_box as jax_water_box
from waterorderlib_tpu_torch.drivers import voronoi_driver as tdrv
from waterorderlib_tpu_torch.io.synthetic import make_water_box

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAT, N_FRAMES = 27, 4
FILES = ("VolDistribution", "AreaDistribution", "EtaDistribution")


def _pops(top, n_pops):
    if not n_pops:
        return None
    wat = top.get_wat_inds()[0]
    return [[wat[:5]] for _ in range(N_FRAMES)]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("n_pops", [0, 1])
def test_voronoi_calc_matches_jax(tmp_path, engine, n_pops):
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=41)
    jtop, jtraj = jax_water_box(N_WAT, n_frames=N_FRAMES, seed=41)
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dt.mkdir()
    ref = jdrv.voronoi_calc(jtop, jtraj, sub_inds=_pops(jtop, n_pops), n_pops=n_pops,
                            output_dir=str(dj), engine=engine)
    out = tdrv.voronoi_calc(top, traj, sub_inds=_pops(top, n_pops), n_pops=n_pops,
                            output_dir=str(dt), engine=engine, device="cpu")
    assert len(out) == 6
    for a, b in zip(out, ref):
        for x, y in zip(a, b):
            if engine == "host":
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for j in range(n_pops + 1):
        for name in FILES:
            a = np.loadtxt(dt / f"{name}_{j}.txt")
            b = np.loadtxt(dj / f"{name}_{j}.txt")
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            flips = np.where(a[:, 1] != b[:, 1])[0]
            assert len(flips) <= (0 if engine == "host" else 2), (name, j, flips)
    vol_per_water = float(np.prod(traj.boxes[0].astype(float))) / N_WAT
    assert abs(out[0][0][0] - vol_per_water) / vol_per_water < 0.25


@pytest.mark.parametrize("n_pops", [0, 1])
def test_voronoi_calc_one_frame_device_matches_jax(tmp_path, n_pops):
    """One frame on the device engine (a frame batch of one) against the JAX
    driver, with the tolerances of test_voronoi_calc_matches_jax."""
    top, traj = make_water_box(N_WAT, n_frames=1, seed=43)
    jtop, jtraj = jax_water_box(N_WAT, n_frames=1, seed=43)
    pops = lambda t: [[t.get_wat_inds()[0][:5]]] if n_pops else None
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dt.mkdir()
    ref = jdrv.voronoi_calc(jtop, jtraj, sub_inds=pops(jtop), n_pops=n_pops,
                            output_dir=str(dj), engine="device")
    out = tdrv.voronoi_calc(top, traj, sub_inds=pops(top), n_pops=n_pops,
                            output_dir=str(dt), engine="device", device="cpu")
    assert len(out) == 6
    for a, b in zip(out, ref):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for j in range(n_pops + 1):
        for name in FILES:
            a = np.loadtxt(dt / f"{name}_{j}.txt")
            b = np.loadtxt(dj / f"{name}_{j}.txt")
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            flips = np.where(a[:, 1] != b[:, 1])[0]
            assert len(flips) <= 2, (name, j, flips)
    vol_per_water = float(np.prod(traj.boxes[0].astype(float))) / N_WAT
    assert abs(out[0][0][0] - vol_per_water) / vol_per_water < 0.25


def test_voronoi_calc_chunk_invariant(tmp_path):
    """chunk_frames=1 against one chunk of all frames and the default: the
    same six results, exactly."""
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=45)
    kw = dict(output_dir=str(tmp_path), engine="device", device="cpu")
    res_all = tdrv.voronoi_calc(top, traj, chunk_frames=N_FRAMES, **kw)
    res_one = tdrv.voronoi_calc(top, traj, chunk_frames=1, **kw)
    res_def = tdrv.voronoi_calc(top, traj, **kw)
    for a, b, c in zip(res_all, res_one, res_def):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_pick_engine_port_rule(monkeypatch):
    """"auto" takes the device cells on a CUDA device from 2048 points on,
    the host tessellation otherwise; explicit engines stand."""
    assert tdrv._pick_engine("auto", 100_000, "cpu") == "host"
    assert tdrv._pick_engine("device", 10, "cpu") == "device"
    assert tdrv._pick_engine("host", 100_000, "cpu") == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdrv._pick_engine("auto", 2048, "cuda") == "device"
    assert tdrv._pick_engine("auto", 2047, "cuda") == "host"
    with pytest.raises(ValueError):
        tdrv._pick_engine("qhull", 10, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv._pick_engine("auto", 4096, "cuda")


def test_voronoi_calc_not_ported_options(tmp_path):
    top, traj = make_water_box(8, n_frames=1, seed=1)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        tdrv.voronoi_calc(top, traj, output_dir=str(tmp_path), mesh=object(), device="cpu")


def test_voronoi_cli(tmp_path):
    """The `voronoi` subcommand in a subprocess, on the device engine (plain
    versions on the CPU), against the driver called in-process."""
    top, traj = make_water_box(N_WAT, n_frames=2, seed=3)
    base = str(tmp_path / "sys")
    top.to_json(base + ".json")
    traj.save(base + ".npz", topology=top)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "waterorderlib_tpu_torch", "voronoi", base + ".json",
         base + ".npz", "--engine", "device", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = tdrv.voronoi_calc(top, traj, output_dir=str(tmp_path), engine="device", device="cpu")
    assert got["avgVol"] == want[0][0].tolist()
    assert got["avgArea"] == want[2][0].tolist() and got["avgEta"] == want[4][0].tolist()
    assert (tmp_path / "VolDistribution_0.txt").exists()


# --- the contact drivers ------------------------------------------------------
# contact_area_calc and hydrated_volume_calc against the JAX drivers: the host
# engine runs the same float64 Qhull code, so its results are equal exactly;
# the device engine's cells agree within 1e-5 (see
# tests/test_torch_voronoi_contacts.py), so its means and CIs do within 1e-5
# relative (1e-6 absolute near 0). JAX's "device" engine runs its clip
# builder on the CPU, one frame at a time (no chunk_frames); the port's
# batches frames.

C_SOLUTE = ["C", "C", "O", "C", "N", "C"]


def _contact_system(seed=51, n_frames=3):
    return (make_water_box(60, n_frames=n_frames, seed=seed, solute_elements=C_SOLUTE),
            jax_water_box(60, n_frames=n_frames, seed=seed, solute_elements=C_SOLUTE))


def _flat(res):
    out = []
    for x in res:
        out.extend(np.ravel(np.asarray(x, np.float64)).tolist() if np.ndim(x) or
                   not isinstance(x, (list, tuple)) else _flat(x))
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_contact_drivers_match_jax(engine):
    (top, traj), (jtop, jtraj) = _contact_system()
    for name in ("contact_area_calc", "hydrated_volume_calc"):
        want = _flat(getattr(jdrv, name)(jtop, jtraj, engine=engine))
        got = _flat(getattr(tdrv, name)(top, traj, engine=engine, device="cpu"))
        assert got.shape == want.shape and got.size >= 4
        if engine == "host":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_contact_drivers_rows_equal_dense():
    """The drivers read only the solute's rows: their numbers equal those
    computed from the dense symmetrized matrices of
    `voronoi_contacts_hybrid_frames`, exactly."""
    from waterorderlib_tpu_torch.drivers.hbonds_driver import get_bound_wrap
    from waterorderlib_tpu_torch.stats import blocks
    from waterorderlib_tpu_torch.surface.voronoi_device import voronoi_contacts_hybrid_frames

    (top, traj), _ = _contact_system(seed=52)
    heavy = top.get_heavy_inds()
    row_of = {int(a): i for i, a in enumerate(heavy)}
    sol_inds = top.get_sol_inds()[0]
    sol = np.array([row_of[int(a)] for a in sol_inds])
    pos = np.asarray(traj.positions[:, heavy], np.float32)
    dense = list(voronoi_contacts_hybrid_frames(pos, traj.boxes[:, 0], len(heavy), rows=sol,
                                                device="cpu"))
    vols = np.array([d[3][0, sol].sum() for d in dense])
    areas = np.array([d[2][0, sol].sum() for d in dense])
    want_h = blocks.mean_and_ci(vols, seed=0), blocks.mean_and_ci(areas, seed=0)
    got_h = tdrv.hydrated_volume_calc(top, traj, engine="device", device="cpu")
    np.testing.assert_array_equal(_flat(got_h), _flat(want_h))
    # contact_area_calc's phobic total, from the dense rows as the JAX driver reads them
    phobic = np.array([row_of[int(a)] for a in top.get_phobic_inds() if int(a) in row_of])
    own = [set(row_of[int(m)] for m in np.where((top.res_ids == top.res_ids[a])
                                                 & (top.elements != "H"))[0]) for a in sol_inds]
    tot = np.zeros(len(dense))
    pho = np.zeros(len(dense))
    for t, d in enumerate(dense):
        for i, s in enumerate(sol):
            row = d[0][s, :]
            tot[t] += row.sum() / 2.0
            mask = np.zeros(len(row), bool)
            mask[phobic] = True
            mask[list(own[i])] = False
            pho[t] += row[mask].sum() / 2.0
    got_c = tdrv.contact_area_calc(top, traj, engine="device", device="cpu")
    assert got_c[0][0] == float(np.mean(tot)) and got_c[0][1] == float(np.mean(pho))
    assert len(get_bound_wrap(top, traj, device="cpu")) == traj.n_frames


def test_contact_drivers_chunk_invariant():
    (top, traj), _ = _contact_system(seed=53, n_frames=4)
    for fn in (tdrv.contact_area_calc, tdrv.hydrated_volume_calc):
        one = _flat(fn(top, traj, engine="device", chunk_frames=1, device="cpu"))
        two = _flat(fn(top, traj, engine="device", chunk_frames=2, device="cpu"))
        default = _flat(fn(top, traj, engine="device", device="cpu"))
        np.testing.assert_array_equal(one, default)
        np.testing.assert_array_equal(two, default)


def test_contact_drivers_not_ported_options(monkeypatch):
    (top, traj), _ = _contact_system(n_frames=1)
    for fn in (tdrv.contact_area_calc, tdrv.hydrated_volume_calc):
        with pytest.raises(NotImplementedError, match="queue 1 item 15"):
            fn(top, traj, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv.hydrated_volume_calc(top, traj, engine="device")


def test_contactarea_cli(tmp_path):
    """The `contactarea` subcommand in a subprocess (device engine, plain
    versions on the CPU) prints the JAX CLI's JSON, equal to the driver
    called in-process."""
    (top, traj), _ = _contact_system(seed=54, n_frames=2)
    base = str(tmp_path / "sys")
    top.to_json(base + ".json")
    traj.save(base + ".npz", topology=top)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "waterorderlib_tpu_torch", "contactarea", base + ".json",
         base + ".npz", "--engine", "device", "--device", "cpu", "--cutoff", "4.0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    tot, _, frac, _ = tdrv.contact_area_calc(top, traj, engine="device", device="cpu")
    assert got == {"totArea": tot, "fracArea": frac}
