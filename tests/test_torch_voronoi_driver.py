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
