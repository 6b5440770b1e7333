"""The port's lsi_calc against the JAX package's (which takes its XLA path,
the K=24 semantics, on the CPU), its streaming, stage clock and CLI, and the
port's rules: a CUDA device that is not there raises, and options the
kernels do not have raise instead of running another path.

The system comes from each package's own `make_water_box` with the same
seed, with a third of the oxygens stored shifted by +/-L in every frame, so
the next-shell pick by raw distance matters. Means and CIs agree to 2e-5
A^2; histograms may differ by up to 4 counts per population where an LSI
value lies on a bin edge (float32 sums in another order), as the JAX
package's own kernel test allows (tests/test_pallas_kernels.py:356).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from waterorderlib_tpu.drivers import orderparams as jop
from waterorderlib_tpu.io.synthetic import make_water_box as jax_box
from waterorderlib_tpu.io.trajectory import Trajectory as JTrajectory
from waterorderlib_tpu_torch.drivers import orderparams as top_
from waterorderlib_tpu_torch.io.synthetic import make_water_box as port_box
from waterorderlib_tpu_torch.io.trajectory import Trajectory

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAT, N_FRAMES, SEED = 600, 4, 41
TOL = 2e-5


@pytest.fixture(scope="module")
def systems():
    jtop, jtraj = jax_box(N_WAT, n_frames=N_FRAMES, seed=SEED)
    ttop, _ = port_box(N_WAT, n_frames=N_FRAMES, seed=SEED)
    wat = jtop.get_wat_inds()[0]
    rs = np.random.RandomState(SEED)
    pos = jtraj.positions.copy()
    some = rs.uniform(size=(N_FRAMES, len(wat))) < 1.0 / 3.0
    pos[:, wat] += rs.randint(-1, 2, size=(N_FRAMES, len(wat), 3)) * some[..., None] * jtraj.boxes[:, None, :]
    pops = [[wat[f::2]] for f in range(N_FRAMES)]
    return (jtop, JTrajectory(pos, jtraj.boxes)), (ttop, Trajectory(pos, jtraj.boxes)), pops


def _hist(path, j):
    return np.loadtxt(os.path.join(path, f"lsiDistribution_{j}.txt"))


def test_lsi_calc_matches_jax(systems, tmp_path):
    (jtop, jtraj), (ttop, ttraj), pops = systems
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jop.lsi_calc(jtop, jtraj, sub_inds=pops, n_pops=1, output_dir=str(tmp_path / "jax"))
    got = top_.lsi_calc(ttop, ttraj, sub_inds=pops, n_pops=1, output_dir=str(tmp_path / "torch"),
                        device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):  # avgLSI, varLSI: [means, CIs]
        np.testing.assert_allclose(g[0], np.asarray(w[0]), atol=TOL)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), atol=TOL)
    for j in (0, 1):
        hg, hw = _hist(tmp_path / "torch", j), _hist(tmp_path / "jax", j)
        np.testing.assert_array_equal(hg[:, 0], hw[:, 0])
        assert hg[:, 1].sum() > 0
        assert np.abs(hg[:, 1] - hw[:, 1]).sum() <= 4


def test_chunked_matches_single_shot(systems, tmp_path):
    _, (top, traj), pops = systems
    (tmp_path / "one").mkdir()
    (tmp_path / "chunked").mkdir()
    one = top_.lsi_calc(top, traj, sub_inds=pops, n_pops=1, output_dir=str(tmp_path / "one"),
                        device="cpu")
    chunked = top_.lsi_calc(top, traj, sub_inds=pops, n_pops=1,
                            output_dir=str(tmp_path / "chunked"), device="cpu", chunk_frames=2)
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)
        np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    for j in (0, 1):
        np.testing.assert_array_equal(_hist(tmp_path / "one", j), _hist(tmp_path / "chunked", j))


def test_stage_times_name_every_step_and_change_nothing(systems, tmp_path):
    _, (top, traj), pops = systems
    plain = top_.lsi_calc(top, traj, sub_inds=pops, n_pops=1, output_dir=str(tmp_path),
                          device="cpu")
    with top_.stage_times() as ms:
        timed = top_.lsi_calc(top, traj, sub_inds=pops, n_pops=1, output_dir=str(tmp_path),
                              device="cpu")
    assert list(ms) == ["host gather", "H2D", "masks (host + H2D)", "kernel stage",
                        "stats (device)", "D2H", "savetxt", "bootstrap (host)"]
    for a, b in zip(plain, timed):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_cli_lsi_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = str(tmp_path / "sys")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "waterorderlib_tpu_torch", *a], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    gen = run("generate", "--waters", "64", "--frames", "3", "--out", base)
    assert gen.returncode == 0, gen.stderr[-2000:]
    out = run("lsi", base + ".json", base + ".npz", "--device", "cpu", "--high-cut", "3.7",
              "--output-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"avgLSI", "varLSI"}
    assert all(np.isfinite(v).all() for v in res.values())
    assert _hist(tmp_path, 0).shape == (500, 2)


def test_cuda_without_a_gpu_raises(systems, tmp_path, monkeypatch):
    _, (top, traj), _ = systems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        top_.lsi_calc(top, traj, output_dir=str(tmp_path), device="cuda")


def test_unported_options_raise(systems, tmp_path):
    _, (top, traj), _ = systems
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        top_.lsi_calc(top, traj, output_dir=str(tmp_path), device="cpu", max_neighbors=16)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        top_.lsi_calc(top, traj, output_dir=str(tmp_path), device="cpu", mesh=object())
