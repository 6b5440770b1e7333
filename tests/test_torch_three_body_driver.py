"""The port's three_body_calc and hex_order_calc against the JAX package's
drivers (which take their XLA path on the CPU), their streaming and CLI,
and the port's rules: a CUDA device that is not there raises, and options
the kernels do not have raise instead of running another path.

Systems come from each package's own `make_water_box` with the same seed
(the port's drivers take the port's Topology). Histograms may differ by a
few counts where an angle lies on a bin edge (the kernel path's polynomial
arccos against XLA's arccos, as the JAX package's own kernel test allows);
statistics agree to 1e-3.
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
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import orderparams as top_
from waterorderlib_tpu_torch.io.synthetic import make_water_box as port_box

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAT, N_FRAMES, SEED = 600, 3, 23

DRIVERS = {  # name -> (artifact prefix, extra keyword arguments)
    "three_body_calc": ("3bDistribution", {"output_2d": True}),
    "hex_order_calc": ("psiDistribution", {}),
}


@pytest.fixture(scope="module")
def systems():
    jtop, jtraj = jax_box(N_WAT, n_frames=N_FRAMES, seed=SEED)
    ttop, ttraj = port_box(N_WAT, n_frames=N_FRAMES, seed=SEED)
    wat = jtop.get_wat_inds()[0]
    pops = {  # one population of centers per driver
        "three_body_calc": [[wat[f::2]] for f in range(N_FRAMES)],
        "hex_order_calc": [[wat[1::2][f::2]] for f in range(N_FRAMES)],
    }
    return (jtop, jtraj), (ttop, ttraj), pops


def _hist(path, prefix, j):
    return np.loadtxt(os.path.join(path, f"{prefix}_{j}.txt"))


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_matches_jax(name, systems, tmp_path):
    (jtop, jtraj), (ttop, ttraj), pops = systems
    prefix, extra = DRIVERS[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = getattr(jop, name)(jtop, jtraj, sub_inds=pops[name], n_pops=1,
                              output_dir=str(tmp_path / "jax"), **extra)
    got = getattr(top_, name)(ttop, ttraj, sub_inds=pops[name], n_pops=1,
                              output_dir=str(tmp_path / "torch"), device="cpu", **extra)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # [means, CIs] per statistic
        np.testing.assert_allclose(g[0], np.asarray(w[0]), atol=1e-3)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), atol=1e-3)
    for j in (0, 1):
        hg, hw = _hist(tmp_path / "torch", prefix, j), _hist(tmp_path / "jax", prefix, j)
        np.testing.assert_array_equal(hg[:, 0], hw[:, 0])
        assert hg[:, 1].sum() > 0
        assert np.abs(hg[:, 1] - hw[:, 1]).sum() <= 8  # arccos boundary-bin flips
    if name == "three_body_calc":
        h2 = [np.loadtxt(tmp_path / d / "3bDistribution_2D.txt") for d in ("torch", "jax")]
        assert h2[0].shape == (14, 500)
        np.testing.assert_allclose(h2[0], h2[1], atol=1e-3)


@pytest.mark.parametrize("name", list(DRIVERS))
def test_chunked_with_checkpoint_matches_single_shot(name, systems, tmp_path):
    _, (top, traj), pops = systems
    prefix, extra = DRIVERS[name]
    (tmp_path / "one").mkdir()
    (tmp_path / "chunked").mkdir()
    fn = getattr(top_, name)
    one = fn(top, traj, sub_inds=pops[name], n_pops=1, output_dir=str(tmp_path / "one"),
             device="cpu", **extra)
    ck = str(tmp_path / "ck.npz")
    chunked = fn(top, traj, sub_inds=pops[name], n_pops=1,
                 output_dir=str(tmp_path / "chunked"), device="cpu", chunk_frames=2,
                 checkpoint=ck, **extra)
    assert not os.path.exists(ck)  # removed on success
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)
        np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    for j in (0, 1):
        np.testing.assert_array_equal(_hist(tmp_path / "one", prefix, j),
                                      _hist(tmp_path / "chunked", prefix, j))


@pytest.mark.parametrize("name", list(DRIVERS))
def test_stage_times_name_every_step_and_change_nothing(name, systems, tmp_path):
    _, (top, traj), pops = systems
    _, extra = DRIVERS[name]
    fn = getattr(top_, name)
    plain = fn(top, traj, sub_inds=pops[name], n_pops=1, output_dir=str(tmp_path),
               device="cpu", **extra)
    with top_.stage_times() as ms:
        timed = fn(top, traj, sub_inds=pops[name], n_pops=1, output_dir=str(tmp_path),
                   device="cpu", **extra)
    assert list(ms) == ["host gather", "H2D", "masks (host + H2D)", "kernel stage",
                        "stats (device)", "D2H", "savetxt", "bootstrap (host)"]
    assert all(v >= 0.0 for v in ms.values())
    for a, b in zip(plain, timed):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert clock._stage_ms is None  # the clock is off after the block


@pytest.mark.parametrize("cmd,prefix,keys", [
    ("3body", "3bDistribution", {"pTet", "entropy"}),
    ("psi", "psiDistribution", {"avgPsi"}),
])
def test_cli_on_cpu(cmd, prefix, keys, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = str(tmp_path / "sys")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "waterorderlib_tpu_torch", *a], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    gen = run("generate", "--waters", "64", "--frames", "3", "--out", base)
    assert gen.returncode == 0, gen.stderr[-2000:]
    out = run(cmd, base + ".json", base + ".npz", "--device", "cpu", "--output-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == keys
    assert all(np.isfinite(v).all() for v in res.values())
    assert _hist(tmp_path, prefix, 0).shape == (500, 2)


@pytest.mark.parametrize("name", list(DRIVERS))
def test_cuda_without_a_gpu_raises(name, systems, tmp_path, monkeypatch):
    _, (top, traj), _ = systems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(top_, name)(top, traj, output_dir=str(tmp_path), device="cuda")


@pytest.mark.parametrize("name,k", [("three_body_calc", 12), ("hex_order_calc", 16)])
def test_unported_options_raise(name, k, systems, tmp_path):
    _, (top, traj), _ = systems
    fn = getattr(top_, name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(top, traj, output_dir=str(tmp_path), device="cpu", max_neighbors=k)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        fn(top, traj, output_dir=str(tmp_path), device="cpu", mesh=object())
