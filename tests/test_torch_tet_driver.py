"""The port's tet_order_calc against the JAX package's, its streaming and
CLI, and the port's rules: it imports nothing of the JAX package (its
copies of the jax-free modules reproduce them), and it never falls back to
the CPU when a CUDA device is asked for."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from waterorderlib_tpu.drivers import orderparams as jop
from waterorderlib_tpu.io.synthetic import make_water_box as jax_box
from waterorderlib_tpu.stats import blocks as jblocks
from waterorderlib_tpu_torch.drivers import orderparams as top_
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.ops.cuda import qtet2 as tqtet2
from waterorderlib_tpu_torch.stats import blocks as tblocks

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAT, N_FRAMES = 512, 4


@pytest.fixture(scope="module")
def system():
    top, traj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=2)
    wat_inds, _, _ = top.get_wat_inds()
    sub_inds = [[wat_inds[f::3]] for f in range(N_FRAMES)]
    return top, traj, sub_inds


def _hist(path, j):
    return np.loadtxt(os.path.join(path, f"qDistribution_{j}.txt"))


def test_tet_order_calc_matches_jax(system, tmp_path):
    top, traj, sub_inds = system
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jtop, jtraj = jax_box(N_WAT, n_frames=N_FRAMES, seed=2)
    want = jop.tet_order_calc(jtop, jtraj, sub_inds=sub_inds, n_pops=1,
                              output_dir=str(tmp_path / "jax"))
    got = top_.tet_order_calc(top, traj, sub_inds=sub_inds, n_pops=1,
                              output_dir=str(tmp_path / "torch"), device="cpu")
    for g, w in zip(got, want):  # avgQ, varQ: [means, CIs]
        np.testing.assert_allclose(g[0], w[0], atol=1e-5)
        np.testing.assert_allclose(g[1], w[1], atol=1e-5)

    # histogram counts agree except where a q value lies within 1e-5 of a
    # bin edge (float32 rounding may put it on either side)
    wat_inds, _, _ = top.get_wat_inds()
    pos = torch.as_tensor(traj.positions[:, wat_inds, :])
    q = tqtet2.order_param_q_certified(pos, torch.as_tensor(traj.boxes)).numpy()
    edges = np.linspace(0.0, 1.0, 501)
    near = np.abs(q[..., None] - edges).min(axis=-1) < 1e-5
    masks = [np.ones(q.shape, bool),
             np.stack([np.isin(wat_inds, sub_inds[f][0]) for f in range(N_FRAMES)])]
    for j in (0, 1):
        hg, hw = _hist(tmp_path / "torch", j), _hist(tmp_path / "jax", j)
        np.testing.assert_array_equal(hg[:, 0], hw[:, 0])
        assert hg[:, 1].sum() > 0
        assert np.abs(hg[:, 1] - hw[:, 1]).sum() <= 2 * int((near & masks[j]).sum())


def test_chunked_with_checkpoint_matches_single_shot(system, tmp_path):
    top, traj, sub_inds = system
    (tmp_path / "one").mkdir()
    (tmp_path / "chunked").mkdir()
    one = top_.tet_order_calc(top, traj, sub_inds=sub_inds, n_pops=1,
                              output_dir=str(tmp_path / "one"), device="cpu")
    ck = str(tmp_path / "ck.npz")
    chunked = top_.tet_order_calc(top, traj, sub_inds=sub_inds, n_pops=1,
                                  output_dir=str(tmp_path / "chunked"), device="cpu",
                                  chunk_frames=2, checkpoint=ck)
    assert not os.path.exists(ck)  # removed on success
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)
        np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    for j in (0, 1):
        np.testing.assert_array_equal(_hist(tmp_path / "one", j), _hist(tmp_path / "chunked", j))


def test_cli_tet_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = str(tmp_path / "sys")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "waterorderlib_tpu_torch", *a], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    gen = run("generate", "--waters", "64", "--frames", "3", "--out", base)
    assert gen.returncode == 0, gen.stderr[-2000:]
    out = run("tet", base + ".json", base + ".npz", "--device", "cpu",
              "--output-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"avgQ", "avgQ_CI", "varQ"}
    assert np.isfinite(res["avgQ"]).all()
    assert _hist(tmp_path, 0).shape == (500, 2)


def test_port_imports_no_jax(tmp_path):
    """Importing the port and running its drivers (the four order
    parameters, hb_calc, get_bound_wrap, density_grid, sasa_grid,
    density_voxel, sasa_per_atom, sasa_calc and sphere_volumes), the
    earlier q kernels (dense, frames, v1 slab), voronoi_calc,
    contact_area_calc and hydrated_volume_calc (device and host engines:
    scipy, not jax) leaves jax, and every module of the JAX package, out of
    sys.modules."""
    import __graft_entry__ as g

    code = (
        "import sys\n"
        "from waterorderlib_tpu_torch.io.synthetic import make_water_box\n"
        "import waterorderlib_tpu_torch.__main__, waterorderlib_tpu_torch.interop\n"
        "from waterorderlib_tpu_torch.drivers import orderparams as op\n"
        "top, traj = make_water_box(64, n_frames=2, seed=0)\n"
        "for fn in (op.tet_order_calc, op.three_body_calc, op.hex_order_calc, op.lsi_calc):\n"
        f"    fn(top, traj, output_dir={str(tmp_path)!r}, device='cpu')\n"
        "from waterorderlib_tpu_torch.drivers import hbonds_driver as hd\n"
        "stop, straj = make_water_box(64, n_frames=2, seed=0, solute_elements=['C', 'O', 'H'])\n"
        f"hd.hb_calc(stop, straj, output_dir={str(tmp_path)!r}, device='cpu')\n"
        "assert len(hd.get_bound_wrap(stop, straj, device='cpu')) == 2\n"
        "from waterorderlib_tpu_torch.surface import grids, plotting\n"
        "w, s = top.get_wat_inds()[0], stop.get_sol_inds()[0]\n"
        "p, sp, b = traj.positions[0], straj.positions[0], traj.boxes[0]\n"
        "assert len(grids.density_grid(sp[s], p[w], b, level=0.03, n_bins=17, device='cpu')[1])\n"
        "assert len(grids.sasa_grid(sp[s], b, [2.0] * len(s), n_bins=12, device='cpu')[1])\n"
        "assert grids.density_voxel(sp[s], p[w], b, device='cpu').shape == (10, 10, 10)\n"
        "import torch\n"
        "from waterorderlib_tpu_torch.core import geometry\n"
        "from waterorderlib_tpu_torch.surface import sasa\n"
        "from waterorderlib_tpu_torch.ops.cuda import qtet_kernel, qtet_sorted\n"
        "assert sasa.sasa_per_atom(p[w], [1.5] * len(w), b, n_points=60, device='cpu')[0].shape == (64,)\n"
        "assert sasa.sasa_calc(p[w], b, [1.5] * len(w), n_points=20, device='cpu')[2].shape == (64,)\n"
        "assert sasa.sphere_volumes(p[w], [1.5] * len(w), 0.5, 16, device='cpu').shape == (64,)\n"
        "assert geometry.sphere_points(10).shape == (10, 3)\n"
        "tp, tb = torch.as_tensor(traj.positions[:, w]), torch.as_tensor(traj.boxes)\n"
        "assert qtet_kernel.order_param_q_dense(tp[0], tb[0])[1].shape == (500,)\n"
        "assert qtet_kernel.order_param_q_dense_frames(tp, tb)[0].shape == (2, 64)\n"
        "assert qtet_sorted.order_param_q_sorted(tp, tb, pad=64)[0].shape == (2, 64)\n"
        "assert qtet_sorted.order_param_q_sorted_traj(tp, tb, pad=64)[0].shape == (2, 64)\n"
        "from waterorderlib_tpu_torch.drivers.voronoi_driver import (\n"
        "    contact_area_calc, hydrated_volume_calc, voronoi_calc)\n"
        "for eng in ('device', 'host'):\n"
        f"    assert len(voronoi_calc(top, traj, output_dir={str(tmp_path)!r}, engine=eng,\n"
        "                            device='cpu')) == 6\n"
        "    assert len(contact_area_calc(stop, straj, engine=eng, device='cpu')) == 4\n"
        "    assert len(hydrated_volume_calc(stop, straj, engine=eng, device='cpu')) == 2\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'waterorderlib_tpu' or m.startswith('waterorderlib_tpu.')]\n"
        "assert not bad, bad\n"
        "print('no-jax ok')\n"
    )
    env = g._child_env(dict(os.environ), 1)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "no-jax ok" in out.stdout


def test_cuda_without_a_gpu_raises(system, tmp_path, monkeypatch):
    top, traj, _ = system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        top_.tet_order_calc(top, traj, output_dir=str(tmp_path), device="cuda")


def test_mesh_is_not_ported(system, tmp_path):
    top, traj, _ = system
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        top_.tet_order_calc(top, traj, output_dir=str(tmp_path), device="cpu", mesh=object())


def test_port_synthetic_reproduces_jax_systems():
    """The port's copy of io.synthetic builds, for a seed, the system the
    JAX package builds; stats.blocks gives the same intervals."""
    jtop, jtraj = jax_box(N_WAT, n_frames=N_FRAMES, seed=2, solute_elements=["C", "O"])
    ttop, ttraj = make_water_box(N_WAT, n_frames=N_FRAMES, seed=2, solute_elements=["C", "O"])
    np.testing.assert_array_equal(ttraj.positions, jtraj.positions)
    np.testing.assert_array_equal(ttraj.boxes, jtraj.boxes)
    for t, j in zip(ttop.get_wat_inds(), jtop.get_wat_inds()):
        np.testing.assert_array_equal(t, j)
    series = np.random.RandomState(4).normal(size=50)
    assert tblocks.block_average(series, seed=0) == jblocks.block_average(series, seed=0)
