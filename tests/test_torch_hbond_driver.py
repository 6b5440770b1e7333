"""The port's H-bond drivers (hb_calc, get_bound_wrap, the cluster, ion and
neighbor statistics, cached_bound_wrap and the hb/boundwrap CLI) against
the JAX package's, on CPU tensors.

The JAX package runs `general_hbonds` (the arccos form) here; the port runs
the counting kernels' plain versions (the cosine-threshold form). The two
criteria differ only on the measure-zero angle boundary, so the count
histograms are held equal as text. The averages are float32 means of
integer totals summed in another order: within 1e-6 relative.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from waterorderlib_tpu.drivers import hbonds_driver as jhd
from waterorderlib_tpu.io.synthetic import make_water_box as jax_box
from waterorderlib_tpu.io.topology import Topology as JTopology
from waterorderlib_tpu.io.trajectory import Trajectory as JTrajectory
from waterorderlib_tpu_torch.drivers import cache, orderparams
from waterorderlib_tpu_torch.drivers import hbonds_driver as thd
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WAT, N_FRAMES = 512, 4
SOLUTE = ["C", "O", "H", "N", "H", "C"]  # one O acceptor/donor, one N acceptor, two N donors


def _systems(solute, seed=13):
    return (make_water_box(N_WAT, n_frames=N_FRAMES, seed=seed, solute_elements=solute),
            jax_box(N_WAT, n_frames=N_FRAMES, seed=seed, solute_elements=solute))


def _text(d, name):
    with open(os.path.join(d, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("solute", [None, SOLUTE], ids=["water", "cosolvent"])
def test_hb_calc_matches_jax(solute, tmp_path):
    (top, traj), (jtop, jtraj) = _systems(solute)
    for d in ("jax", "torch", "chunked"):
        (tmp_path / d).mkdir()
    want = jhd.hb_calc(jtop, jtraj, output_dir=str(tmp_path / "jax"))
    got = thd.hb_calc(top, traj, output_dir=str(tmp_path / "torch"), device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] > 2.0 and (got[1] > 0) == (solute is not None)
    for name in ("hbDistribution_water.txt", "hbDistribution_cosolv.txt"):
        assert _text(tmp_path / "torch", name) == _text(tmp_path / "jax", name)
    hist = np.loadtxt(tmp_path / "torch" / "hbDistribution_water.txt")
    assert hist.shape == (10, 2) and hist[:, 1].sum() == N_WAT * N_FRAMES
    # with no cosolvent, one 0 per frame in bin 0, as the JAX driver writes
    cos = np.loadtxt(tmp_path / "torch" / "hbDistribution_cosolv.txt")
    assert cos[:, 1].sum() == N_FRAMES
    # streaming in chunks of 3 frames gives the same run
    chunked = thd.hb_calc(top, traj, output_dir=str(tmp_path / "chunked"), device="cpu",
                          chunk_frames=3)
    assert chunked == got
    for name in ("hbDistribution_water.txt", "hbDistribution_cosolv.txt"):
        assert _text(tmp_path / "chunked", name) == _text(tmp_path / "torch", name)


def test_hb_calc_runs_all_nine_sets_through_the_counts(monkeypatch, tmp_path):
    """The water-water set through the certified dispatch, the eight
    cosolvent sets through hbond_counts, each once over all frames."""
    (top, traj), _ = _systems(SOLUTE)
    calls = []
    real = thd.hbond.hbond_counts

    def spy(acc, don, *a):
        calls.append((acc.shape[0], acc.shape[1], don.shape[1]))
        return real(acc, don, *a)

    monkeypatch.setattr(thd.hbond, "hbond_counts", spy)
    thd.hb_calc(top, traj, output_dir=str(tmp_path), device="cpu")
    assert len(calls) == 9 and all(c[0] == N_FRAMES and c[1] and c[2] for c in calls)
    assert calls[0] == (N_FRAMES, N_WAT, 2 * N_WAT) and thd.hbond.last_tier == "dense"


@pytest.mark.parametrize("solute", [None, SOLUTE], ids=["water", "cosolvent"])
def test_hb_sets_match_the_reference_walk(solute):
    """hb_sets' index tensors equal, element for element, the triplets of
    the JAX package's per-atom walk on the same system."""
    (top, _), (jtop, _) = _systems(solute)
    sets, n_sol, has_sol = thd.hb_sets(top, "WAT", "cpu")
    sol, _, _, sol_n, sol_o, _ = jtop.get_sol_inds("WAT")
    hb_o, hb_n = jtop.get_hb_inds(sol_n, sol_o)
    want = [jtop.get_hb_inds(np.array([], int), jtop.get_wat_inds("WAT")[0])[0]]
    want += [hb_o, hb_n] if solute else [None, None]
    assert (n_sol, has_sol) == ((1, True) if solute else (0, False))
    for got_set, want_set in zip(sets, want):
        if want_set is None:
            assert got_set is None
            continue
        for g, w in zip(got_set, want_set):
            assert g.dtype == torch.int64 and g.device.type == "cpu"
            assert torch.equal(g, torch.as_tensor(np.asarray(w, np.int64)))
    assert len(sets[0][1]) == 2 * N_WAT and (not solute or len(sets[2][1]) == 2)


def test_get_bound_wrap_matches_jax():
    (top, traj), (jtop, jtraj) = _systems(SOLUTE)
    got = thd.get_bound_wrap(top, traj, device="cpu")
    want = jhd.get_bound_wrap(jtop, jtraj)
    assert len(got) == N_FRAMES
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(len(f[2]) for f in got) > 0 and sum(len(f[0]) for f in got) > 0
    one = thd.get_bound_wrap(top, traj, frame_index=0, device="cpu")
    for a, b in zip(one, jhd.get_bound_wrap(jtop, jtraj, frame_index=0)):
        np.testing.assert_array_equal(a, b)
    func1 = thd.bound_wrap_func1(top, traj, frame_index=1, device="cpu")
    for a, b in zip(func1, jhd.bound_wrap_func1(jtop, jtraj, frame_index=1)):
        np.testing.assert_array_equal(a, b)


def test_bound_wrap_counts_equal_the_arccos_form():
    """The plain bound_wrap_masks with general_hbond_counts (the reference
    chip_smoke.py holds the card's masks against) gives the same masks."""
    from waterorderlib_tpu_torch.hbonds import bonds, populations

    (top, traj), _ = _systems(SOLUTE)
    wat = top.get_wat_inds()[0]
    _, (_, _, donh) = thd._water_triplets(top, "WAT")
    sol, (a, d, dh), _ = thd._sol_hb_triplets(top, "WAT")
    p, b = torch.as_tensor(traj.positions), torch.as_tensor(traj.boxes)
    args = [p[:, i] for i in (wat, donh, sol, a, d, dh)] + [b]
    got = populations.bound_wrap_masks(*args)
    ref = populations.bound_wrap_masks(*args, counts=bonds.general_hbond_counts)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_hb_cluster_stats_matches_jax(tmp_path):
    (top, traj), (jtop, jtraj) = _systems(None, seed=15)
    _, (acc, don, donh) = thd._water_triplets(top, "WAT")
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jhd.get_hb_cluster_stats(jtop, jtraj, acc, don, donh, output_dir=str(tmp_path / "jax"))
    got = thd.get_hb_cluster_stats(top, traj, acc, don, donh, output_dir=str(tmp_path / "torch"),
                                   device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    name = "clusterDistribution.txt"
    assert _text(tmp_path / "torch", name) == _text(tmp_path / "jax", name)
    assert got[0] >= 1.0


def _two_residue_system(jax_types):
    """Residue 0 holds acceptors A1 and A2, residue 1 a donor D with its H:
    A1 bonds D (2.8 A, linear), A2 (listed after A1) lies 6 A away. The
    residue adjacency must hold the bond: a scatter that lets A2's False
    overwrite A1's True loses it."""
    names, elements = ["O1", "O2", "O", "H1"], ["O", "O", "O", "H"]
    top_cls, traj_cls = (JTopology, JTrajectory) if jax_types else (Topology, Trajectory)
    top = top_cls(names=np.array(names, dtype=object), elements=np.array(elements, dtype=object),
                  res_names=np.array(["MOL", "MOL", "DON", "DON"], dtype=object),
                  res_ids=np.array([0, 0, 1, 1]), bonds=np.array([[2, 3]]))
    pos = np.array([[[12.8, 10, 10], [10, 16, 10], [10, 10, 10], [10.9572, 10, 10]]], np.float32)
    return top, traj_cls(pos, np.array([[30.0, 30.0, 30.0]], np.float32))


def test_hb_cluster_adjacency_keeps_a_bond_of_any_atom(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    inds = ([0, 1], [2], [3])
    want = jhd.get_hb_cluster_stats(*_two_residue_system(True), *inds,
                                    output_dir=str(tmp_path / "jax"))
    got = thd.get_hb_cluster_stats(*_two_residue_system(False), *inds,
                                   output_dir=str(tmp_path / "torch"), device="cpu")
    assert got[0] == want[0] == 2.0
    dist = np.loadtxt(tmp_path / "torch" / "clusterDistribution.txt")
    np.testing.assert_array_equal(dist, [[1, 0], [2, 1]])


def test_ion_and_neighbor_stats_match_jax(tmp_path):
    (top, traj), (jtop, jtraj) = _systems(None, seed=16)
    wat = top.get_wat_inds()[0]
    for d in ("jax", "torch", "jax_n", "torch_n"):
        (tmp_path / d).mkdir()
    ions, charges = wat[:48], np.array([1.0, -1.0, -1.0] * 16)
    want = jhd.get_ion_cluster_stats(jtop, jtraj, ions, charges, cutoff=6.0,
                                     output_dir=str(tmp_path / "jax"))
    got = thd.get_ion_cluster_stats(top, traj, ions, charges, cutoff=6.0,
                                    output_dir=str(tmp_path / "torch"), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    name = "clusterDistribution.txt"
    assert _text(tmp_path / "torch", name) == _text(tmp_path / "jax", name)
    mol = np.arange(len(wat)) // 2
    want_n = jhd.get_neighbor_stats(jtop, jtraj, wat, mol, output_dir=str(tmp_path / "jax_n"))
    got_n = thd.get_neighbor_stats(top, traj, wat, mol, output_dir=str(tmp_path / "torch_n"),
                                   device="cpu")
    np.testing.assert_allclose(got_n, want_n, rtol=1e-6)
    name = "coordDistribution.txt"
    assert _text(tmp_path / "torch_n", name) == _text(tmp_path / "jax_n", name)
    assert got_n[0] > 0


def test_cached_bound_wrap_round_trips(tmp_path, monkeypatch):
    (top, traj), _ = _systems(SOLUTE)
    path = str(tmp_path / "bw.npz")
    first = cache.cached_bound_wrap(path, top, traj, device="cpu", cutoff=4.0)
    assert os.path.exists(path)
    monkeypatch.setattr(thd, "get_bound_wrap", lambda *a, **k: pytest.fail("recomputed"))
    again = cache.cached_bound_wrap(path, top, traj, device="cpu", cutoff=4.0)
    for f, g in zip(first, again):
        for a, b in zip(f, g):
            np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    other = cache.cached_bound_wrap(path, top, traj, device="cpu", cutoff=4.6)
    assert len(other) == N_FRAMES


def test_cli_hb_and_boundwrap_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = str(tmp_path / "sys")

    def run(*a):
        return subprocess.run([sys.executable, "-m", "waterorderlib_tpu_torch", *a], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=600)

    gen = run("generate", "--waters", "96", "--frames", "2", "--solute", "C,O,H,N,H,C",
              "--out", base)
    assert gen.returncode == 0, gen.stderr[-2000:]
    hb = run("hb", base + ".json", base + ".npz", "--device", "cpu", "--output-dir", str(tmp_path))
    assert hb.returncode == 0, hb.stderr[-2000:]
    res = json.loads(hb.stdout.strip().splitlines()[-1])
    assert set(res) == {"avgWatHBs", "avgSolHBs"} and res["avgWatHBs"] > 0
    assert np.loadtxt(tmp_path / "hbDistribution_water.txt").shape == (10, 2)
    cache_path = str(tmp_path / "bw.npz")
    bw = run("boundwrap", base + ".json", base + ".npz", "--device", "cpu", "--cache", cache_path)
    assert bw.returncode == 0, bw.stderr[-2000:]
    sizes = json.loads(bw.stdout.strip().splitlines()[-1])["sizes_per_frame"]
    assert len(sizes) == 2 and all(f[0] + f[1] == f[2] and f[2] + f[3] == 96 for f in sizes)
    with np.load(cache_path) as d:
        assert len(d["frame1_shell"]) == sizes[1][2]


@pytest.mark.parametrize("driver", ["hb_calc", "get_bound_wrap"])
def test_cuda_without_a_gpu_raises(driver, monkeypatch, tmp_path):
    (top, traj), _ = _systems(SOLUTE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"output_dir": str(tmp_path)} if driver == "hb_calc" else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(thd, driver)(top, traj, **kw)


def test_mesh_is_not_ported_and_stages_are_named(tmp_path):
    (top, traj), _ = _systems(None)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        thd.hb_calc(top, traj, output_dir=str(tmp_path), device="cpu", mesh=object())
    with orderparams.stage_times() as t:
        thd.hb_calc(top, traj, output_dir=str(tmp_path), device="cpu")
    assert list(t) == ["host gather", "H2D", "kernel stage", "stats (device)", "D2H", "savetxt"]
