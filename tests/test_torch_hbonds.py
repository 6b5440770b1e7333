"""The port's H-bond modules (hbonds/bonds, clusters, legacy and the
counting kernels' contracts in ops/cuda/hbond.py) against the JAX package.

The JAX Pallas kernels run in TPU interpret mode, as the JAX package's own
CPU tests would run them (four calls in all, ~1-2 s each). Every count is
held exactly: the plain versions do the Pallas kernels' float32 operations,
and the arccos matrix follows XLA's order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.hbonds import bonds as jbonds
from waterorderlib_tpu.hbonds import clusters as jclusters
from waterorderlib_tpu.hbonds import legacy as jlegacy
from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import hbond_kernel as jhk
from waterorderlib_tpu.ops.pallas import hbond_slab as jhs
from waterorderlib_tpu_torch.hbonds import bonds, clusters, legacy
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.ops.cuda import hbond

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray


def _water_sets(n, seed):
    """One frame of make_water_box(n): water acceptors (O), donors (each O
    twice), donor hydrogens, box; float32 numpy."""
    top, traj = make_water_box(n, n_frames=1, seed=seed)
    w, wh, _ = top.get_wat_inds()
    p = traj.positions[0].astype(np.float32)
    return p[w], np.repeat(p[w], 2, axis=0), p[wh], traj.boxes[0].astype(np.float32)


@pytest.fixture(scope="module")
def box400():
    return _water_sets(400, 37)


def _asym(box400):
    """The JAX package's asymmetric sets (test_pallas_kernels.py:377-378):
    37 pseudo-donors shifted 0.3 A, hydrogens 0.8 A further."""
    acc, _, _, box = box400
    sol = acc[:37] + np.float32(0.3)
    return acc, sol, sol + np.float32(0.8), box


def _tb(*a):
    return [T(x)[None] for x in a]


GEOMETRIES = {  # (acc, don, donh, box, dist, ang, bonded) from tests/test_hbonds.py
    "linear": ([[2.8, 0, 0]], [[0, 0, 0]], [[0.9572, 0, 0]], [50.0] * 3, 3.5, 150.0, True),
    "h_away": ([[2.8, 0, 0]], [[0, 0, 0]], [[-0.9572, 0, 0]], [50.0] * 3, 3.5, 150.0, False),
    "too_far": ([[4.0, 0, 0]], [[0, 0, 0]], [[0.9572, 0, 0]], [50.0] * 3, 3.5, 150.0, False),
    "self_pair": ([[5, 5, 5]], [[5, 5, 5]], [[5.9572, 5, 5]], [20.0] * 3, 3.5, 120.0, False),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_general_hbonds_known_geometries(name):
    *arrs, dist, ang, bonded = GEOMETRIES[name]
    acc, don, donh, box = (np.asarray(a, np.float32) for a in arrs)
    got = bonds.general_hbonds(T(acc), T(don), T(donh), T(box), dist, ang).numpy()
    want = np.asarray(jbonds.general_hbonds(J(acc), J(don), J(donh), J(box), dist, ang))
    np.testing.assert_array_equal(got, want)
    assert bool(got[0, 0]) == bonded
    counts = hbond.hbond_counts(*_tb(acc, don, donh, box), dist, ang)
    assert int(counts[0].sum()) == int(bonded)


def test_general_hbonds_matches_jax_on_400_waters(box400):
    acc, don, donh, box = box400
    want = np.asarray(jbonds.general_hbonds(J(acc), J(don), J(donh), J(box), 3.5, 120.0))
    got = bonds.general_hbonds(T(acc), T(don), T(donh), T(box), 3.5, 120.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 400
    # batched over frames, and reduced to counts block by block
    acc_cnt, don_cnt = bonds.general_hbond_counts(*_tb(acc, don, donh, box), 3.5, 120.0)
    np.testing.assert_array_equal(acc_cnt[0].numpy(), want.sum(axis=1))
    np.testing.assert_array_equal(don_cnt[0].numpy(), want.sum(axis=0))
    n, mat, mid = bonds.hbond_counts_and_midpoints(T(acc), T(don), T(donh), T(box))
    jn, _, jmid = jbonds.hbond_counts_and_midpoints(J(acc), J(don), J(donh), J(box))
    assert int(n) == int(jn)
    np.testing.assert_allclose(mid.numpy(), np.asarray(jmid), atol=1e-5)


@pytest.mark.parametrize("ang", [120.0, 150.0, 30.0])
def test_cos_cut_matches_jax(ang):
    want = float(jnp.cos(jnp.radians(jnp.asarray(ang, jnp.float32))))
    assert hbond.cos_cut(ang) == want


@pytest.fixture(scope="module")
def pallas_dense(box400):
    """The JAX dense counting kernel (interpret mode): water-water at
    3.5 A / 120 degrees and the asymmetric sets at 3.0 A / 150 degrees."""
    with pltpu.force_tpu_interpret_mode():
        return {
            "water": [np.asarray(x) for x in jhk.hbond_counts(*map(J, box400), 3.5, 120.0)],
            "asym": [np.asarray(x) for x in jhk.hbond_counts(*map(J, _asym(box400)), 3.0, 150.0)],
        }


@pytest.mark.parametrize("case", ["water", "asym"])
def test_dense_plain_matches_pallas_kernel(box400, pallas_dense, case):
    sets, dist, ang = (box400, 3.5, 120.0) if case == "water" else (_asym(box400), 3.0, 150.0)
    acc_cnt, don_cnt = hbond.hbond_counts_plain(*_tb(*sets), dist, ang)
    want_acc, want_don = pallas_dense[case]
    np.testing.assert_array_equal(acc_cnt[0].numpy(), want_acc)
    np.testing.assert_array_equal(don_cnt[0].numpy(), want_don)
    assert acc_cnt.dtype == torch.int32 and int(acc_cnt.sum()) == int(don_cnt.sum()) > 0
    # the arccos matrix gives the same counts on these inputs
    ref_acc, ref_don = bonds.general_hbond_counts(*_tb(*sets), dist, ang)
    assert torch.equal(ref_acc, acc_cnt) and torch.equal(ref_don, don_cnt)


def _slab_fixture():
    """test_pallas_kernels.py:690-699 at 2048 waters: lattice oxygens, each
    twice as donors, unit hydrogens in random directions."""
    n = 2048
    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(23)
    acc = water_oxygen_lattice(n, box_len, seed=23).astype(np.float32)
    don = np.concatenate([acc, acc])
    h_off = rs.normal(scale=0.6, size=(2 * n, 3)).astype(np.float32)
    h_off /= np.linalg.norm(h_off, axis=1, keepdims=True)
    win = hbond.suggest_window_two_set(n, 2 * n, box_len, 3.5)
    pad = hbond.suggest_pad_two_set(2 * n, box_len, 5.5)
    return (acc, don, don + h_off, np.array([box_len] * 3, np.float32)), win, pad


@pytest.fixture(scope="module")
def slab_case():
    sets, win, pad = _slab_fixture()
    with pltpu.force_tpu_interpret_mode():
        full = [np.asarray(x) for x in jhs.hbond_counts_slab(*map(J, sets), 3.5, 120.0,
                                                               window=win, pad=pad)]
        small = bool(jhs.hbond_counts_slab(*map(J, sets), 3.5, 120.0, window=512, pad=pad)[2])
    return sets, win, pad, full, small


def test_suggest_window_and_pad_match_jax():
    for n, box_z, cut in ((2048, 40.3, 3.5), (16384, 80.6, 3.5), (131072, 161.2, 5.5)):
        assert (hbond.suggest_window_two_set(n, 2 * n, box_z, cut)
                == jhs.suggest_window_two_set(n, 2 * n, box_z, cut))
        assert hbond.suggest_pad_two_set(2 * n, box_z, cut) == jhs.suggest_pad_two_set(2 * n, box_z,
                                                                                        cut)


def test_slab_plain_matches_pallas_kernel_and_dense(slab_case):
    sets, win, pad, (want_acc, want_don, want_cov), want_small = slab_case
    acc_cnt, don_cnt, covered = hbond.hbond_counts_slab_plain(*_tb(*sets), 3.5, 120.0,
                                                              window_w=win, pad=pad)
    assert bool(want_cov) and covered.tolist() == [True]
    np.testing.assert_array_equal(acc_cnt[0].numpy(), want_acc)
    np.testing.assert_array_equal(don_cnt[0].numpy(), want_don)
    dense_acc, dense_don = hbond.hbond_counts_plain(*_tb(*sets), 3.5, 120.0)
    assert torch.equal(acc_cnt, dense_acc) and torch.equal(don_cnt, dense_don)
    # an undersized window fails the certificate, in both packages
    _, _, cov_small = hbond.hbond_counts_slab_plain(*_tb(*sets), 3.5, 120.0, window_w=512, pad=pad)
    assert not want_small and cov_small.tolist() == [False]


def test_slab_prep_per_frame_and_contract(slab_case):
    """Two frames, the second shifted by a third of the box in z and a few
    atoms stored shifted by +/-L: each frame is sorted on its own, and the
    wrapper on CPU tensors is the plain version."""
    (acc, don, donh, box), win, pad, _, _ = slab_case
    shift = np.array([0.0, 0.0, box[2] / 3], np.float32)
    some = np.zeros((len(don), 3), np.float32)
    some[::97, 0] = box[0]
    frames = [np.stack([a, a + s]) for a, s in ((acc, shift), (don + some, shift),
                                                (donh + some, shift))]
    boxes = np.stack([box, box])
    before = hbond.hbond_slab_plain.calls
    got = hbond.hbond_counts_slab(*(T(x) for x in (*frames, boxes)), 3.5, 120.0,
                                  window_w=win, pad=pad)
    assert hbond.hbond_slab_plain.calls == before + 1
    want = hbond.hbond_counts_plain(*(T(x) for x in (*frames, boxes)), 3.5, 120.0)
    assert got[2].tolist() == [True, True]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    prep = hbond.slab_prep_two_set(*(T(x) for x in (*frames, boxes)), 3.5, win, pad)
    assert prep.starts.shape == (2, 16) and prep.w == win
    assert not torch.equal(prep.order_a[0], prep.order_a[1])
    # every column, boundary copies included, carries its donor's values as
    # the dense prep has them, so both kernels meet the same pair operations
    dense = hbond.dense_prep(*(T(x) for x in (*frames, boxes)))
    nd = don.shape[0]
    src = torch.cat([prep.order_d[:, nd - pad :], prep.order_d, prep.order_d[:, :pad]], dim=1)
    for ext, flat in ((prep.don, dense.don), (prep.donh, dense.donh), (prep.vhat, dense.vhat)):
        assert torch.equal(ext, flat.gather(2, src[:, None, :].expand(-1, 3, -1)))


def test_certified_dispatch_tiers(slab_case, monkeypatch):
    (acc, don, donh, box), _, _, _, _ = slab_case
    args = _tb(acc, don, donh, box)
    want = hbond.hbond_counts_plain(*args)
    got = hbond.hbond_counts_certified(*args)
    assert hbond.last_tier == "dense"
    monkeypatch.setattr(hbond, "SLAB_MIN_WATERS", 1024)
    got_slab = hbond.hbond_counts_certified(*args)
    assert hbond.last_tier == "slab"
    # a window too narrow to be covered: the frame is recomputed densely
    monkeypatch.setattr(hbond, "suggest_window_two_set", lambda *a, **k: 512)
    got_fallback = hbond.hbond_counts_certified(*args)
    assert hbond.last_tier == "slab+dense"
    for g in (got, got_slab, got_fallback):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])


def test_wrappers_refuse_other_devices_and_bad_inputs(box400):
    acc, don, donh, box = (x.to("meta") for x in _tb(*box400))
    prep = hbond.dense_prep(acc, don, donh, box)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        hbond.hbond_dense(*prep, box, 12.25, -0.5)
    cpu = hbond.dense_prep(*_tb(*box400))
    with pytest.raises(TypeError, match="float32"):
        hbond.hbond_dense(cpu.acc.double(), *cpu[1:], T(box400[3])[None], 12.25, -0.5)
    with pytest.raises(ValueError, match="pad"):
        hbond.slab_prep_two_set(*_tb(*box400), 3.5, 512, 0)


def test_per_molecule_counts_matches_jax():
    rs = np.random.RandomState(5)
    mat = rs.uniform(size=(7, 9)) < 0.3
    acc_mol, don_mol = rs.randint(0, 4, 7), rs.randint(0, 4, 9)
    want = np.asarray(jbonds.per_molecule_counts(J(mat), J(acc_mol), J(don_mol), 4))
    got = bonds.per_molecule_counts(T(mat), T(acc_mol), T(don_mol), 4).numpy()
    np.testing.assert_array_equal(got, want)


def _graphs():
    """Chain, ring and a random graph of 12 vertices, symmetric."""
    chain = np.zeros((6, 6), bool)
    for a, b in ((0, 1), (1, 2), (3, 4)):
        chain[a, b] = chain[b, a] = True
    ring = np.zeros((12, 12), bool)
    for i in range(12):
        ring[i, (i + 1) % 12] = ring[(i + 1) % 12, i] = True
    rnd = np.random.RandomState(8).uniform(size=(12, 12)) < 0.12
    return chain, ring, rnd | rnd.T


@pytest.mark.parametrize("which", [0, 1, 2])
def test_clusters_match_jax(which):
    adj = _graphs()[which]
    for fn in ("connected_components", "cluster_sizes", "cluster_size_distribution"):
        got = getattr(clusters, fn)(T(adj)).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jclusters, fn)(J(adj))))
    assert float(clusters.mean_cluster_size(T(adj))) == float(jclusters.mean_cluster_size(J(adj)))


def test_clusters_batched_over_frames():
    chain, _, rnd = _graphs()
    a = np.zeros((2, 12, 12), bool)
    a[0, :6, :6] = chain
    a[1] = rnd
    got = clusters.connected_components(T(a)).numpy()
    for f in range(2):
        np.testing.assert_array_equal(got[f], np.asarray(jclusters.connected_components(J(a[f]))))


def _legacy_system():
    """A 64-water box with pseudo-peptide atoms placed to bond, give or take
    0.3 A of noise: 16 (heavy, H) donors whose H points at a water oxygen
    1.8 A away, 10 acceptors 1.8 A beyond a water H1 and 10 acceptors
    1.8 A beyond a donor's H (backbone-backbone)."""
    top, traj = make_water_box(64, n_frames=1, seed=21)
    p = traj.positions[0].astype(np.float64)
    box = traj.boxes[0].astype(np.float32)
    rs = np.random.RandomState(21)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    o, h1 = p[0 : 3 * 64 : 3], p[1 : 3 * 64 : 3]
    u = unit(rs.normal(size=(16, 3)))
    heavy = o[20:36] + 2.8 * u
    hpos = heavy - 1.0 * u
    acc_w = h1[:10] + 1.8 * unit(h1[:10] - o[:10])
    acc_bb = hpos[:10] + 1.8 * unit(hpos[:10] - heavy[:10])
    pep_acc = np.concatenate([acc_w, acc_bb]) + rs.normal(scale=0.3, size=(20, 3))
    pep_don = np.stack([heavy, hpos], axis=1).reshape(-1, 3)
    return (pep_acc.astype(np.float32), pep_don.astype(np.float32),
            p[: 3 * 64].astype(np.float32), box)


@pytest.mark.parametrize("fn", ["find_hbonds", "bb_hbonds", "wat_hbonds"])
def test_legacy_counts_match_jax(fn):
    pep_acc, pep_don, wat, box = _legacy_system()
    args = {"find_hbonds": (pep_acc, pep_don, wat), "bb_hbonds": (pep_acc, pep_don),
            "wat_hbonds": (wat[: 3 * 20], wat, box)}[fn]
    cuts = (2.1, 30.0) if fn != "wat_hbonds" else (2.5, 35.0)
    got = getattr(legacy, fn)(*args, *cuts)
    want = getattr(jlegacy, fn)(*map(J, args), *cuts)
    assert got[0] == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0] > 0


def test_legacy_wrappers_match_jax():
    pep_acc, pep_don, wat, box = _legacy_system()
    all_pos = np.concatenate([wat, pep_acc, pep_don])
    wat_inds = np.arange(3 * 64)
    acc_inds = np.arange(3 * 64, 3 * 64 + 20)
    don_inds = np.arange(3 * 64 + 20, len(all_pos))
    for fn, args in (("pep_wat_hbonds", (all_pos, acc_inds, don_inds, wat_inds)),
                     ("bb_hbonds_wrapper", (all_pos, acc_inds, don_inds)),
                     ("wat_hbonds_wrapper", (all_pos, wat_inds[:60], wat_inds, box, 2.5, 35.0))):
        got, want = getattr(legacy, fn)(*args), getattr(jlegacy, fn)(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
