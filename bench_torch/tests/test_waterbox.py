"""The seeded water-box generator and the population rule."""

import math

import numpy as np
import pytest
import torch

from bench_torch.core import spec, waterbox


@pytest.mark.parametrize("name", ["spc4096", "spc16384"])
def test_config_edge_and_count(name):
    cfg = spec.config(name)
    assert cfg["n_atoms"] == 3 * cfg["n_waters"]
    assert math.isclose(waterbox.edge(cfg), cfg["edge_A"], rel_tol=1e-6)


def _small(name="spc4096", n=343):
    cfg = dict(spec.config(name))
    cfg["n_waters"] = n
    return cfg


def test_deterministic_from_seed():
    cfg = _small()
    seed = 2**33 + 12345  # larger than 32 bits hold
    a, box_a = waterbox.make_frames(cfg, 3, seed, "cpu")
    b, box_b = waterbox.make_frames(cfg, 3, seed, "cpu")
    c, _ = waterbox.make_frames(cfg, 3, seed + 1, "cpu")
    assert torch.equal(a, b) and box_a == box_b
    assert not torch.equal(a, c)


@pytest.mark.parametrize("n", [216, 343, 500])
def test_count_edge_and_geometry(n):
    cfg = _small(n=n)
    pos, box = waterbox.make_frames(cfg, 4, 7, "cpu")
    assert pos.shape == (4, 3 * n, 3) and pos.dtype == torch.float32
    assert math.isclose(box, (n / cfg["density_per_A3"]) ** (1 / 3), rel_tol=1e-12)
    o, h1, h2 = (pos[:, k::3].double() for k in range(3))
    for h in (h1, h2):
        assert torch.allclose(torch.linalg.vector_norm(h - o, dim=-1),
                              torch.full((4, n), cfg["oh_A"], dtype=torch.float64), atol=1e-5)
    u, v = h1 - o, h2 - o
    ang = torch.rad2deg(torch.arccos((u * v).sum(-1) / (u.norm(dim=-1) * v.norm(dim=-1))))
    assert torch.allclose(ang, torch.full_like(ang, cfg["hoh_deg"]), atol=1e-3)
    # oxygens fill the box: inside it up to the frames' jitter
    assert float(o.min()) > -1.0 and float(o.max()) < box + 1.0
    # no two oxygens closer than a water's size allows on a jittered lattice
    d = torch.cdist(o[0], o[0]) + torch.eye(n, dtype=torch.float64) * 1e9
    assert float(d.min()) > 0.5


def test_shell_population_matches_brute_force():
    cfg = _small(n=512)
    pos, box = waterbox.make_frames(cfg, 3, 11, "cpu")
    pops = waterbox.shell_population(pos, box, 6.0)
    for f in range(3):
        want = [3 * i for i in range(512)
                if np.linalg.norm(pos[f, 3 * i].double().numpy() - box / 2) < 6.0]
        assert list(pops[f][0]) == want and len(want) > 0


def test_topology_arrays():
    t = waterbox.topology_arrays(3)
    assert list(t["elements"]) == ["O", "H", "H"] * 3
    assert t["bonds"].tolist() == [[0, 1], [0, 2], [3, 4], [3, 5], [6, 7], [6, 8]]


def _oxygen_sets(pos):
    """Each frame's oxygens as a set of rounded tuples."""
    return [frozenset(map(tuple, f[0::3].double().mul(1e4).round().tolist())) for f in pos]


def test_fixed_structures_give_every_seed_the_same_lattices():
    cfg = _small(n=216)
    cfg["frame_jitter_A"] = 0.0  # the frames' oxygens are then their lattice's sites
    st = {"count": 4, "seed": 3}
    a, _ = waterbox.make_frames(cfg, 8, 2**33 + 1, "cpu", st)
    b, _ = waterbox.make_frames(cfg, 8, 2**33 + 2, "cpu", st)
    sa, sb = _oxygen_sets(a), _oxygen_sets(b)
    assert len(set(sa)) == 4 and set(sa) == set(sb)
    # every window of `count` frames holds each lattice once, at any offset
    for sets in (sa, sb):
        for o in range(len(sets) - 3):
            assert len(set(sets[o:o + 4])) == 4
    # the whole pool, order, jitter and rotations too, is the structures' own
    assert torch.equal(a, b)
    cfg = _small(n=216)
    assert torch.equal(waterbox.make_frames(cfg, 8, 2**33 + 1, "cpu", st)[0],
                       waterbox.make_frames(cfg, 8, 2**33 + 2, "cpu", st)[0])
    c, _ = waterbox.make_frames(cfg, 8, 2**33 + 1, "cpu", {"count": 4, "seed": 4})
    assert set(_oxygen_sets(c)) != set(sa)


def _structured_run(seed, pool=16, per_call=4):
    from bench_torch import run as run_mod

    run = run_mod.Run.__new__(run_mod.Run)
    run.traffic = {"structures": {"count": 4, "seed": 3}}
    run.source, run.frames_per_call = "memory", per_call
    run.boxes = np.zeros((pool, 3), np.float32)
    run.offset_rng = np.random.default_rng([seed, 1])
    run.round = []
    return run


def test_structured_calls_visit_the_pool_in_rounds():
    orders = []
    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 1):
        run = _structured_run(seed)
        got = [run.draw_offset() for _ in range(12)]
        # every round of 4 calls takes each of the pool's 4 whole calls once
        for r in range(3):
            assert sorted(got[4 * r:4 * r + 4]) == [0, 4, 8, 12]
        orders.append(got)
    assert orders[0] != orders[1] and orders[0] == orders[2]  # the seed draws the order


@pytest.mark.parametrize("structures, match", [
    ({"count": 5, "seed": 1}, "divide"),
    ({"count": 0, "seed": 1}, "divide"),
    ({"count": 8}, "structures.seed"),
    ({"count": 8, "seed": 1, "rule": "x"}, "structures.rule"),
    ({"count": 8, "seed": 1, "pool_frames": 4100}, "whole calls"),
])
def test_traffic_with_bad_structures_is_refused(structures, match):
    structures = dict(structures)
    tr = dict(spec.traffic("voronoi_f32"), pool_frames=structures.pop("pool_frames", 4096),
              structures=structures)
    with pytest.raises(ValueError, match=match):
        spec.check_traffic("voronoi_f32", tr)
