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
