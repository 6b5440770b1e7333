"""The water boxes of the benchmark's configurations, made from a seed.

A configuration file (configs/<name>.json) gives the molecule count, the
number density and the water model's geometry. `make_frames` builds a pool
of frames on the device in a few large calls: oxygens on a jittered cubic
lattice that fills the cubic box, each frame those sites moved by a small
Gaussian jitter, each water turned by a uniform random rotation. This is
the geometry of the port's `io/synthetic.make_water_box`, vectorised over
frames and written again here so the yardstick does not move with the
program. The same seed gives the same frames on the same device.

The sites (which lattice sites hold a water, and how far each is moved)
and each frame's jitter decide how much work an analysis with
data-dependent tiers does: one seed's frames may send a few waters to a
Voronoi tier that another seed's never reach. A traffic that sets
`structures` = {"count": M, "seed": s} takes the whole pool from s, the
same for every run: M lattices, frame i of the pool from lattice
order[i % M], and the frames' jitter and rotations. Every window of a
multiple of M frames holds each lattice equally often, and the run's seed
draws only the order in which the calls visit the pool's whole calls
(run.py `draw_offset`), so that every seed does the same work in another
order.

`shell_population` is the traffic's population rule: on each frame, the
waters whose oxygen lies within a radius of the box centre.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def edge(config: dict) -> float:
    """Edge of the cubic box in Angstrom: n_waters / density, cube root."""
    return (config["n_waters"] / config["density_per_A3"]) ** (1.0 / 3.0)


def _rotations(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def local_water(config: dict) -> torch.Tensor:
    """(3, 3) float64: O, H1, H2 of one water in its own frame (O at the
    origin, the hydrogens in the xz plane at the model's O-H length and
    H-O-H angle)."""
    oh, half = config["oh_A"], math.radians(config["hoh_deg"]) / 2
    return torch.tensor([[0.0, 0.0, 0.0],
                         [oh * math.sin(half), 0.0, oh * math.cos(half)],
                         [-oh * math.sin(half), 0.0, oh * math.cos(half)]], dtype=torch.float64)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _sites(config: dict, box: float, gen: torch.Generator, device) -> torch.Tensor:
    """(n_waters, 3) float64: n_waters sites of the cubic lattice taken at
    random, each moved by up to `lattice_jitter` of the spacing."""
    n = config["n_waters"]
    f64 = dict(dtype=torch.float64, device=device)
    n_side = math.ceil(round(n ** (1.0 / 3.0), 9))
    spacing = box / n_side
    axis = (torch.arange(n_side, **f64) + 0.5) * spacing
    sites = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    sites = sites[torch.randperm(sites.shape[0], generator=gen, device=device)[:n]]
    jit = config["lattice_jitter"] * spacing
    return torch.remainder(sites + (torch.rand(sites.shape, generator=gen, **f64) * 2 - 1) * jit,
                           box)


def make_frames(config: dict, n_frames: int, seed: int, device,
                structures: dict | None = None) -> tuple[torch.Tensor, float]:
    """(n_frames, 3 * n_waters, 3) float32 positions on `device`, atoms in
    the order O, H1, H2 of each water, and the box edge. Without
    `structures` the frames come from `seed`; with it, from its own seed
    alone (module docstring)."""
    n = config["n_waters"]
    box = edge(config)
    f64 = dict(dtype=torch.float64, device=device)

    if structures is None:
        gen = _generator(seed, device)
        sites = _sites(config, box, gen, device)
    else:
        count = int(structures["count"])
        gen = _generator(structures["seed"], device)
        sites = torch.stack([_sites(config, box, gen, device) for _ in range(count)])
        order = torch.randperm(count, generator=gen, device=device)
        sites = sites[order[torch.arange(n_frames, device=device) % count]]

    oxy = sites + torch.randn((n_frames, n, 3), generator=gen, **f64) * config["frame_jitter_A"]
    q = torch.randn((n_frames, n, 4), generator=gen, **f64)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    atoms = oxy[:, :, None, :] + torch.einsum("fnij,aj->fnai", _rotations(q),
                                              local_water(config).to(device))
    return atoms.reshape(n_frames, 3 * n, 3).to(torch.float32), box


def shell_population(positions: torch.Tensor, box: float, radius: float) -> list:
    """The reference's ragged populations for one shell: per frame, a list
    holding one array of the global atom indices of the water oxygens
    within `radius` of the box centre. positions: (F, 3 n, 3)."""
    oxy = positions[:, 0::3, :].to(torch.float64)
    inside = (torch.linalg.vector_norm(oxy - box / 2.0, dim=-1) < radius).cpu().numpy()
    return [[3 * np.flatnonzero(row)] for row in inside]


def topology_arrays(n_waters: int) -> dict:
    """The arrays of a topology of `n_waters` waters: atom names, elements,
    residue names and ids, O-H bonds and masses."""
    idx = np.arange(n_waters)
    base = 3 * idx
    return dict(
        names=np.tile(np.array(["O", "H1", "H2"], dtype=object), n_waters),
        elements=np.tile(np.array(["O", "H", "H"], dtype=object), n_waters),
        res_names=np.full(3 * n_waters, "WAT", dtype=object),
        res_ids=np.repeat(idx, 3),
        bonds=np.stack([np.stack([base, base + 1], 1), np.stack([base, base + 2], 1)],
                       1).reshape(-1, 2),
        masses=np.tile(np.array([15.999, 1.008, 1.008]), n_waters),
    )
