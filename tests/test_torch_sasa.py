"""The port's SASA (surface/sasa.py on the occlusion kernel's plain
versions, ops/cuda/sasa.py) against waterorderlib_tpu.surface.sasa.

On CPU tensors the kernel's wrappers run their plain PyTorch versions,
which take the JAX package's quadratic occlusion test in XLA's arithmetic:
visible counts, areas and `exposed` equal the JAX pruned and brute tiers
exactly. The JAX Pallas MXU kernel runs in TPU interpret mode, held to
tests/test_sasa.py's own bound (no count off by a whole point). sasa_calc
and sphere_volumes agree in counts exactly and in floats within 1e-6
relative (XLA decides per fusion whether it contracts a product into an
fma).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.core.geometry import sphere_points
from waterorderlib_tpu.io.synthetic import make_water_box, water_oxygen_lattice
from waterorderlib_tpu.ops import pairs as jpairs
from waterorderlib_tpu.ops.pallas.sasa_kernel import sphere_areas_pallas
from waterorderlib_tpu.surface import sasa as jsasa
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.ops.cuda import sasa as occl
from waterorderlib_tpu_torch.surface import sasa as tsasa

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

T = torch.from_numpy
RTOL = 1e-6
NO_BOX = np.array([-1.0, -1.0, -1.0], np.float32)


def _liquid():
    """tests/test_sasa.py's 600-atom liquid box, 240 points."""
    n = 600
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(0)
    pos = ((base + rs.normal(scale=0.6, size=base.shape)) % box_l).astype(np.float32)
    radii = (1.4 + 0.2 * rs.rand(n)).astype(np.float32)
    return pos, radii, np.array([box_l] * 3, np.float32), 240


def _solute():
    """tests/test_surface.py's 64-water + solute box, radii with the probe,
    300 points."""
    _, traj = make_water_box(64, n_frames=1, seed=5, solute_elements=["C", "O"])
    pos = np.asarray(traj.positions[0], np.float32)
    rs = np.random.RandomState(2)
    radii = (1.2 + 1.4 + 0.6 * rs.random(len(pos))).astype(np.float32)
    return pos, radii, np.asarray(traj.boxes[0], np.float32), 300


FIXTURES = {"liquid": _liquid, "solute": _solute}


def _n_vis(areas, radii, p):
    return np.rint(np.asarray(areas, np.float64) * p / (4 * np.pi * radii.astype(np.float64) ** 2))


@pytest.fixture(scope="module", params=[(f, b) for f in FIXTURES for b in ("box", "no box")],
                ids=lambda fb: f"{fb[0]}-{fb[1]}")
def case(request):
    name, which = request.param
    pos, radii, box, p = FIXTURES[name]()
    return pos, radii, box if which == "box" else NO_BOX, sphere_points(p).astype(np.float32)


def test_pruned_and_brute_equal_jax_exactly(case):
    pos, radii, box, pts = case
    args_j = tuple(jnp.asarray(a) for a in (pos, radii, pts, box))
    args_t = tuple(T(a) for a in (pos, radii, pts, box))
    a_j, e_j, ok_j = jsasa.sphere_surface_areas_topk(*args_j)
    a_t, e_t, ok_t = tsasa.sphere_surface_areas_topk(*args_t)
    assert bool(ok_j) and bool(ok_t)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    b_j, f_j = jsasa.sphere_surface_areas(*args_j)
    b_t, f_t = tsasa.sphere_surface_areas(*args_t)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(b_t.numpy(), a_t.numpy())


def test_plain_occlusion_on_the_jax_slots():
    """The port's plain pruned occlusion fed the JAX package's own neighbor
    list (interop.neighbor_list_from_jax) equals the JAX sweep."""
    pos, radii, box, p = _solute()
    pts = sphere_points(p).astype(np.float32)
    nl_j = jpairs.topk_neighbors(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(box), k=128,
                                 low_cut=0.0, high_cut=2.0 * jnp.max(jnp.asarray(radii)),
                                 row_block=256)
    nl = interop.neighbor_list_from_jax(nl_j, "cpu")
    slots = tsasa.occluder_slots(T(pos), T(radii), T(box), nl)
    n_vis = occl.sasa_topk(T(pos), T(radii), T(pts), *slots)
    a_j, _, _ = jsasa.sphere_surface_areas_topk(*(jnp.asarray(a) for a in (pos, radii, pts, box)))
    np.testing.assert_array_equal(n_vis.numpy(), _n_vis(a_j, radii, p))


def test_pruned_within_the_pallas_kernels_bound():
    """tests/test_sasa.py's bound on the MXU kernel (interpret mode): no
    visible count off by a whole point, identical exposed and certificate."""
    pos, radii, box, p = _liquid()
    pts = sphere_points(p)
    with pltpu.force_tpu_interpret_mode():
        a_p, e_p, ok_p = sphere_areas_pallas(pos, radii, pts, jnp.asarray(box))
    a_t, e_t, ok_t = tsasa.sphere_surface_areas_topk(T(pos), T(radii),
                                                     T(pts.astype(np.float32)), T(box))
    assert bool(ok_p) and bool(ok_t)
    nv_p = np.asarray(a_p) / (4 * np.pi * radii**2) * p
    nv_t = a_t.numpy() / (4 * np.pi * radii**2) * p
    assert np.abs(nv_t - nv_p).max() < 0.5
    assert (e_t.numpy() ^ np.asarray(e_p)).sum() == 0


def test_sasa_per_atom_tiers():
    """The pruned tier serves a liquid; k = 4 fails the certificate; a
    cluster of 130 atoms within 2 max r of one atom fails it for K = 128,
    and sasa_per_atom then takes the brute tier, equal to the JAX result."""
    pos, radii, box, p = _solute()
    vdw = radii - 1.4
    _, _, ok4 = tsasa.sphere_surface_areas_topk(T(pos), T(radii), T(sphere_points(p).astype(
        np.float32)), T(box), k=4)
    assert not bool(ok4)
    before = occl.sasa_topk_plain.calls, occl.sasa_brute_plain.calls
    a_t, e_t = tsasa.sasa_per_atom(pos, vdw, box=box, n_points=p, device="cpu")
    assert tsasa.last_tier == "topk"
    assert (occl.sasa_topk_plain.calls, occl.sasa_brute_plain.calls) == (before[0] + 1, before[1])
    a_j, e_j = jsasa.sasa_per_atom(pos, vdw, box=box, n_points=p)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))

    rs = np.random.RandomState(9)
    shell = rs.normal(size=(130, 3))
    shell = pos[0] + (0.5 + 1.5 * rs.rand(130, 1)) * shell / np.linalg.norm(shell, axis=1,
                                                                           keepdims=True)
    cl_pos = np.concatenate([pos, shell.astype(np.float32)])
    cl_vdw = np.concatenate([vdw, np.full(130, 1.5, np.float32)])
    a_t, e_t = tsasa.sasa_per_atom(cl_pos, cl_vdw, box=box, n_points=p, device="cpu")
    assert tsasa.last_tier == "brute"
    a_j, e_j = jsasa.sasa_per_atom(cl_pos, cl_vdw, box=box, n_points=p)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))


def test_coincident_atom_only_the_brute_tier_counts():
    """An occluder at exactly zero distance: the pruned tier's neighbor
    search drops it (low_cut 0, strict >), the brute tier counts it; both
    as in the JAX package."""
    pos = np.array([[5.0, 5.0, 5.0], [5.0, 5.0, 5.0], [9.0, 5.0, 5.0]], np.float32)
    radii = np.array([2.0, 3.0, 2.0], np.float32)
    pts = sphere_points(200).astype(np.float32)
    args_j = tuple(jnp.asarray(a) for a in (pos, radii, pts, NO_BOX))
    args_t = tuple(T(a) for a in (pos, radii, pts, NO_BOX))
    a_t, _, ok = tsasa.sphere_surface_areas_topk(*args_t)
    b_t, _ = tsasa.sphere_surface_areas(*args_t)
    assert bool(ok) and float(a_t[0]) > 0.0 and float(b_t[0]) == 0.0
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(jsasa.sphere_surface_areas_topk(*args_j)[0]))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(jsasa.sphere_surface_areas(*args_j)[0]))


def test_isolated_and_buried_atoms():
    """tests/test_surface.py's cases: a lone sphere is fully exposed, a
    sphere inside a shell of larger ones is fully buried."""
    areas, exposed = tsasa.sasa_per_atom(np.zeros((1, 3), np.float32), np.array([0.6]),
                                         probe_radius=1.4, n_points=500, device="cpu")
    assert np.isclose(float(areas[0]), 4 * np.pi * 4.0, rtol=1e-3) and bool(exposed[0])
    shell = 3.0 * sphere_points(30)
    pos = np.concatenate([np.zeros((1, 3)), shell]).astype(np.float32)
    radii = np.concatenate([[1.0], np.full(len(shell), 2.5)]).astype(np.float32)
    areas, exposed = tsasa.sasa_per_atom(pos, radii, probe_radius=0.0, n_points=200, device="cpu")
    a_j, e_j = jsasa.sasa_per_atom(pos, radii, probe_radius=0.0, n_points=200)
    assert float(areas[0]) == 0.0 and not bool(exposed[0])
    np.testing.assert_array_equal(areas.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(exposed.numpy(), np.asarray(e_j))


def test_plain_versions_do_not_depend_on_their_blocks(monkeypatch):
    pos, radii, box, p = _solute()
    args = tuple(T(a) for a in (pos, radii, sphere_points(p).astype(np.float32), box))
    whole = occl.sasa_brute_plain(*args), tsasa.sphere_surface_areas_topk(*args)[0]
    monkeypatch.setattr(occl, "PAIR_BUDGET", 1000)
    assert torch.equal(occl.sasa_brute_plain(*args), whole[0])
    assert torch.equal(tsasa.sphere_surface_areas_topk(*args)[0], whole[1])


@pytest.mark.parametrize("which", ["box", "no box"])
def test_sasa_calc_matches_jax(which):
    pos, radii, box, _ = _solute()
    box = box if which == "box" else NO_BOX
    vdw = radii - 1.4
    want = jsasa.sasa_calc(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(vdw), 1.4, 100)
    ins, acc, sasa = tsasa.sasa_calc(pos, box, vdw, 1.4, 100, device="cpu")
    np.testing.assert_allclose(ins.numpy(), np.asarray(want[0]), rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(sasa.numpy(), np.asarray(want[2]), rtol=RTOL)
    # the reference's unsquared radius: frac * 4 pi (r + probe)
    frac = acc.numpy().sum(axis=1) / 100.0
    np.testing.assert_allclose(sasa.numpy(), frac * 4 * np.pi * (vdw + 1.4), rtol=RTOL)


@pytest.mark.parametrize("g", [24, 64])
def test_sphere_volumes_matches_jax(g):
    pos, radii, _, _ = _solute()
    vdw = radii - 1.4
    want = np.asarray(jsasa.sphere_volumes(jnp.asarray(pos), jnp.asarray(vdw), 0.5, g))
    got = tsasa.sphere_volumes(pos, vdw, 0.5, g, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    lo = (pos - vdw[:, None]).min(axis=0)
    hi = (pos + vdw[:, None]).max(axis=0) + 0.25
    cell = np.prod((hi - lo) / g)
    np.testing.assert_array_equal(np.rint(got / cell), np.rint(want / cell))


def test_sphere_volumes_partition():
    vols = tsasa.sphere_volumes(np.array([[0.0, 0, 0], [10.0, 0, 0]]), np.array([1.0, 1.0]), 0.2,
                                grid_points_per_axis=96, device="cpu").numpy()
    np.testing.assert_allclose(vols, 4.0 / 3.0 * math.pi, rtol=0.1)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos = np.zeros((2, 3), np.float32)
    for call in (lambda: tsasa.sasa_per_atom(pos, np.ones(2), device="cuda"),
                 lambda: tsasa.sasa_calc(pos, np.ones(3), np.ones(2), device="cuda"),
                 lambda: tsasa.sphere_volumes(pos, np.ones(2), 0.5, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_wrappers_refuse_other_devices():
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        occl.sasa_brute(torch.empty(4, 3, **meta), torch.empty(4, **meta),
                        torch.empty(10, 3, **meta), torch.empty(3, **meta))
