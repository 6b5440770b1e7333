"""The port's surface modules (surface/mesh, surface/grids,
surface/plotting) against the JAX package.

`marching_tetrahedra` fed the same numpy field gives the JAX package's
vertices and faces exactly. `density_grid`, `sasa_grid` and `density_voxel`
take the fixtures of tests/test_io_formats.py:259-296 (and a 512-water box
on which the port's grid tiers run): faces equal and vertices within 1e-4 A,
after checking that no grid value lies within 1e-5 of the level (the two
packages' fields differ at float32 rounding, which could flip a grid point
across a level it touched).
"""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import make_water_box as jax_box
from waterorderlib_tpu.surface import grids as jgrids
from waterorderlib_tpu.surface import mesh as jmesh
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.ops.cuda import willard
from waterorderlib_tpu_torch.surface import grids, mesh, plotting

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

VERT_TOL = 1e-4  # A
LEVEL_GAP = 1e-5


def _field(kind):
    """(volume, level, spacing, origin) of a test field."""
    n = 20
    ax = np.linspace(-8, 8, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    if kind == "sphere":
        return np.sqrt(X**2 + Y**2 + Z**2), 5.0, (ax[1] - ax[0],) * 3, (-8.0, -8.0, -8.0)
    rs = np.random.RandomState(1)
    centers = rs.uniform(-6, 6, (7, 3))
    vol = sum(np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) / 6.0) for c in centers)
    return vol.astype(np.float32), 0.4, (0.5, 0.7, 0.9), (1.0, -2.0, 3.0)


@pytest.mark.parametrize("kind", ["sphere", "blobs"])
def test_marching_tetrahedra_equals_jax(kind):
    vol, level, spacing, origin = _field(kind)
    got = mesh.marching_tetrahedra(vol, level, spacing=spacing, origin=origin)
    want = jmesh.marching_tetrahedra(vol, level, spacing=spacing, origin=origin)
    assert len(got[1]) > 100
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_marching_tetrahedra_empty_level():
    vol, _, spacing, origin = _field("sphere")
    verts, faces = mesh.marching_tetrahedra(vol, 100.0, spacing=spacing, origin=origin)
    assert verts.shape == (0, 3) and faces.shape == (0, 3) and faces.dtype == np.int64


def test_mesh_helpers_match_jax():
    verts, faces = mesh.marching_tetrahedra(*_field("blobs"))
    tris = verts[faces]
    np.testing.assert_allclose(mesh.triangle_area(tris), np.asarray(jmesh.triangle_area(tris)),
                               rtol=1e-5, atol=1e-6)
    # well-shaped triangles: the JAX package computes in float32, whose
    # cancellation in the marching-tetrahedra mesh's slivers reaches 1e-4
    shaped = np.random.RandomState(3).uniform(-5, 5, (500, 3, 3))
    np.testing.assert_allclose(mesh.transform_triangle(shaped),
                               np.asarray(jmesh.transform_triangle(shaped)), atol=2e-5)
    props = np.random.RandomState(2).uniform(size=(len(faces), 3))
    np.testing.assert_allclose(mesh.property_barycentric(props),
                               np.asarray(jmesh.property_barycentric(props)), rtol=1e-6)
    np.testing.assert_array_equal(mesh.gaussian_curvature(verts, faces),
                                  jmesh.gaussian_curvature(verts, faces))
    assert mesh.mesh_area(verts, faces) == pytest.approx(jmesh.mesh_area(verts, faces), rel=1e-6)
    tri = np.array([[0.0, 0, 0], [3.0, 0, 0], [0.0, 4.0, 0]])
    assert float(mesh.triangle_area(tri)) == 6.0
    np.testing.assert_allclose(mesh.transform_triangle(tri), [[0, 0], [3, 0], [0, 4]], atol=1e-12)


def _same_mesh(got, want):
    assert len(want[1]) > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=VERT_TOL)


def test_sasa_grid_matches_jax():
    heavy = np.array([[10.0, 10.0, 10.0]])
    box = np.array([20.0, 20.0, 20.0])
    cutoff = np.array([2.0])
    n = 24
    lo, hi = 0.8 * heavy.min(axis=0), 1.2 * heavy.max(axis=0)
    pts = np.stack(np.meshgrid(*[np.linspace(lo[d], hi[d], n) for d in range(3)],
                               indexing="ij"), axis=-1).reshape(-1, 3)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    field = pairs.signed_sq_metric(t(pts), t(heavy), t(box), t(cutoff)).min(dim=1).values
    assert float(field.abs().min()) > LEVEL_GAP
    got = grids.sasa_grid(heavy, box, cutoff, n_bins=n, device="cpu")
    _same_mesh(got, jgrids.sasa_grid(heavy, box, cutoff, n_bins=n))
    r = np.linalg.norm(got[0] - heavy[0], axis=1)
    np.testing.assert_allclose(r, 2.0, atol=0.6)


def _sol_wat(n_waters, seed, solute):
    top, traj = make_water_box(n_waters, n_frames=1, seed=seed, solute_elements=solute)
    jtop, jtraj = jax_box(n_waters, n_frames=1, seed=seed, solute_elements=solute)
    np.testing.assert_array_equal(traj.positions, jtraj.positions)
    wat_inds, _, _ = top.get_wat_inds()
    sol_inds, *_ = top.get_sol_inds()
    p = traj.positions[0]
    return p[sol_inds].astype(float), p[wat_inds].astype(float), traj.boxes[0].astype(float)


@pytest.mark.parametrize("case", [(27, 13, ["C"]), (512, 15, ["C", "O", "C"])],
                         ids=["27_waters", "512_waters"])
def test_density_voxel_matches_jax(case):
    heavy, wat, box = _sol_wat(*case)
    got = grids.density_voxel(heavy, wat, box, device="cpu")
    want = np.asarray(jgrids.density_voxel(heavy, wat, box))
    assert got.shape == (10, 10, 10) and (case[0] == 27 or got.sum() > 0)
    np.testing.assert_array_equal(got, want)


# n_waters, seed, solute, level, n_bins, the port's tier. The levels lie
# more than 1e-5 from every grid value (test_io_formats.py's 0.03 lies
# 1.4e-7 from one on its 33^3 grid)
DENSITY_CASES = {
    "64_waters": (64, 14, ["C", "C"], 0.02452, 33, "brute"),
    "512_waters": (512, 15, ["C", "O", "C"], 0.03238, 17, "x"),
}


def _grid_field(heavy, wat, box, n_bins, **kw):
    """The port's field on density_grid's grid (surface/grids.py), and the
    tier that served it."""
    grid = grids.grid_spec(heavy, box, n_bins)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    dens, _ = willard.density_grid_certified(t(wat), t(box), grid, **kw)
    return dens.numpy(), willard.last_tier


@pytest.mark.parametrize("case", sorted(DENSITY_CASES))
def test_density_grid_matches_jax(case):
    n_waters, seed, solute, level, n_bins, tier = DENSITY_CASES[case]
    heavy, wat, box = _sol_wat(n_waters, seed, solute)
    field, served = _grid_field(heavy, wat, box, n_bins)
    assert served == tier
    assert np.abs(field - level).min() > LEVEL_GAP
    got = grids.density_grid(heavy, wat, box, level=level, n_bins=n_bins, device="cpu")
    assert willard.last_tier == tier
    _same_mesh(got, jgrids.density_grid(heavy, wat, box, level=level, n_bins=n_bins))


@pytest.mark.parametrize("forced", [{"window_x": 8}, {"window": 16}, {"window_x": 0}])
def test_density_grid_forced_windows(forced):
    """A window too narrow fails the certificate and the points kernel
    serves; window_x=0 keeps the plane form. The mesh does not change."""
    n_waters, seed, solute, level, n_bins, _ = DENSITY_CASES["512_waters"]
    heavy, wat, box = _sol_wat(n_waters, seed, solute)
    want = grids.density_grid(heavy, wat, box, level=level, n_bins=n_bins, device="cpu")
    got = grids.density_grid(heavy, wat, box, level=level, n_bins=n_bins, device="cpu", **forced)
    assert willard.last_tier == ("plane" if forced == {"window_x": 0} else "points")
    _same_mesh(got, want)


def test_density_plot_writes_png(tmp_path):
    heavy, wat, box = _sol_wat(64, 14, ["C", "C"])
    out = tmp_path / "densitySurf.png"
    verts, faces = plotting.density_plot(heavy, wat, box, level=DENSITY_CASES["64_waters"][3],
                                         out_png=str(out), device="cpu")
    assert len(faces) > 0 and out.stat().st_size > 1000


def test_density_grid_cuda_without_a_gpu_raises(monkeypatch):
    heavy, wat, box = _sol_wat(64, 14, ["C", "C"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grids.density_grid(heavy, wat, box, device="cuda")
