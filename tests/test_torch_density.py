"""The port's density fields (density/fields.py), the Willard kernels'
contracts and certified dispatch (ops/cuda/willard.py), pbc and
`signed_sq_metric` against the JAX package.

The JAX Pallas kernels run in TPU interpret mode, as the JAX package's own
CPU tests run them (five calls, grids of at most 17^3; 9^3 for the
x-windowed and brute forms), and the port's plain
grid version is fed the arrays the JAX prep hands its kernels. Tolerances
are the JAX package's own (tests/test_pallas_kernels.py): density 1e-6
absolute (2e-6 for the x-windowed form), unit normals with dot > 0.98 on at
least 99.9% of points; counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.core import pbc as jpbc
from waterorderlib_tpu.density import fields as jf
from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops import pairs as jpairs
from waterorderlib_tpu.ops.pallas import willard_grid as jwg
from waterorderlib_tpu.ops.pallas import willard_kernel as jwk
from waterorderlib_tpu_torch.core import pbc
from waterorderlib_tpu_torch.density import fields
from waterorderlib_tpu_torch.ops import pairs
from waterorderlib_tpu_torch.ops.cuda import willard

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
DENS_TOL, DENS_TOL_X = 1e-6, 2e-6
N_LAT, NG = 2048, 17


def _t(x):
    return T(np.asarray(x, np.float32))


def _dots_ok(norms, want):
    dots = np.sum(np.asarray(norms) * np.asarray(want), axis=-1)
    return np.mean(dots > 0.98) > 0.999


@pytest.fixture(scope="module")
def lattice():
    """2048 oxygens of the JAX package's jittered lattice, cubic box."""
    box_len = (N_LAT / 0.033456) ** (1.0 / 3.0)
    pos = water_oxygen_lattice(N_LAT, box_len, seed=41).astype(np.float32)
    return pos, np.full(3, box_len, np.float32)


def _grid(box, g0):
    """An NG^3 grid over the box, or from an off-box origin over 6 A more."""
    dg = float((box[0] + 6.0) / NG) if g0 < 0 else float(box[0] / NG)
    return ((g0, dg, NG),) * 3


def _axes(grid):
    return [a.numpy() for a in willard.grid_axes(grid, "cpu")]


def _jax_field(pos, box, grid):
    axes = _axes(grid)
    d, n = jf.willard_density_field(J(pos), *map(J, axes), J(box), 2.4, nx=NG, ny=NG, nz=NG)
    return np.asarray(d), np.asarray(n)


# ---- pbc and the metric ------------------------------------------------------


def test_pbc_wrap_and_minimum_image_match_jax():
    rs = np.random.RandomState(3)
    box = np.array([10.0, 20.0, 0.0], np.float32)  # a zero edge: no wrapping
    pos = (rs.uniform(-35, 35, (500, 3))).astype(np.float32)
    np.testing.assert_array_equal(pbc.wrap_into_box(_t(pos), _t(box)).numpy(),
                                  np.asarray(jpbc.wrap_into_box(J(pos), J(box))))
    np.testing.assert_array_equal(pbc.minimum_image(_t(pos), _t(box)).numpy(),
                                  np.asarray(jpbc.minimum_image(J(pos), J(box))))


@pytest.mark.parametrize("cut", ["scalar", "per_atom"])
def test_signed_sq_metric_matches_jax(cut):
    rs = np.random.RandomState(4)
    box = np.array([20.0, 21.0, 22.0], np.float32)
    sub = rs.uniform(0, 20, (64, 3)).astype(np.float32)
    pos = rs.uniform(0, 20, (9, 3)).astype(np.float32)
    hc = np.float32(2.5) if cut == "scalar" else rs.uniform(1, 3, 9).astype(np.float32)
    got = pairs.signed_sq_metric(_t(sub), _t(pos), _t(box), T(np.asarray(hc))).numpy()
    want = np.asarray(jpairs.signed_sq_metric(J(sub), J(pos), J(box), J(hc)))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---- fields (the tests/test_density.py geometries, and a 2048-atom lattice) ----


def test_willard_single_gaussian_and_normal():
    box = np.array([100.0, 100.0, 100.0], np.float32)
    pos = np.array([[50.0, 50.0, 50.0]], np.float32)
    sig = 2.4
    pts = np.array([[50.0, 50.0, 50.0], [50.0 + 3 * sig + 0.01, 50.0, 50.0],
                    [53.0, 50.0, 50.0]], np.float32)
    dens, norms = fields.willard_density_points(_t(pos), _t(pts), _t(box), sig)
    jd, jn = jf.willard_density_points(J(pos), J(pts), J(box), sig)
    peak = 1.0 / (2 * np.pi * sig**2) ** 1.5
    assert np.isclose(float(dens[0]), peak - np.exp(-4.5) * peak, rtol=1e-4)
    assert float(dens[1]) == 0.0
    assert float(norms[2, 0]) < -0.99  # toward the atom, where the density rises
    np.testing.assert_allclose(dens.numpy(), np.asarray(jd), atol=DENS_TOL)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), atol=1e-6)


@pytest.mark.parametrize("case", ["30_atoms", "lattice"])
def test_willard_density_field_matches_jax(case, lattice):
    if case == "30_atoms":
        rs = np.random.RandomState(0)
        box = np.full(3, 12.0, np.float32)
        pos = rs.uniform(0, 12, (30, 3)).astype(np.float32)
        g = np.linspace(0, 12, 7)[:-1].astype(np.float32)
        axes = [g] * 3
    else:
        pos, box = lattice
        axes = _axes(_grid(box, -7.3))
    n = len(axes[0])
    dens, norms = fields.willard_density_field(_t(pos), *map(_t, axes), _t(box), 2.4,
                                               nx=n, ny=n, nz=n)
    jd, jn = jf.willard_density_field(J(pos), *map(J, axes), J(box), 2.4, nx=n, ny=n, nz=n)
    assert dens.shape == (n, n, n) and norms.shape == (n, n, n, 3)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jd), atol=DENS_TOL)
    assert _dots_ok(norms.numpy(), jn)
    pts = fields.make_grid(*axes)
    np.testing.assert_array_equal(pts, np.asarray(jf.make_grid(*axes)))
    d_pts, _ = fields.willard_density_points(_t(pos), _t(pts), _t(box), 2.4)
    np.testing.assert_array_equal(d_pts.numpy(), dens.numpy().ravel())


@pytest.mark.parametrize("case", ["one_atom", "lattice"])
def test_density_field_matches_jax(case, lattice):
    if case == "one_atom":
        box = np.full(3, 10.0, np.float32)
        pos = np.array([[2.0, 2.0, 2.0]], np.float32)
        g = np.arange(0.0, 10.0, 2.0).astype(np.float32)
    else:
        pos, box = lattice
        g = np.linspace(-3.0, box[0] + 3.0, 9).astype(np.float32)
    n = len(g)
    got = fields.density_field(_t(pos), _t(g), _t(g), _t(g), _t(box), nx=n, ny=n, nz=n).numpy()
    want = np.asarray(jf.density_field(J(pos), J(g), J(g), J(g), J(box), nx=n, ny=n, nz=n))
    np.testing.assert_array_equal(got, want)
    if case == "one_atom":
        assert np.isclose(got[1, 1, 1], 1.0 / 8.0)


@pytest.mark.parametrize("case", ["through_the_boundary", "lattice"])
def test_probe_grid_matches_jax(case, lattice):
    if case == "through_the_boundary":
        box = np.full(3, 20.0, np.float32)
        pos = np.array([[1.0, 0.0, 0.0], [19.5, 0.0, 0.0], [5.0, 5.0, 5.0]], np.float32)
        grid = np.array([[0.0, 0.0, 0.0]], np.float32)
    else:
        pos, box = lattice
        grid = np.random.RandomState(5).uniform(-5, box[0] + 5, (300, 3)).astype(np.float32)
    got = fields.probe_grid(_t(pos), _t(grid), _t(box), 3.1)
    want = np.asarray(jf.probe_grid(J(pos), J(grid), J(box), 3.1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "through_the_boundary":
        assert int(fields.probe_grid(_t(pos), _t(grid), _t(box), 1.1)[0]) == 2


@pytest.mark.parametrize("case", ["inscribed_sphere", "lattice"])
def test_bin_on_grid_matches_jax(case, lattice):
    if case == "inscribed_sphere":
        edges = np.arange(0.0, 4.1, 1.0).astype(np.float32)
        pos = np.array([[0.5, 0.5, 0.5], [0.99, 0.99, 0.99]], np.float32)
    else:
        pos, box = lattice
        edges = np.linspace(2.0, box[0] - 2.0, 12).astype(np.float32)
    n = len(edges)
    got = fields.bin_on_grid(_t(pos), _t(edges), _t(edges), _t(edges), n, n, n)
    want = np.asarray(jf.bin_on_grid(J(pos), J(edges), J(edges), J(edges), n, n, n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() > 0


@pytest.mark.parametrize("case", ["flat", "lattice"])
def test_interface_water_matches_jax(case, lattice):
    if case == "flat":
        box = np.full(3, 50.0, np.float32)
        grid = np.array([[10.0, 10.0, 10.0], [20.0, 10.0, 10.0]], np.float32)
        norm = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
        wat = np.array([[10.0, 10.0, 12.0], [20.0, 10.0, 8.0], [20.0, 10.0, 25.0]], np.float32)
        block = 512
    else:
        wat, box = lattice
        rs = np.random.RandomState(6)
        grid = rs.uniform(0, box[0], (400, 3)).astype(np.float32)
        norm = rs.normal(size=(400, 3)).astype(np.float32)
        norm /= np.linalg.norm(norm, axis=1, keepdims=True)
        block = 300  # several blocks: surf_close crosses them
    got = fields.interface_water(_t(wat), _t(grid), _t(norm), _t(box), 5.0, row_block=block)
    want = jf.interface_water(J(wat), J(grid), J(norm), J(box), 5.0)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.wat_dists.numpy(), np.asarray(want.wat_dists), atol=1e-5)
    if case == "flat":
        np.testing.assert_array_equal(got.wat_close.numpy(), [0, 1, 1])
        assert int(got.num_water) == 2


def test_interface_water_ties_take_the_first_index():
    box = np.full(3, 50.0, np.float32)
    grid = np.array([[10.0, 10.0, 10.0], [12.0, 10.0, 10.0]], np.float32)
    wat = np.array([[11.0, 10.0, 10.0], [11.0, 10.0, 14.0], [11.0, 10.0, 10.0]], np.float32)
    got = fields.interface_water(_t(wat), _t(grid), _t(np.eye(3, dtype=np.float32)[:2]), _t(box),
                                 1.0, row_block=1)
    np.testing.assert_array_equal(got.wat_close.numpy(), [0, 0, 0])
    np.testing.assert_array_equal(got.surf_close.numpy(), [0, 0])


# ---- the grid kernel's plain version fed the JAX prep, against the Pallas kernel ----


def _jax_prep(pos, box, grid, window, pad, window_x=0, pad_x=0):
    """The arrays willard_density_grid hands its Pallas kernel, rebuilt in
    float32 numpy with its operations (willard_grid.py:244-353; stable
    sorts as jnp.argsort), in the port's layout: (atoms (1 or nz, 3, M),
    starts (nz, nx) in atoms, w, form)."""
    (gx0, dgx, nx), _, (gz0, dgz, nz) = grid
    n = pos.shape[0]
    pad = min(pad, n)
    cut = np.float32(3.0 * 2.4)
    wrapped = np.mod(pos, box[None, :])
    sp = wrapped[np.argsort(wrapped[:, 2], kind="stable")]
    gz_w = np.mod(np.float32(gz0) + np.float32(dgz) * np.arange(nz, dtype=np.float32), box[2])
    n128 = max(128, -(-n // 128) * 128)
    if n128 <= window:
        ext = np.concatenate([sp, np.full((n128 - n, 3), 1e6, np.float32)], axis=0)
        return ext.T[None].copy(), np.zeros((nz, nx), np.int32), n128, "brute"
    z_shift = np.array([0.0, 0.0, box[2]], np.float32)
    ext = np.concatenate([sp[-pad:] - z_shift, sp, sp[:pad] + z_shift], axis=0)
    w = min(window, (n // 128) * 128)
    starts = np.searchsorted(ext[:, 2], gz_w - cut, side="left")
    starts = np.clip((starts // 128) * 128, 0, ext.shape[0] - w)
    if not window_x:
        return (ext.T[None].copy(), np.repeat(starts.astype(np.int32)[:, None], nx, axis=1), w,
                "plane")
    win = ext[starts[:, None] + np.arange(w)[None, :]]
    xw = np.mod(win[..., 0], box[0])
    ordx = np.argsort(xw, axis=1, kind="stable")
    win_s = np.take_along_axis(win, ordx[..., None], axis=1)
    win_s[..., 0] = np.take_along_axis(xw, ordx, axis=1)
    px = min(pad_x, w)
    x_shift = np.array([box[0], 0.0, 0.0], np.float32)
    extx = np.concatenate([win_s[:, -px:] - x_shift, win_s, win_s[:, :px] + x_shift], axis=1)
    gx_w = np.mod(np.float32(gx0) + np.float32(dgx) * np.arange(nx, dtype=np.float32), box[0])
    sx = np.stack([np.searchsorted(row, gx_w - cut, side="left") for row in extx[..., 0]])
    sx = np.clip((sx // 128) * 128, 0, extx.shape[1] - window_x).astype(np.int32)
    return extx.transpose(0, 2, 1).copy(), sx, window_x, "x"


def _grid_case(name, lattice):
    """(pos, box, grid, window, pad, window_x, pad_x) of each Pallas case."""
    if name == "plane_offbox_origin":
        pos, box = lattice
        return pos, box, _grid(box, -7.3), 1024, 512, 0, 0
    if name == "x_noncubic_box":
        rs = np.random.RandomState(9)
        box = np.array([34.0, 44.0, 49.0], np.float32)
        pos = (rs.uniform(0, 1, (N_LAT, 3)) * box).astype(np.float32)
        grid = tuple((0.0, float(np.float32(box[d] / 9)), 9) for d in range(3))
        wx, px = jwg.suggest_window_x(N_LAT, float(box[0]), window=1024, slack=1.6)
        assert wx > 0
        return pos, box, grid, 1024, 512, wx, px
    n = int(name.split("_")[1])
    rs = np.random.RandomState(11)
    box_len = (n / 0.033456) ** (1.0 / 3.0)
    pos = rs.uniform(0, box_len, (n, 3)).astype(np.float32)
    box = np.full(3, box_len, np.float32)
    return pos, box, ((0.0, float(box_len / 9), 9),) * 3, 2048, 640, 0, 0


GRID_CASES = ["plane_offbox_origin", "x_noncubic_box", "brute_62", "brute_500"]


@pytest.fixture(scope="module")
def pallas_grid(lattice):
    """willard_density_grid in TPU interpret mode on each case (four calls)."""
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name in GRID_CASES:
            pos, box, grid, window, pad, wx, px = _grid_case(name, lattice)
            flat = [v for axis in grid for v in axis]
            dens, norms, cov = jwg.willard_density_grid(J(pos), J(box), *flat, 2.4, window=window,
                                                        pad=pad, window_x=wx, pad_x=px)
            out[name] = (np.asarray(dens), np.asarray(norms), bool(cov))
    return out


@pytest.mark.parametrize("name", GRID_CASES)
def test_grid_plain_matches_pallas_kernel(name, lattice, pallas_grid):
    pos, box, grid, window, pad, wx, px = _grid_case(name, lattice)
    atoms, starts, w, form = _jax_prep(pos, box, grid, window, pad, wx, px)
    assert form == name.split("_")[0]
    want_d, want_n, covered = pallas_grid[name]
    assert covered
    out = willard.willard_grid_plain(T(np.ascontiguousarray(atoms)), T(starts), w, _t(box), grid)
    tol = DENS_TOL_X if form == "x" else DENS_TOL
    np.testing.assert_allclose(out[0].numpy(), want_d, atol=tol)
    assert _dots_ok(willard._unit(out[1:].permute(1, 2, 3, 0)).numpy(), want_n)
    # the port's own prep and dispatch give the same field
    dens, norms = willard.density_grid_certified(_t(pos), _t(box), grid)
    np.testing.assert_allclose(dens.numpy(), want_d, atol=tol)
    assert _dots_ok(norms.numpy(), want_n)
    assert willard.last_tier in ("x", "plane", "brute")


def test_grid_plain_start_outside_atoms_gives_nan(lattice):
    """A window start outside [0, M - w] gives NaN for its row only."""
    pos, box = lattice
    grid = _grid(box, -7.3)
    prep = willard.grid_prep(_t(pos), _t(box), grid, window_x=0)
    bad = prep.starts.clone()
    bad[3, 4] = prep.atoms.shape[2]  # a window outside the atoms
    out = willard.willard_grid_plain(prep.atoms, bad, prep.w, _t(box), grid)
    assert torch.isnan(out[:, 4, :, 3]).all() and not torch.isnan(out[:, 5, :, 3]).any()


# ---- the points kernel's plain version against the Pallas points kernel ----


@pytest.fixture(scope="module")
def pallas_points(lattice):
    pos, box = lattice
    pts = fields.make_grid(*_axes(_grid(box, -7.3))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        d, n = jwk.willard_density_points_pallas(J(pos), J(pts), J(box), 2.4)
    return pts, np.asarray(d), np.asarray(n)


def test_points_plain_matches_pallas_kernel(lattice, pallas_points):
    pos, box = lattice
    pts, want_d, want_n = pallas_points
    out = willard.willard_points_plain(_t(pos.T.copy()), _t(pts.T.copy()), _t(box))
    np.testing.assert_allclose(out[0].numpy(), want_d, atol=DENS_TOL)
    assert _dots_ok(willard._unit(out[1:].t()).numpy(), want_n)
    d, n = fields.willard_density_points(_t(pos), _t(pts), _t(box))
    np.testing.assert_array_equal(d.numpy(), out[0].numpy())
    jd, _ = _jax_field(pos, box, _grid(box, -7.3))
    np.testing.assert_allclose(want_d, jd.ravel(), atol=DENS_TOL)


# ---- the port's certified dispatch against the XLA field ----


DISPATCH = {  # (window, window_x): tier the port must take
    "auto": ((None, None), "x"),
    "plane": ((None, 0), "plane"),
    "window_n_minus_1_plane": ((N_LAT - 1, 0), "plane"),
    "window_n_plane": ((N_LAT, 0), "plane"),
    "window_n_x": ((N_LAT, None), "x"),
    "window_x_too_narrow": ((None, 8), "points"),
    "window_too_narrow": ((64, 0), "points"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
@pytest.mark.parametrize("g0", [0.0, -7.3])
def test_certified_dispatch_matches_xla_field(case, g0, lattice):
    pos, box = lattice
    (win, wx), tier = DISPATCH[case]
    grid = _grid(box, g0)
    prep = willard.grid_prep(_t(pos), _t(box), grid, window=win, window_x=wx)
    assert prep.w <= N_LAT and (prep.tier != "x" or prep.w <= prep.atoms.shape[2])
    before = (willard.willard_grid_plain.calls, willard.willard_points_plain.calls)
    dens, norms = willard.density_grid_certified(_t(pos), _t(box), grid, window=win, window_x=wx)
    ran = (willard.willard_grid_plain.calls - before[0],
           willard.willard_points_plain.calls - before[1])
    assert willard.last_tier == tier
    assert ran == ((0, 1) if tier == "points" else (1, 0))
    want_d, want_n = _jax_field(pos, box, grid)
    np.testing.assert_allclose(dens.numpy(), want_d, atol=DENS_TOL)
    assert _dots_ok(norms.numpy(), want_n)


def test_small_box_takes_brute_form():
    """A box under two reaches (2 x 7.2 A) in z has no slab: every atom once."""
    rs = np.random.RandomState(12)
    box = np.array([30.0, 30.0, 14.0], np.float32)
    pos = rs.uniform(0, 1, (300, 3)).astype(np.float32) * box
    grid = tuple((0.0, float(box[d] / 9), 9) for d in range(3))
    prep = willard.grid_prep(_t(pos), _t(box), grid)
    assert prep.tier == "brute" and prep.w == 300 and prep.covered
    dens, _ = willard.density_grid_certified(_t(pos), _t(box), grid)
    axes = _axes(grid)
    want, _ = jf.willard_density_field(J(pos), *map(J, axes), J(box), 2.4, nx=9, ny=9, nz=9)
    np.testing.assert_allclose(dens.numpy(), np.asarray(want), atol=DENS_TOL)


def test_wrappers_refuse_bad_inputs(lattice):
    pos, box = lattice
    grid = _grid(box, 0.0)
    prep = willard.grid_prep(_t(pos), _t(box), grid)
    with pytest.raises(ValueError, match="window"):
        willard.willard_grid(prep.atoms, prep.starts, prep.atoms.shape[2] + 1, _t(box), grid)
    with pytest.raises(ValueError, match="starts"):
        willard.willard_grid(prep.atoms, prep.starts.long(), prep.w, _t(box), grid)
    with pytest.raises(ValueError, match="planes"):
        willard.willard_grid(prep.atoms, prep.starts[1:].contiguous(), prep.w, _t(box), grid)
    with pytest.raises(ValueError, match="box"):
        willard.willard_points(_t(pos.T.copy()), _t(pos.T.copy()), _t(box[:2]))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        willard.willard_points(_t(pos.T.copy()).to("meta"), _t(pos.T.copy()).to("meta"),
                               _t(box).to("meta"))
