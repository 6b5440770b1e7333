"""The port's core/geometry.py against waterorderlib_tpu.core.geometry.

Inputs are made from seeded numpy and handed to both packages. Values agree
within 1e-6 (relative, with 1e-6 absolute near zero): sums of products are
the same fused multiply-add chains, but XLA's fusion decides per expression
whether it contracts them. Angles are compared by their cosines within 1e-6:
XLA's arccos is its own approximation, and near 0 and 180 degrees one
float32 ulp of cosine is up to ~2e-4 degrees. Degenerate angles are exactly
0 in both. `sphere_points` is a copy and bit-equal.
"""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.core import geometry as jgeo
from waterorderlib_tpu_torch.core import geometry as tgeo

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

T = torch.from_numpy
TOL = 1e-6
BOX = np.array([12.0, 13.0, 14.0], np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _same_angles(got, want):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(np.cos(np.radians(got)), np.cos(np.radians(want)), atol=TOL)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def _unit(rs, shape):
    v = rs.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _waters(rs, f, nw):
    o = rs.uniform(0, 12, (f, nw, 3)).astype(np.float32)
    h = (np.repeat(o, 2, axis=1) + rs.normal(scale=0.6, size=(f, 2 * nw, 3))).astype(np.float32)
    h[:, ::7] += BOX  # some hydrogens stored an image away
    return o, h


def test_centroid_and_rg():
    rs = np.random.RandomState(0)
    pos = rs.uniform(0, 12, (5, 40, 3)).astype(np.float32)
    w = rs.uniform(0.5, 2, (5, 40)).astype(np.float32)
    _close(tgeo.centroid(T(pos)), jgeo.centroid(pos))
    _close(tgeo.centroid(T(pos), axis=0), jgeo.centroid(pos, axis=0))
    _close(tgeo.rg_weights(T(pos), T(w)), jgeo.rg_weights(pos, w))


def test_cos_angle_with_degenerate_vertices():
    rs = np.random.RandomState(1)
    p1, p2, p3 = (rs.uniform(0, 5, (200, 3)).astype(np.float32) for _ in range(3))
    p1[:5] = p2[:5]
    p3[5:10] = p2[5:10]
    p3[10:12] = p1[10:12]  # 0 degrees
    p3[12:14] = 2 * p2[12:14] - p1[12:14]  # 180 degrees
    got = tgeo.cos_angle_deg(T(p1), T(p2), T(p3))
    want = jgeo.cos_angle_deg(p1, p2, p3)
    _same_angles(got, want)
    assert np.all(got.numpy()[:10] == 0.0) and np.all(np.asarray(want)[:10] == 0.0)


def test_angle_between_and_pair_angles():
    rs = np.random.RandomState(2)
    v1, v2 = _unit(rs, (300,)), _unit(rs, (300,))
    v2[:3] = v1[:3]
    _same_angles(tgeo.angle_between_deg(T(v1), T(v2)), jgeo.angle_between_deg(v1, v2))
    ref = rs.uniform(0, 12, (30, 3)).astype(np.float32)
    neigh = rs.uniform(0, 12, (30, 8, 3)).astype(np.float32)
    neigh[0, 3] = ref[0]  # a neighbor on the vertex: a zero norm
    got = tgeo.pair_angles_deg(T(ref), T(neigh), T(BOX))
    want = jgeo.pair_angles_deg(ref, neigh, BOX)
    _same_angles(got, want)
    assert np.all(np.diagonal(got.numpy(), axis1=-2, axis2=-1) == 0.0)


def test_imaged_distances_and_displacements():
    rs = np.random.RandomState(3)
    ref = rs.uniform(0, 12, (30, 3)).astype(np.float32)
    neigh = rs.uniform(-12, 24, (30, 8, 3)).astype(np.float32)
    _close(tgeo.imaged_distances(T(ref), T(neigh), T(BOX)), jgeo.imaged_distances(ref, neigh, BOX))
    pos, prev, refp = (rs.uniform(0, 12, (40, 3)).astype(np.float32) for _ in range(3))
    for got, want in zip(tgeo.squared_displacement(T(pos), T(prev), T(refp), T(BOX)),
                         jgeo.squared_displacement(pos, prev, refp, BOX)):
        _close(got, want)


@pytest.mark.parametrize("normalize", [True, False])
def test_water_dipoles(normalize):
    o, h = _waters(np.random.RandomState(4), 3, 20)
    _close(tgeo.water_dipoles(T(o), T(h), T(BOX), normalize=normalize),
           jgeo.water_dipoles(o, h, BOX, normalize=normalize))


def test_water_orientation():
    rs = np.random.RandomState(5)
    o, h = _waters(rs, 3, 20)
    refvec = np.array([0.3, -0.2, 2.0], np.float32)
    for got, want in zip(tgeo.water_orientation(T(o), T(h), T(refvec), T(BOX)),
                         jgeo.water_orientation(o, h, refvec, BOX)):
        _same_angles(got, want)


@pytest.mark.parametrize("n", [1, 30, 240, 1000])
def test_sphere_points_bit_equal(n):
    got, want = tgeo.sphere_points(n), jgeo.sphere_points(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
