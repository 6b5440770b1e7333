"""Port primitives (pbc, neighbor search, histograms) against the JAX package.

The same numpy inputs go through both packages; float results agree to
float32 rounding (1e-5), integer results (indices, counts) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu.core import pbc as jpbc
from waterorderlib_tpu.ops import histograms as jhist
from waterorderlib_tpu.ops import pairs as jpairs
from waterorderlib_tpu_torch.core import pbc as tpbc
from waterorderlib_tpu_torch.ops import histograms as thist
from waterorderlib_tpu_torch.ops import pairs as tpairs

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy


def _points(seed, n, box):
    rs = np.random.RandomState(seed)
    # coordinates straddle the box on both sides, so wrapping sees negatives
    return rs.uniform(-0.7, 1.7, (n, 3)).astype(np.float32) * box


@pytest.mark.parametrize("box", [
    np.array([18.6, 18.6, 18.6], np.float32),
    np.array([12.0, 20.0, 0.0], np.float32),  # non-positive edge: no wrapping
])
@pytest.mark.parametrize("name", ["minimum_image", "displacement", "distance_sq", "wrap_into_box"])
def test_pbc_matches_jax(name, box):
    a, b = _points(1, 64, box), _points(2, 64, box)
    if name == "minimum_image":
        want, got = jpbc.minimum_image(a - b, box), tpbc.minimum_image(T(a - b), T(box))
    elif name == "wrap_into_box":
        want, got = jpbc.wrap_into_box(a, box), tpbc.wrap_into_box(T(a), T(box))
    else:
        want = getattr(jpbc, name)(a, b, box)
        got = getattr(tpbc, name)(T(a), T(b), T(box))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_inverse_box_zero_edge():
    box = np.array([4.0, 0.0, -1.0], np.float32)
    np.testing.assert_array_equal(tpbc.inverse_box(T(box)).numpy(), np.asarray(jpbc.inverse_box(box)))


def test_minimum_image_rounds_half_to_even():
    box = np.array([10.0, 10.0, 10.0], np.float32)
    d = np.array([[5.0, -5.0, 15.0]], np.float32)
    np.testing.assert_array_equal(
        tpbc.minimum_image(T(d), T(box)).numpy(), np.asarray(jpbc.minimum_image(d, box))
    )


def test_pair_dist_and_masks_match_jax(small_box):
    pos, box = small_box
    pos, box = pos.astype(np.float32), box.astype(np.float32)
    sub = pos[:40]
    np.testing.assert_allclose(
        tpairs.pair_dist_sq(T(sub), T(pos), T(box)).numpy(),
        np.asarray(jpairs.pair_dist_sq(sub, pos, box)), rtol=1e-6, atol=1e-5,
    )
    np.testing.assert_array_equal(
        tpairs.neighbor_mask(T(sub), T(pos), T(box), 2.5, 3.413).numpy(),
        np.asarray(jpairs.neighbor_mask(sub, pos, box, 2.5, 3.413)),
    )
    np.testing.assert_array_equal(
        tpairs.neighbor_counts(T(sub), T(pos), T(box), 0.0, 3.413, row_block=16).numpy(),
        np.asarray(jpairs.neighbor_counts(sub, pos, box, 0.0, 3.413, row_block=16)),
    )


@pytest.mark.parametrize("k,high_cut", [(4, 3.413), (6, 10.0), (8, np.inf)])
def test_topk_neighbors_match_jax(small_box, k, high_cut):
    pos, box = small_box
    pos, box = pos.astype(np.float32), box.astype(np.float32)
    want = jpairs.topk_neighbors(pos[:50], pos, box, k, 0.0, high_cut, row_block=16)
    got = tpairs.topk_neighbors(T(pos[:50]), T(pos), T(box), k, 0.0, high_cut, row_block=16)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist), rtol=1e-6)


def test_topk_ties_keep_lower_index_first():
    """On an exact lattice every shell is a tie; both packages must list the
    tied neighbors lowest index first, and pad a short shell the same way."""
    g = np.arange(4, dtype=np.float32) * 3.0
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    box = np.array([12.0, 12.0, 12.0], np.float32)
    for k, high in ((12, 4.3), (8, 3.0)):  # 18 tied, then 6 tied < k
        want = jpairs.topk_neighbors(pos, pos, box, k, 0.0, high)
        got = tpairs.topk_neighbors(T(pos), T(pos), T(box), k, 0.0, high)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def _edge_values():
    """Values exactly on the float32 thresholds lo + k*width, at hi, just
    inside and outside [lo, hi], and random ones."""
    lo, hi, n_bins = 0.0, 1.0, 500
    thr = np.float32(lo) + np.arange(n_bins + 1, dtype=np.float32) * np.float32((hi - lo) / n_bins)
    rs = np.random.RandomState(5)
    extra = np.array([hi, hi, lo, -1e-7, 1.0000001, -0.5, 1.5], np.float32)
    vals = np.concatenate([thr, np.nextafter(thr, np.float32(2)), extra,
                           rs.uniform(-0.1, 1.1, 300).astype(np.float32)])
    return vals, lo, hi, n_bins


@pytest.mark.parametrize("mask_kind", ["all", "random", "none"])
def test_masked_histogram_counts_equal_jax_on_edges(mask_kind):
    vals, lo, hi, n_bins = _edge_values()
    rs = np.random.RandomState(9)
    mask = {"all": np.ones(vals.shape, bool), "none": np.zeros(vals.shape, bool),
            "random": rs.rand(vals.size) < 0.5}[mask_kind]
    want = np.asarray(jhist.masked_histogram(vals, mask, n_bins, lo, hi)).astype(np.int64)
    got = thist.masked_histogram(T(vals), T(mask), n_bins, lo, hi)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if mask_kind == "all":
        assert got[-1] >= 2  # both values equal to hi land in the last bin


def test_bin_centers_equal():
    np.testing.assert_array_equal(thist.bin_centers(500, 0.0, 1.0), jhist.bin_centers(500, 0.0, 1.0))


def test_masked_mean_var_matches_jax_and_empty_is_nan():
    rs = np.random.RandomState(3)
    vals = rs.normal(size=(6, 40)).astype(np.float32)
    mask = rs.rand(6, 3, 40) < 0.4
    mask[2, 1] = False  # an empty population
    want_m, want_v = jhist.masked_mean_var(vals[:, None, :], mask)
    got_m, got_v = thist.masked_mean_var(T(vals)[:, None, :], T(mask))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-6)
    assert np.isnan(got_m[2, 1].item()) and np.isnan(got_v[2, 1].item())
