"""The port's earlier q kernels (ops/cuda/qtet_kernel.py: dense q with its
fused histogram, and over frames; ops/cuda/qtet_sorted.py: the v1 slab q
with a per-frame or a frame-0 z-sort) against the JAX package's Pallas
kernels in TPU interpret mode, as the JAX package's own CPU tests run them.

On CPU tensors the q kernel's wrappers run their plain PyTorch versions. q
agrees to 1e-5 (float32 rounding of the same formula; the JAX kernels' XLA
contractions differ from the port's unfused sums), histogram counts exactly,
`ok` exactly where both packages certify a row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import qtet_kernel as jqk
from waterorderlib_tpu.ops.pallas import qtet_sorted as jqs
from waterorderlib_tpu.order import qtet as jqtet
from waterorderlib_tpu_torch.ops import histograms
from waterorderlib_tpu_torch.ops.cuda import qtet2, qtet_kernel, qtet_sorted, slab

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

T = torch.from_numpy
TOL = 1e-5


def _lattice_traj(n, f, seed):
    """Jittered-lattice frames at water density (bench.py's fixture)."""
    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    pos = np.stack(
        [np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len) for _ in range(f)]
    ).astype(np.float32)
    return pos, np.tile(np.array([box_len] * 3, np.float32), (f, 1))


def _edge_rows(q_port, q_jax):
    """Rows whose q falls in different floor(q * 500) bins in the two
    packages (a q within rounding of a bin edge), as text."""
    bp = np.floor(q_port.astype(np.float32) * np.float32(500))
    bj = np.floor(q_jax.astype(np.float32) * np.float32(500))
    return [f"row {i}: port q {q_port[i]!r} bin {bp[i]:.0f}, jax q {q_jax[i]!r} bin {bj[i]:.0f}"
            for i in np.nonzero(bp != bj)[0]]


def test_dense_q_and_fused_histogram_match_pallas():
    """Row 4: q of 512 waters against all and the fused floor-rule histogram,
    against order_param_q_pallas in interpret mode; also against the plain
    brute form of the port's q contract (the same body)."""
    pos, boxes = _lattice_traj(512, 1, seed=7)
    with pltpu.force_tpu_interpret_mode():
        q_j, h_j = jqk.order_param_q_pallas(jnp.asarray(pos[0]), jnp.asarray(boxes[0]), 0.0, 10.0)
    q_j, h_j = np.asarray(q_j), np.asarray(h_j)
    before = qtet2.q_window_hist_plain.calls
    q, hist = qtet_kernel.order_param_q_dense(T(pos[0]), T(boxes[0]), 0.0, 10.0)
    assert qtet2.q_window_hist_plain.calls == before + 1
    assert q.shape == (512,) and hist.dtype == torch.int32
    np.testing.assert_allclose(q.numpy(), q_j, atol=TOL)
    assert not _edge_rows(q.numpy(), q_j), _edge_rows(q.numpy(), q_j)
    np.testing.assert_array_equal(hist.numpy(), h_j.astype(np.int64))
    q_b = qtet2.order_param_q_frames(T(pos), T(boxes), 0.0, 10.0, row_tile=128)
    assert torch.equal(q, q_b[0])
    assert int(hist.sum()) == int(((q >= 0) & (q <= 1)).sum())


def test_dense_q_frames_match_pallas():
    """Row 5 over 2 frames: q against order_param_q_pallas_frames in
    interpret mode, and its histogram (masked_histogram's threshold rule)."""
    pos, boxes = _lattice_traj(512, 2, seed=8)
    boxes[1] *= np.float32(1.01)
    pos[1] *= np.float32(1.01)
    with pltpu.force_tpu_interpret_mode():
        q_j, h_j = jqk.order_param_q_pallas_frames(jnp.asarray(pos), jnp.asarray(boxes), 0.0, 10.0)
    q_j, h_j = np.asarray(q_j), np.asarray(h_j)
    q, hist = qtet_kernel.order_param_q_dense_frames(T(pos), T(boxes), 0.0, 10.0)
    assert q.shape == (2, 512)
    np.testing.assert_allclose(q.numpy(), q_j, atol=TOL)
    np.testing.assert_array_equal(hist.numpy(), h_j.astype(np.int64))


def test_histogram_rules_differ_on_edges():
    """Row 4's floor rule (bin floor(q * 500) in float32, q == 1 in the last
    bin, values outside [0, 1] dropped) against row 5's threshold rule
    (masked_histogram) on q values at k/500, at exactly 1.0 and below 0."""
    k = np.arange(0, 501, 7)
    q = np.concatenate([(k / 500.0).astype(np.float32), [1.0, 1.0, -1e-7, -0.5, 1.0 + 1e-6]])
    q = q.astype(np.float32)
    want_floor = np.zeros(500, np.int64)
    for v in q:
        if 0.0 <= v <= 1.0:
            want_floor[499 if v == 1.0 else int(np.floor(v * np.float32(500)))] += 1
    floor_hist = qtet2.q_hist(T(q)).numpy()
    np.testing.assert_array_equal(floor_hist, want_floor)
    thr_hist = histograms.masked_histogram(T(q), torch.ones(len(q), dtype=torch.bool), 500, 0.0,
                                           1.0).numpy()
    assert floor_hist.sum() == thr_hist.sum() == len(k) + 2
    # some k/500 lies an ulp under its edge in float32 and the two rules
    # put it in neighboring bins
    assert not np.array_equal(floor_hist, thr_hist)


@pytest.mark.parametrize("fn", ["sorted", "traj"])
def test_sorted_q_matches_pallas(fn):
    """Rows 6 and 7 at 1024 waters x 2 frames against the JAX v1 slab
    kernels in interpret mode: q within 1e-5 where both certify; the port's
    `covered` never false where the JAX one is true; every certified q
    within 1e-5 of the brute q."""
    pos, boxes = _lattice_traj(1024, 2, seed=3)
    jfn = {"sorted": jqs.order_param_q_pallas_sorted, "traj": jqs.order_param_q_pallas_traj}[fn]
    tfn = {"sorted": qtet_sorted.order_param_q_sorted,
           "traj": qtet_sorted.order_param_q_sorted_traj}[fn]
    with pltpu.force_tpu_interpret_mode():
        q_j, ok_j, cov_j = (np.asarray(a) for a in jfn(jnp.asarray(pos), jnp.asarray(boxes)))
    q, ok, cov = (a.numpy() for a in tfn(T(pos), T(boxes)))
    assert cov.all() and ok.mean() > 0.999
    assert not (cov_j & ~cov).any()
    both = ok & ok_j & cov[:, None] & cov_j[:, None]
    assert both.mean() > 0.99
    np.testing.assert_allclose(q[both], q_j[both], atol=TOL)
    q_b = qtet2.order_param_q_frames(T(pos), T(boxes), 0.0, 10.0).numpy()
    np.testing.assert_allclose(q[ok], q_b[ok], atol=TOL)


def test_sorted_q_unsort_and_per_frame_starts():
    """Row 6 without unsort returns each frame in its own z order; frames
    sorted differently get their own window starts, which the plain version
    takes frame by frame."""
    pos, boxes = _lattice_traj(1024, 2, seed=5)
    pos[1] = np.mod(pos[1] + np.float32([0.0, 0.0, 7.3]), boxes[1])  # another z order
    q, ok, cov = qtet_sorted.order_param_q_sorted(T(pos), T(boxes), window=768, pad=256)
    qs, oks, _ = qtet_sorted.order_param_q_sorted(T(pos), T(boxes), window=768, pad=256,
                                                  unsort=False)
    prep = slab.slab_prep_frames(T(pos), T(boxes), 4.5, 768, 128, 256)
    assert prep.starts.shape == (2, 8) and not torch.equal(prep.starts[0], prep.starts[1])
    assert bool(cov.all())
    for f in range(2):
        assert torch.equal(qs[f], q[f, prep.order[f]]) and torch.equal(oks[f], ok[f, prep.order[f]])
    # each frame alone gives the same q
    for f in range(2):
        q1, _, _ = qtet_sorted.order_param_q_sorted(T(pos[f : f + 1]), T(boxes[f : f + 1]),
                                                    window=768, pad=256)
        assert torch.equal(q1[0], q[f])


def test_suggest_window_matches_jax():
    for n, bz in ((1024, 31.3), (4096, 49.7), (131072, 157.0)):
        assert qtet_sorted.suggest_window(n, bz) == jqs.suggest_window(n, bz)


def test_exact_fourth_neighbor_tie_splits_slab_and_brute_in_both_packages():
    """Frame 248 of the 4096-water jittered lattice (seed 1) holds atom
    1870, whose 4th and 5th neighbors lie at exactly equal float32 squared
    distances. q's lowest-column tie-break follows column order: z-sorted in
    the slab forms, atom order in the brute form. So both packages certify
    two different q values there, the same two in each."""
    pos, boxes = _lattice_traj(4096, 249, seed=1)
    pos, boxes = pos[248:], boxes[248:]
    q_s, ok, cov = (a.numpy() for a in qtet_sorted.order_param_q_sorted(T(pos), T(boxes)))
    q_b = qtet2.order_param_q_frames(T(pos), T(boxes), 0.0, 10.0, row_tile=128).numpy()
    apart = ok[0] & cov[0] & (np.abs(q_s[0] - q_b[0]) > TOL)
    assert np.nonzero(apart)[0].tolist() == [1870]
    assert abs(q_s[0, 1870] - q_b[0, 1870]) > 0.4
    with pltpu.force_tpu_interpret_mode():
        q_js, ok_j, _ = (np.asarray(a) for a in jqs.order_param_q_pallas_sorted(
            jnp.asarray(pos), jnp.asarray(boxes)))
    q_jx = np.asarray(jqtet.order_param_q(pos[0], pos[0], boxes[0], 0.0, 10.0, row_block=512))
    assert bool(ok_j[0, 1870])
    np.testing.assert_allclose(q_s[0, 1870], q_js[0, 1870], atol=TOL)
    np.testing.assert_allclose(q_b[0, 1870], q_jx[1870], atol=TOL)
