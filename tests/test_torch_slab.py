"""The port's slab prep under a box that changes between frames (NPT).

The windows are placed with frame 0's z and box; the port adds
max_f |L_f - L_0| (z edges) to the measured drift before it inflates the
margin. Two fixtures of 1024 waters:
- shrink: a jittered lattice whose z edge shrinks by 3% over 4 frames, the
  atoms scaled with it;
- vacuum: two identical frames of a lattice squeezed into the lower 97% of
  frame 0's box, frame 1's z edge shrunk onto it (the box moves, no atom
  does), the sharpest case for the drift measure.
Every certified dispatch equals its brute form on both, and so does each
kernel contract's slab form wherever the port's prep certifies it: q to
1e-5, angles to 1e-4 degrees, psi to 1e-5, LSI to 2e-5 A^2 (the slab form's
pad copies hold coordinates shifted by +/-L, so displacements round apart
from the brute form's); counts and flags exactly. A geometric check counts
the (row, neighbor) pairs within the margin that their row tile's window
misses: none where the port certifies; the JAX package's prep is reported
beside it (ROADMAP queue 3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import slab as jslab
from waterorderlib_tpu_torch.ops.cuda import angles, lsi, psi6, qtet2, slab, window

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
N = 1024


def _lattice(seed):
    box_len = (N / 0.033456) ** (1.0 / 3.0)
    return water_oxygen_lattice(N, box_len, seed=seed), box_len


def _shrink():
    base, box_len = _lattice(11)
    rs = np.random.RandomState(11)
    scale = 1.0 - 0.01 * np.arange(4)  # the z edge shrinks by 3% over 4 frames
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len) * [1, 1, s]
                    for s in scale]).astype(np.float32)
    boxes = np.array([[box_len, box_len, box_len * s] for s in scale], np.float32)
    return pos, boxes


def _vacuum():
    base, box_len = _lattice(37)
    pos = np.stack([base * [1, 1, 0.97]] * 2).astype(np.float32)
    boxes = np.array([[box_len] * 3, [box_len, box_len, box_len * 0.97]], np.float32)
    return pos, boxes


FIXTURES = {"shrink": _shrink(), "vacuum": _vacuum()}

# name -> (kernel, margin, row tile, scalars, takes raw coordinates, tolerance)
KERNELS = {
    "q": (qtet2.q_window, 4.5, 256, (0.0, 100.0, 4.5 ** 2), False, 1e-5),
    "angles": (angles.angles_window, 4.5, 128, (0.0, 3.413 ** 2), False, 1e-4),
    "psi6": (psi6.psi6_window, 7.0, 128, (0.0, 49.0), False, 1e-5),
    "lsi": (lsi.lsi_window, 7.4, 128, (0.0, 3.7, 7.4 ** 2), True, 2e-5),
}


def _certified(name, pos, boxes):
    if name == "q":
        return (qtet2.order_param_q_certified(pos, boxes),)
    return {"angles": angles.neighbor_pair_angles_certified, "psi6": psi6.psi6_certified,
            "lsi": lsi.lsi_certified}[name](pos, boxes)


@functools.cache
def _brute(name, fixture):
    """The brute form of kernel `name` on a fixture (computed once)."""
    pos, boxes = (T(a) for a in FIXTURES[fixture])
    kernel, _, row_tile, scalars, raw, _ = KERNELS[name]
    if name == "q":  # the brute q takes its margin at high_cut
        return (qtet2.order_param_q_frames(pos, boxes),)
    return window.brute_form(kernel, pos, boxes, row_tile, *scalars, raw=raw)


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def window_misses(starts, w, order0, pad, pos, boxes, cutoff, row_tile):
    """(row, neighbor) pairs within `cutoff` (min-image, each frame's box)
    none of whose column copies lies in the row's tile window."""
    n = pos.shape[1]
    rank = np.empty(n, np.int64)
    rank[order0] = np.arange(n)
    misses = 0
    for f in range(pos.shape[0]):
        p = np.mod(pos[f].astype(np.float64), boxes[f])
        d = p[:, None, :] - p[None, :, :]
        d -= boxes[f] * np.round(d / boxes[f])
        near = (d * d).sum(-1) <= cutoff * cutoff
        np.fill_diagonal(near, False)
        i, j = np.nonzero(near)
        s = starts[rank[i] // row_tile]
        k = rank[j]
        inside = (s <= pad + k) & (pad + k < s + w)  # the atom's own column
        left = k - (n - pad)  # its copy in the left pad, when k >= n - pad
        inside |= (k >= n - pad) & (s <= left) & (left < s + w)
        right = pad + n + k  # its copy in the right pad, when k < pad
        inside |= (k < pad) & (s <= right) & (right < s + w)
        misses += int((~inside).sum())
    return misses


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_certified_dispatch_equals_brute_form(fixture, name):
    pos, boxes = (T(a) for a in FIXTURES[fixture])
    _assert_close(_certified(name, pos, boxes), _brute(name, fixture), KERNELS[name][5])


@pytest.mark.parametrize("name", list(KERNELS))
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_certified_slab_form_misses_nothing(fixture, name):
    """The slab form at a window narrower than N: the guarded prep
    certifies it, no window misses a neighbor within the margin, and the
    slab form equals the brute form."""
    pos_np, boxes_np = FIXTURES[fixture]
    kernel, margin, row_tile, scalars, raw, tol = KERNELS[name]
    pos, boxes = T(pos_np), T(boxes_np)
    pad = 512
    prep = slab.slab_prep_traj(pos, boxes, ((margin, 960),), row_tile, pad)
    assert prep.ws[0] < N and bool(prep.covered[0].all())
    assert window_misses(prep.starts[0].numpy(), prep.ws[0], prep.order0.numpy(), pad, pos_np, boxes_np,
                         margin, row_tile) == 0
    extra = ()
    if raw:
        raw_t = slab.raw_ext_t(pos, prep.order0, pad)
        extra = (raw_t[:, :, pad : pad + N], raw_t)
    outs = kernel(prep.ext_t[:, :, pad : pad + N], prep.ext_t, prep.starts[0], boxes, prep.ws[0],
                  row_tile, *extra, *scalars)
    got = tuple(slab.unsort_frames(o, prep.order0) for o in outs)
    _assert_close(got, _brute(name, fixture), tol)


@pytest.mark.parametrize("fixture,jax_misses", [("shrink", 0), ("vacuum", 1)])
def test_jax_prep_on_changing_box_is_reported(fixture, jax_misses):
    """At margin 4.5, window 768, pad 512: the port's prep certifies and
    misses nothing; the JAX package's prep certifies too, and on the vacuum
    fixture its frame-1 windows miss one pair within the margin (4.49 A,
    the row's 15th neighbor, so q is unchanged): a fault of the reference,
    recorded in ROADMAP queue 3, which the port does not copy."""
    pos, boxes = FIXTURES[fixture]
    margin, win, pad = 4.5, 768, 512
    got = slab.slab_prep_traj(T(pos), T(boxes), ((margin, win),), 128, pad)
    assert bool(got.covered[0].all())
    assert window_misses(got.starts[0].numpy(), got.ws[0], got.order0.numpy(), pad, pos, boxes,
                         margin, 128) == 0
    jp = jslab.slab_prep_traj(jnp.asarray(pos), jnp.asarray(boxes), margin, 128, win, pad)
    assert bool(np.asarray(jp.covered).all())
    assert window_misses(np.asarray(jp.starts) * 128, jp.w, np.asarray(jp.order0), pad, pos,
                         boxes, margin, 128) == jax_misses


def test_constant_box_adds_no_drift():
    """With a constant box the guard adds exactly 0: the windows equal those
    of frame 0 alone, and the multi-window prep gives each spec the windows
    of a single-spec prep."""
    pos, boxes = FIXTURES["shrink"]
    pos, boxes = T(pos[:1].repeat(3, 0)), T(np.repeat(boxes[:1], 3, 0))
    one = slab.slab_prep_traj(pos[:1], boxes[:1], ((7.4, 960),), 128, 512)
    three = slab.slab_prep_traj(pos, boxes, ((7.4, 960),), 128, 512)
    assert torch.equal(one.starts[0], three.starts[0]) and one.ws == three.ws
    multi = slab.slab_prep_traj(pos, boxes, ((3.7, 640), (7.4, 960)), 128, 512)
    narrow = slab.slab_prep_traj(pos, boxes, ((3.7, 640),), 128, 512)
    assert torch.equal(multi.starts[0], narrow.starts[0])
    assert torch.equal(multi.starts[1], three.starts[0])
    assert multi.ws == narrow.ws + three.ws and torch.equal(multi.ext_t, three.ext_t)
