"""The exactness argument of csrc/hbond.cu's distance test, on the CPU.

The kernel takes the minimum image of its distance test by magnitude,
fminf(|d|, L - |d|), where the plain versions (ops/cuda/hbond.py) and the
TPU kernel (waterorderlib_tpu/ops/pallas/hbond_kernel.py `mi`) take two
compare-selects. For d in (-L, L) the two agree bit for bit on |mi(d)|, so
dsq, its fmaf chain and every count are the same. These tests hold that in
float32 over random d and the edge values (+/-0, +/-half, half +/- 1 ulp,
+/-(L - 1 ulp)) for cubic and NPT boxes, against the port's `_mi` and the
JAX kernel's expression, and show that a bond matrix whose distance test
takes the magnitude form equals the plain version's on water frames with
pairs planted at exactly the cut and at exactly half a box edge. The CUDA
kernel itself is held against the plain versions on the card
(chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.ops.cuda import hbond, window

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

# box edges: the 4096-water box of the H-bond slice, a small box, and the
# three edges of NPT frames (per-frame boxes that differ)
BOXES = {"cubic 4096 waters": 49.6507, "cubic 16 A": 16.0,
         "NPT x": 24.3071, "NPT y": 25.1093, "NPT z": 23.7011}


def _bits(x):
    return x.contiguous().view(torch.int32)


def _mag(d, box_l):
    """csrc/hbond.cu `mi_abs`: fminf(|d|, L - |d|)."""
    a = d.abs()
    return torch.minimum(a, box_l - a)


def _jax_mi(d, box_l):
    """The TPU kernel's minimum image (hbond_kernel.py `mi`), in JAX."""
    d = jnp.asarray(d)
    d = jnp.where(d > box_l * 0.5, d - box_l, d)
    return np.asarray(jnp.where(d < -box_l * 0.5, d + box_l, d))


def _edge_values(box_l):
    """+/-0, +/-half, half +/- 1 ulp, +/-(L - 1 ulp), 1 ulp, and their
    negatives, as float32."""
    L = np.float32(box_l)
    half = L * np.float32(0.5)
    inf = np.float32(np.inf)
    vals = [np.float32(0.0), half, np.nextafter(half, inf), np.nextafter(half, -inf),
            np.nextafter(L, -inf), np.nextafter(np.float32(0.0), inf), L * np.float32(0.25)]
    return np.array(vals + [-v for v in vals], dtype=np.float32)


@pytest.mark.parametrize("name", sorted(BOXES))
def test_magnitude_min_image_equals_compare_selects(name):
    box_l = np.float32(BOXES[name])
    rs = np.random.RandomState(int(box_l * 1000) % 2**31)
    d = np.concatenate([_edge_values(box_l),
                        rs.uniform(-box_l, box_l, 200_000).astype(np.float32)])
    assert np.all(np.abs(d) < box_l)
    dt, L = torch.from_numpy(d), torch.tensor(box_l)
    got = _mag(dt, L)
    want = hbond._mi(dt, L).abs()
    assert torch.equal(_bits(got), _bits(want))
    assert bool((got >= 0).all())  # the magnitude itself, not only its square
    jax_abs = torch.from_numpy(np.abs(_jax_mi(d, box_l)))
    assert torch.equal(_bits(got), _bits(jax_abs))


@pytest.mark.parametrize("name", sorted(BOXES))
def test_magnitude_dsq_equals_plain_dsq(name):
    """dot3 of the magnitudes is the plain version's dot3 of the signed
    images, bit for bit, on displacement vectors with edge components."""
    box_l = np.float32(BOXES[name])
    rs = np.random.RandomState(7)
    e = _edge_values(box_l)
    d = rs.uniform(-box_l, box_l, (3, 50_000)).astype(np.float32)
    d[:, : len(e) ** 2] = np.stack([np.repeat(e, len(e)), np.tile(e, len(e)),
                                    np.roll(np.tile(e, len(e)), 3)])
    dt, L = torch.from_numpy(d), torch.tensor(box_l)
    m = _mag(dt, L)
    s = hbond._mi(dt, L)
    got = window.dot3(m[0], m[0], m[1], m[1], m[2], m[2], fused=True)
    want = window.dot3(s[0], s[0], s[1], s[1], s[2], s[2], fused=True)
    assert torch.equal(_bits(got), _bits(want))


def _bonds_magnitude(a, d, h, v, box_l, dist_sq, cc):
    """hbond._bonds with the kernel's distance test: the magnitude minimum
    image, the same fmaf chain; the angle test as before."""
    m = _mag(d - a, box_l)
    dsq = window.dot3(m[:, 0], m[:, 0], m[:, 1], m[:, 1], m[:, 2], m[:, 2], fused=True)
    bond = (dsq <= dist_sq) & (dsq > 1.0e-2)
    f, r, c = bond.nonzero(as_tuple=True)
    u = hbond._mi(a[f, :, r, 0] - h[f, :, 0, c], box_l[f, :, 0, 0])
    vp = v[f, :, 0, c]
    usq = window.dot3(u[:, 0], u[:, 0], u[:, 1], u[:, 1], u[:, 2], u[:, 2], fused=True)
    t = window.dot3(u[:, 0], vp[:, 0], u[:, 1], vp[:, 1], u[:, 2], vp[:, 2], fused=True)
    bond[f, r, c] = t <= cc * sqrt_f32(usq)
    return bond


def _frames(kind):
    """(acc, don, donh, boxes) float32 torch, (F, N, 3): water-water sets of
    make_water_box(300) x 2 frames; with NPT boxes (frame 1 scaled by
    1.013, frame 2 by 0.987); or planted pairs at exactly the cut (3.5 A
    along x: dsq = 12.25 exactly) and at exactly half a box edge in x, y and
    z (in a box of edges 6, 7 and 6.5 A, so that half an edge is within the
    cut and both compare-selects' branches meet)."""
    if kind == "planted":
        box = np.array([[6.0, 7.0, 6.5], [20.0, 20.0, 20.0]], np.float32)
        acc = np.zeros((2, 4, 3), np.float32)
        don = np.zeros((2, 4, 3), np.float32)
        acc[0, :3] = [0.25, 0.5, 0.75]
        for ax in range(3):
            don[0, ax] = acc[0, ax]
            don[0, ax, ax] += box[0, ax] / 2
        acc[0, 3], don[0, 3] = [1.0, 1.0, 1.0], [4.5, 1.0, 1.0]
        acc[1] = [[1.0, 1.0, 1.0], [17.0, 2.0, 9.0], [0.5, 5.0, 5.0], [5.0, 5.0, 0.5]]
        don[1] = [[4.5, 1.0, 1.0], [17.0, 2.0, 12.5], [10.5, 5.0, 5.0], [5.0, 5.0, 10.5]]
        donh = don.copy()
        donh[:, :, 0] -= 0.9572
        return tuple(torch.from_numpy(x) for x in (acc, don, donh, box))
    top, traj = make_water_box(300, n_frames=3 if kind == "npt" else 2, seed=11)
    w, wh, _ = top.get_wat_inds()
    p = torch.as_tensor(traj.positions, dtype=torch.float32)
    b = torch.as_tensor(traj.boxes, dtype=torch.float32)
    if kind == "npt":
        s = torch.tensor([1.0, 1.013, 0.987], dtype=torch.float32)[:, None]
        p, b = p * s[:, None], b * s
    acc = p[:, w]
    return acc, torch.repeat_interleave(acc, 2, dim=1), p[:, wh], b


@pytest.mark.parametrize("kind", ["water", "npt", "planted"])
def test_magnitude_distance_test_gives_the_plain_bonds(kind):
    acc, don, donh, boxes = _frames(kind)
    prep = hbond.dense_prep(acc, don, donh, boxes)
    ds, cc = torch.tensor(3.5 * 3.5), torch.tensor(hbond.cos_cut(120.0))
    args = (prep.acc[:, :, :, None], prep.don[:, :, None, :], prep.donh[:, :, None, :],
            prep.vhat[:, :, None, :], boxes[:, :, None, None], ds, cc)
    got, want = _bonds_magnitude(*args), hbond._bonds(*args)
    assert torch.equal(got, want)
    counts = hbond.hbond_dense_plain(*prep, boxes, 3.5 * 3.5, hbond.cos_cut(120.0))
    assert torch.equal(got.sum(dim=2, dtype=torch.int32), counts[0])
    assert torch.equal(got.sum(dim=1, dtype=torch.int32), counts[1])
    if kind == "planted":  # the pairs at the cut bond; at half an edge the angle decides
        assert bool(got[1, 0, 0]) and bool(got[0, 3, 3]) and int(got.sum()) >= 4
    else:
        assert int(got.sum()) > 100
