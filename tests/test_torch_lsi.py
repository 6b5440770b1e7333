"""The port's LSI (order/lsi, the lsi_window and lsi_split_window kernel
contracts, the tier rule and the certified dispatch) against the JAX
package.

Every fixture stores a share of its atoms shifted by +/-L (the same
wrapped frame, other raw coordinates), so the reference's next-shell pick
by raw distance differs from a pick by imaged distance. The JAX Pallas
kernels run in TPU interpret mode, as the JAX package's own CPU tests run
them, fed through `interop` the same prep and raw layout as the port's
plain versions. Tolerances: valid flags and counts exactly; LSI to 2e-5 A^2,
the JAX package's own bound between its kernels and its XLA path (float32
roots and sums of the same gaps; here they agree to ~3e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import lsi_kernel as jlk
from waterorderlib_tpu.ops.pallas import lsi_slab2 as jls
from waterorderlib_tpu.ops.pallas import slab as jslab
from waterorderlib_tpu.order import lsi as jlsi
from reference import refimpl
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.ops.cuda import lsi as tl
from waterorderlib_tpu_torch.ops.cuda import slab, window
from waterorderlib_tpu_torch.order import lsi as tlsi

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
TOL = 2e-5  # A^2
HIGH, OUTER = 3.7, 7.4
PAD = 512


def _box_len(n):
    return (n / 0.033456) ** (1.0 / 3.0)


def _shifted_traj(n, f, seed):
    """Jittered-lattice frames at water density with a third of the atoms
    stored shifted by +/-L along random axes."""
    box_len = _box_len(n)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len)
                    for _ in range(f)])
    some = rs.uniform(size=pos.shape[:2]) < 1.0 / 3.0
    pos = pos + rs.randint(-1, 2, size=pos.shape) * some[..., None] * box_len
    return pos.astype(np.float32), np.tile(np.array([box_len] * 3, np.float32), (f, 1))


def _assert_lsi(got, lsi_w, valid_w, count_w):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(valid_w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(count_w).astype(np.int32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(lsi_w), atol=TOL)


def _raw_t(pos, order0, pad=PAD):
    """The JAX kernels' raw layout (lsi_kernel.py:162-166), in numpy."""
    raw = pos[:, order0, :]
    return np.transpose(np.concatenate([raw[:, -pad:], raw, raw[:, :pad]], axis=1), (0, 2, 1))


def _frames():
    """One frame of a 1024-water lattice with a hand-placed center c near
    z = 0 in mid x, y: each next-shell candidate among its 24 nearest
    (imaged) neighbors is stored shifted by +L in z, so its nearest
    candidate beyond `high` by raw distance lies past those 24, unshifted
    (above the center, raw = imaged distance); a third of the atoms outside
    its 7.4 A shell are stored shifted by +/-L along random axes. Returns
    (pos, boxes, c, the number of the center's candidates shifted)."""
    n = 1024
    box_len = _box_len(n)
    rs = np.random.RandomState(3)
    p = np.mod(water_oxygen_lattice(n, box_len, seed=3) + rs.normal(scale=0.1, size=(n, 3)),
               box_len)
    mid = np.all(np.abs(p[:, :2] - box_len / 2) < 4.0, axis=1)
    c = int(np.flatnonzero(mid)[np.argmin(p[mid, 2])])
    d = p - p[c]
    d -= box_len * np.round(d / box_len)
    dist = np.linalg.norm(d, axis=1)
    dist[c] = np.inf
    top24 = np.argsort(dist, kind="stable")[:24]
    nxt = top24[dist[top24] > HIGH]
    some = (rs.uniform(size=n) < 1.0 / 3.0) & (dist > OUTER)
    p += rs.randint(-1, 2, size=(n, 3)) * some[:, None] * box_len
    p[nxt, 2] += box_len
    return p[None].astype(np.float32), np.array([[box_len] * 3], np.float32), c, len(nxt)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def pallas(frames):
    """The JAX package's K=24 and split-shell kernels (interpret mode) on
    `frames`, in frame-0 z order: {"k24": ..., "split": ...}, each (lsi,
    valid, count, covered)."""
    pos, boxes = (jnp.asarray(a) for a in frames[:2])
    with pltpu.force_tpu_interpret_mode():
        k24 = jlk.lsi_traj(pos, boxes, 0.0, HIGH, window=1024, pad=PAD, unsort=False)
        split = jls.lsi_traj_split(pos, boxes, 0.0, HIGH, window_narrow=768, window_wide=1024,
                                   pad=PAD, seg=256, unsort=False)
    return {"k24": k24, "split": split}


@pytest.mark.parametrize("n", [216, 1024])
def test_lsi_matches_jax(n):
    pos, boxes = _shifted_traj(n, 1, seed=n)
    p, b = pos[0], boxes[0]
    want = jlsi.lsi(p, p, b, 0.0, HIGH, k=24, row_block=512)
    got = tlsi.lsi(T(p), T(p), T(b), 0.0, HIGH, k=24, row_block=512)
    _assert_lsi(got, want.lsi, want.valid, want.count)
    assert float(got.valid.float().mean()) > 0.99


def _k24_plain(pos, boxes):
    """lsi_window on the JAX package's slab prep (window 1024, pad 512):
    its outputs in frame-0 z order, and that order."""
    n = pos.shape[1]
    jp = jslab.slab_prep_traj(jnp.asarray(pos), jnp.asarray(boxes), OUTER, 128, 1024, PAD)
    prep = interop.slab_prep_from_jax(np.asarray(jp.ext_t), (np.asarray(jp.starts),),
                                      (np.asarray(jp.covered),), np.asarray(jp.order0), (jp.w,),
                                      jp.n_tiles, "cpu")
    raw = interop.coords_from_jax(_raw_t(pos, np.asarray(jp.order0)), "cpu")
    outs = tl.lsi_window(prep.ext_t[:, :, PAD : PAD + n], prep.ext_t, prep.starts[0], T(boxes),
                         prep.ws[0], 128, raw[:, :, PAD : PAD + n], raw, 0.0, HIGH, OUTER * OUTER)
    return outs, prep.order0


def test_lsi_window_contract_matches_pallas_kernel(frames, pallas):
    """The JAX prep and raw layout, carried over by interop, through
    lsi_window_plain equal the Pallas K=24 kernel (interpret mode)."""
    v, ok, cnt, cov = pallas["k24"]
    assert bool(np.asarray(cov).all())
    before = tl.lsi_window_plain.calls
    got, _ = _k24_plain(*frames[:2])
    assert tl.lsi_window_plain.calls == before + 1  # CPU tensor -> plain version
    _assert_lsi(got, v, ok, cnt)


def _split_prep(pos, boxes):
    jm = jslab.slab_prep_traj_multi(jnp.asarray(pos), jnp.asarray(boxes),
                                    ((HIGH, 768), (OUTER, 1024)), 128, PAD)
    prep = interop.slab_prep_from_jax(
        np.asarray(jm.ext_t), [np.asarray(s) for s in jm.starts],
        [np.asarray(c) for c in jm.covered], np.asarray(jm.order0), jm.ws, jm.n_tiles, "cpu")
    return prep, interop.coords_from_jax(_raw_t(pos, np.asarray(jm.order0)), "cpu")


def _split_plain(pos, boxes):
    """lsi_split_window on the JAX package's split prep (windows 768 and
    1024, pad 512): its outputs in frame-0 z order, and that order."""
    n = pos.shape[1]
    prep, raw = _split_prep(pos, boxes)
    outs = tl.lsi_split_window(prep.ext_t[:, :, PAD : PAD + n], prep.ext_t, prep.starts[0],
                               T(boxes), prep.ws[0], 128, raw[:, :, PAD : PAD + n], raw,
                               prep.starts[1], prep.ws[1], 0.0, HIGH, HIGH * HIGH, OUTER * OUTER)
    return outs, prep.order0


def test_lsi_split_contract_matches_pallas_kernel(frames, pallas):
    """As above for the split-shell kernel, at the widths of the JAX
    package's own interpret-mode test."""
    v, ok, cnt, cov = pallas["split"]
    assert bool(np.asarray(cov).all())
    (lsi_v, valid, count, incomplete), _ = _split_plain(*frames[:2])
    assert not bool(incomplete.any())
    _assert_lsi((lsi_v, valid, count), v, ok, cnt)


def _cluster_box():
    """512 waters, a 16-member cluster inside one 3.7 A shell (the JAX
    package's count-certificate fixture)."""
    n = 512
    box_len = _box_len(n)
    rs = np.random.RandomState(7)
    pos = np.mod(water_oxygen_lattice(n, box_len, seed=7)
                 + rs.normal(scale=0.1, size=(n, 3)), box_len)
    pos[-16:] = np.clip(pos[0] + rs.normal(scale=1.2, size=(16, 3)), 0.0, box_len - 1e-3)
    return pos[None].astype(np.float32), np.array([[box_len] * 3], np.float32)


def test_split_count_certificate_vetoes(monkeypatch):
    """The cluster overfills the split kernel's 12 in-shell slots: its rows
    come back incomplete (on this box the JAX kernel's `covered` goes False,
    tests/test_pallas_kernels.py:289-313). The certified dispatch, told by
    the tier rule to take the split tier, keeps it: the incomplete rows are
    redone by the split kernel's escalation form, no K=24 kernel runs, and
    every row equals the float64 definition (refimpl: valid flags and counts
    exactly, LSI to TOL), where the JAX package serves the K=24 result."""
    pos, boxes = _cluster_box()
    args = window.brute_form(lambda *a: a, T(pos), T(boxes), 128, raw=True)
    incomplete = tl.lsi_split_window(*args[:8], args[2], pos.shape[1], 0.0, HIGH, HIGH * HIGH,
                                     OUTER * OUTER)[3]
    assert bool(incomplete[0, -16:].any())

    monkeypatch.setattr(tl, "split_tier", lambda *a: True)
    before = (tl.lsi_split_window_plain.calls, tl.lsi_window_plain.calls)
    rows = clock.total("lsi:escalation:rows")
    got = tl.lsi_certified(T(pos), T(boxes))
    assert tl.last_tier == "slab-split"
    assert (tl.lsi_split_window_plain.calls, tl.lsi_window_plain.calls) == (before[0] + 2,
                                                                           before[1])
    assert clock.total("lsi:escalation:rows") - rows == int(incomplete.sum())
    x, b = pos[0].astype(np.float64), boxes[0].astype(np.float64)
    vals, valid, counts = refimpl.lsi(x, x, b, 0.0, HIGH)
    np.testing.assert_array_equal(got[1][0].numpy(), valid)
    np.testing.assert_array_equal(got[2][0].numpy(), counts)
    np.testing.assert_allclose(got[0][0].numpy()[valid], vals, rtol=0, atol=TOL)


def test_hand_placed_center_tiers_differ_each_as_its_jax_tier(frames, pallas):
    """At the hand-placed center the K=24 and split tiers give different
    LSI, and each port tier equals its own JAX tier there."""
    pos, boxes, c, n_shifted = frames
    assert n_shifted >= 10 and pos[0, c, 2] < 3.0
    k24, order0 = _k24_plain(pos, boxes)
    split, _ = _split_plain(pos, boxes)
    r = int(torch.nonzero(order0 == c)[0, 0])  # the center's place in frame-0 z order
    for got, (v, ok, cnt, _) in ((k24, pallas["k24"]), (split, pallas["split"])):
        assert bool(got[1][0, r]) and bool(np.asarray(ok)[0, r])
        _assert_lsi(tuple(o[0, r : r + 1] for o in got[:3]), *(np.asarray(a)[0, r : r + 1]
                                                             for a in (v, ok, cnt)))
    # the K=24 tier is also the JAX XLA path's semantics
    want = jlsi.lsi(pos[0], pos[0], boxes[0], 0.0, HIGH, k=24)
    assert abs(float(k24[0][0, r]) - float(np.asarray(want.lsi)[c])) <= TOL
    assert abs(float(k24[0][0, r]) - float(split[0][0, r])) > 1e-3


@pytest.mark.parametrize("n,split", [(1024, False), (16_384, True), (131_072, True),
                                     (1_048_576, False)])
def test_split_tier_rule(n, split):
    """The JAX package's tiers at water density: the K=24 slab kernel to
    ~8.3k waters, the split kernel to ~140k, then its chunked and HBM K=24
    kernels."""
    assert tl.split_tier(n, _box_len(n), HIGH) is split


def test_certified_takes_split_tier_when_the_rule_says_so(frames, monkeypatch):
    """With the rule forced to the split tier at 1024 waters, the dispatch
    serves the split kernel (its prep covered, no row incomplete); without,
    the K=24 kernel's brute form (its window would reach N), equal to the
    plain path order.lsi."""
    pos, boxes = (T(a) for a in frames[:2])
    got = tl.lsi_certified(pos, boxes)
    assert tl.last_tier == "brute"
    for f in range(pos.shape[0]):
        want = tlsi.lsi(pos[f], pos[f], boxes[f], 0.0, HIGH)
        _assert_lsi(tuple(o[f] for o in got), want.lsi, want.valid, want.count)
    monkeypatch.setattr(tl, "split_tier", lambda *a: True)
    got = tl.lsi_certified(pos, boxes)
    assert tl.last_tier == "slab-split"
    brute = window.brute_form(lambda *a: a, pos, boxes, 128, raw=True)
    want = tl.lsi_split_window_plain(*brute[:8], brute[2], pos.shape[1], 0.0, HIGH, HIGH * HIGH,
                                     OUTER * OUTER)
    _assert_lsi(got, *want[:3])


@pytest.mark.parametrize("split", [False, True])
def test_window_out_of_range_start_gives_nan(split):
    ext = torch.rand(1, 3, 300)
    starts = torch.tensor([0, 50], dtype=torch.int32)
    args = (ext, ext, starts, torch.ones(1, 3), 260, 256, ext, ext)
    out = (tl.lsi_split_window(*args, starts, 260, 0.0, 0.3, 0.09, 0.5) if split
           else tl.lsi_window(*args, 0.0, 0.3, 0.5))
    assert torch.isfinite(out[0][0, :256]).all() and torch.isnan(out[0][0, 256:]).all()
    assert not out[1][0, 256:].any() and (out[2][0, 256:] == 0).all()
    if split:
        assert out[3][0, 256:].all()  # uncertified


@pytest.mark.parametrize("split", [False, True])
def test_window_raises_on_other_devices(split):
    ext = torch.rand(1, 3, 256, device="meta")
    starts = torch.zeros(1, dtype=torch.int32, device="meta")
    args = (ext, ext, starts, torch.ones(1, 3, device="meta"), 256, 256, ext, ext)
    with pytest.raises(RuntimeError):
        if split:
            tl.lsi_split_window(*args, starts, 256, 0.0, 1.0, 1.0, 4.0)
        else:
            tl.lsi_window(*args, 0.0, 1.0, 4.0)


def test_raw_layout_keeps_stored_coordinates():
    """The raw layout holds the stored coordinates in the extended array's
    column order, its pad copies unshifted; the wrapped layout's pad copies
    are shifted by +/-L."""
    pos, boxes = _shifted_traj(256, 1, seed=1)
    prep = slab.slab_prep_traj(T(pos), T(boxes), ((OUTER, 256),), 128, 128)
    raw = slab.raw_ext_t(T(pos), prep.order0, 128).numpy()
    np.testing.assert_array_equal(raw, _raw_t(pos, prep.order0.numpy(), 128))
    wrapped = np.mod(pos[0, prep.order0.numpy()], boxes[0])
    np.testing.assert_allclose(prep.ext_t[0, 2, :128].numpy(), wrapped[-128:, 2] - boxes[0, 2],
                               rtol=0, atol=1e-5)

