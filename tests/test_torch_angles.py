"""The port's 3-body angles and psi6 (order/angles, order/psi6, the
angles_window and psi6_window kernel contracts and their certified
dispatch) against the JAX package.

The JAX Pallas kernels run here in TPU interpret mode, as the JAX package's
own CPU tests run them; the port's kernel contracts run their plain PyTorch
versions (on a CPU tensor the wrappers dispatch to them). Counts and
validity agree exactly; angles to 1e-4 degrees, psi to 1e-5 (float32
rounding of the same formulas). Against the independent plain paths the
window kernels are held as the JAX package holds its kernels against XLA:
angle multisets to 5e-3 degrees (polynomial arccos), psi to 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import angles_kernel as jak
from waterorderlib_tpu.ops.pallas import psi6_kernel as jpk
from waterorderlib_tpu.ops.pallas import slab as jslab
from waterorderlib_tpu.order import angles as jangles
from waterorderlib_tpu.order import psi6 as jpsi6
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.ops.cuda import angles as tak
from waterorderlib_tpu_torch.ops.cuda import psi6 as tpk
from waterorderlib_tpu_torch.ops.cuda import window
from waterorderlib_tpu_torch.order import angles as tangles
from waterorderlib_tpu_torch.order import psi6 as tpsi6

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
ANG_TOL = 1e-4   # degrees
PSI_TOL = 1e-5


def _lattice_traj(n, f, seed):
    """Jittered-lattice frames at water density (bench.py's fixture)."""
    box_len = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, box_len, seed=seed)
    pos = np.stack(
        [np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len) for _ in range(f)]
    ).astype(np.float32)
    return pos, np.tile(np.array([box_len] * 3, np.float32), (f, 1))


@pytest.mark.parametrize("n", [216, 1024])
def test_neighbor_angles_match_jax(n):
    pos, boxes = _lattice_traj(n, 1, seed=n)
    p, b = pos[0], boxes[0]
    want = jangles.neighbor_angles(p, p, b, 0.0, 3.413, k=16, row_block=128)
    got = tangles.neighbor_angles(T(p), T(p), T(b), 0.0, 3.413, k=16, row_block=128)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.ang.numpy()[valid], np.asarray(want.ang)[valid], atol=ANG_TOL)


@pytest.mark.parametrize("n", [216, 1024])
def test_order_psi_matches_jax(n):
    pos, boxes = _lattice_traj(n, 1, seed=n + 1)
    p, b = pos[0], boxes[0]
    want = np.asarray(jpsi6.order_param_psi(p, p, b, 0.0, 7.0, k=24, row_block=128))
    got = tpsi6.order_param_psi(T(p), T(p), T(b), 0.0, 7.0, k=24, row_block=128).numpy()
    np.testing.assert_allclose(got, want, atol=PSI_TOL)


def test_tetrahedral_metrics_match_jax():
    """AngleSet metrics, and the flat form on the kernel layout; the flat
    form with a leading frame axis gives one set of metrics per frame."""
    pos, boxes = _lattice_traj(1024, 2, seed=7)
    p, b = pos[0], boxes[0]
    want = jangles.tetrahedral_metrics(jangles.neighbor_angles(p, p, b, 0.0, 3.413))
    got = tangles.tetrahedral_metrics(tangles.neighbor_angles(T(p), T(p), T(b), 0.0, 3.413))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # torch.acos and XLA's arccos may put an angle on either side of a bin edge
    assert np.abs(got.hist.numpy() - np.asarray(want.hist)).sum() <= 4

    ang, cnt = window.brute_form(tak.angles_window, T(pos), T(boxes), 128, 0.0, 3.413 ** 2)
    valid = tak.pair_validity(cnt)
    flat = tangles.tetrahedral_metrics_flat(ang, valid)
    assert flat.hist.shape == (2, 500) and flat.frac_tet.shape == (2,)
    for f in range(2):
        w = jangles.tetrahedral_metrics_flat(ang[f].numpy(), valid[f].numpy())
        np.testing.assert_array_equal(flat.hist[f].numpy(), np.asarray(w.hist).astype(np.int64))
        for g, ww in zip(flat[1:], w[1:]):
            np.testing.assert_allclose(g[f].numpy(), np.asarray(ww), rtol=1e-5, atol=1e-6)


def test_pair_angles_from_positions_matches_jax():
    rs = np.random.RandomState(3)
    ref = rs.uniform(0, 12, (5, 3)).astype(np.float32)
    neigh = (ref[:, None, :] + rs.normal(scale=2.0, size=(5, 6, 3))).astype(np.float32)
    box = np.array([12.0, 12.0, 12.0], np.float32)
    want = np.asarray(jangles.pair_angles_from_positions(ref, neigh, box))
    got = tangles.pair_angles_from_positions(T(ref), T(neigh), T(box)).numpy()
    np.testing.assert_allclose(got, want, atol=ANG_TOL)


def test_pair_validity_matches_jax():
    cnt = np.array([[0, 1, 2, 5], [15, 16, 17, 40]], np.int32)
    np.testing.assert_array_equal(tak.pair_validity(T(cnt)).numpy(),
                                  np.asarray(jak.pair_validity(jnp.asarray(cnt))))


def _prep_from_jax(pos, boxes, margin, window, pad):
    jp = jslab.slab_prep_traj(jnp.asarray(pos), jnp.asarray(boxes), margin, 128, window, pad)
    return interop.slab_prep_from_jax(
        np.asarray(jp.ext_t), (np.asarray(jp.starts),), (np.asarray(jp.covered),),
        np.asarray(jp.order0), (jp.w,), jp.n_tiles, "cpu",
    )


def test_angles_contract_matches_pallas_kernel():
    """The JAX prep, carried over by interop, through angles_window_plain
    equals the Pallas kernel (interpret mode) slot for slot."""
    n, window, pad = 1024, 896, 256
    pos, boxes = _lattice_traj(n, 2, seed=17)
    with pltpu.force_tpu_interpret_mode():
        ang_w, cnt_w, cov_w = jak.neighbor_pair_angles_traj(
            jnp.asarray(pos), jnp.asarray(boxes), 0.0, 3.413, window=window, pad=pad,
            unsort=False,
        )
    assert bool(np.asarray(cov_w).all())
    prep = _prep_from_jax(pos, boxes, 4.5, window, pad)
    before = tak.angles_window_plain.calls
    ang, cnt = tak.angles_window(prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0],
                                 T(boxes), prep.ws[0], 128, 0.0, 3.413 ** 2)
    assert tak.angles_window_plain.calls == before + 1  # CPU tensor -> plain version
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w).astype(np.int32))
    np.testing.assert_array_equal(tak.pair_validity(cnt).numpy(),
                                  np.asarray(jak.pair_validity(cnt_w)))
    np.testing.assert_allclose(ang.numpy(), np.asarray(ang_w), atol=ANG_TOL)


def test_psi6_contract_matches_pallas_kernel():
    """As above for psi6 (at 1024 atoms with pad 256 the JAX prep is not
    covered, so 4096 atoms with pad 1408)."""
    n, window, pad = 4096, 2048, 1408
    pos, boxes = _lattice_traj(n, 1, seed=5)
    with pltpu.force_tpu_interpret_mode():
        psi_w, cnt_w, cov_w = jpk.psi6_traj(
            jnp.asarray(pos), jnp.asarray(boxes), 0.0, 7.0, window=window, pad=pad, unsort=False,
        )
    assert bool(np.asarray(cov_w).all())
    prep = _prep_from_jax(pos, boxes, 7.0, window, pad)
    psi, cnt = tpk.psi6_window(prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0],
                               T(boxes), prep.ws[0], 128, 0.0, 49.0)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w).astype(np.int32))
    np.testing.assert_allclose(psi.numpy(), np.asarray(psi_w), atol=PSI_TOL)


def _sorted_valid(ang, valid):
    """Per-center ascending valid angles, padded with -1 at the front."""
    return np.sort(np.where(valid, ang, -1.0).reshape(ang.shape[0], -1), axis=1)


@pytest.mark.parametrize("n,tier", [(4096, "slab"), (512, "brute")])
def test_certified_angles_tier_and_values(n, tier):
    pos, boxes = _lattice_traj(n, 1, seed=n + 3)
    ang, cnt = tak.neighbor_pair_angles_certified(T(pos), T(boxes), 0.0, 3.413)
    assert tak.last_tier == tier
    ref = tangles.neighbor_angles(T(pos[0]), T(pos[0]), T(boxes[0]), 0.0, 3.413, k=16)
    np.testing.assert_array_equal(cnt[0].numpy(), ref.count.numpy())
    got = _sorted_valid(ang[0].numpy(), tak.pair_validity(cnt)[0].numpy())
    want = _sorted_valid(ref.ang.numpy(), ref.valid.numpy())[:, -got.shape[1]:]
    np.testing.assert_allclose(got, want, atol=5e-3)  # polynomial vs library arccos


@pytest.mark.parametrize("n,tier", [(4096, "slab"), (512, "brute")])
def test_certified_psi6_tier_and_values(n, tier):
    pos, boxes = _lattice_traj(n, 1, seed=n + 4)
    psi, cnt = tpk.psi6_certified(T(pos), T(boxes), 0.0, 7.0)
    assert tpk.last_tier == tier
    want = tpsi6.order_param_psi(T(pos[0]), T(pos[0]), T(boxes[0]), 0.0, 7.0, k=24)
    np.testing.assert_allclose(psi[0].numpy(), want.numpy(), atol=5e-5)
    assert int(cnt.min()) > 24  # the shell overfills K: counts are full counts


@pytest.mark.parametrize("fn", [tak.angles_window, tpk.psi6_window])
def test_window_out_of_range_start_gives_nan(fn):
    ext = torch.rand(1, 3, 300)
    out, cnt = fn(ext, ext, torch.tensor([0, 50], dtype=torch.int32), torch.ones(1, 3),
                  260, 256, 0.0, 0.09)
    assert torch.isfinite(out[0, :256]).all() and torch.isnan(out[0, 256:]).all()
    assert (cnt[0, 256:] == 0).all()


@pytest.mark.parametrize("fn", [tak.angles_window, tpk.psi6_window])
def test_window_raises_on_other_devices(fn):
    ext = torch.rand(1, 3, 256, device="meta")
    with pytest.raises(RuntimeError):
        fn(ext, ext, torch.zeros(1, dtype=torch.int32, device="meta"),
           torch.ones(1, 3, device="meta"), 256, 256, 0.0, 1.0)
