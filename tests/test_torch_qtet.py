"""The port's q_tet (order/qtet, the slab prep, the q_window kernel contract
and the certified dispatch) against the JAX package.

The JAX Pallas kernel runs here in TPU interpret mode, as the JAX package's
own CPU tests run it; the port's kernel contract runs its plain PyTorch
version (on a CPU tensor `q_window` dispatches to it). q agrees to 1e-5
(float32 rounding of the same formula), the `ok` certificate exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops.pallas import qtet2 as jqtet2
from waterorderlib_tpu.ops.pallas import slab as jslab
from waterorderlib_tpu.order import qtet as jqtet
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.ops import pairs as tpairs
from waterorderlib_tpu_torch.ops.cuda import qtet2 as tqtet2
from waterorderlib_tpu_torch.ops.cuda import slab as tslab
from waterorderlib_tpu_torch.order import qtet as tqtet

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
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


def _sparse_traj():
    rs = np.random.RandomState(13)
    pos = rs.uniform(0, 200.0, (2, 512, 3)).astype(np.float32)
    return pos, np.full((2, 3), 200.0, np.float32)


@pytest.mark.parametrize("n", [216, 1024])
@pytest.mark.parametrize("fn", ["order_param_q", "order_param_q_fused"])
def test_order_q_matches_jax(n, fn):
    pos, boxes = _lattice_traj(n, 1, seed=n)
    p, b = pos[0], boxes[0]
    want = np.asarray(getattr(jqtet, fn)(p, p, b, 0.0, 10.0, row_block=128))
    got = getattr(tqtet, fn)(T(p), T(p), T(b), 0.0, 10.0, row_block=128).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_order_q_padding_rule_on_short_shells():
    """Centers with < 4 shell neighbors use the 180-degree padding, and an
    empty shell gives q = 0, as in the JAX package."""
    pos, boxes = _lattice_traj(216, 1, seed=4)
    p, b = pos[0], boxes[0]
    want = np.asarray(jqtet.order_param_q(p, p, b, 0.0, 3.0))
    got = tqtet.order_param_q(T(p), T(p), T(b), 0.0, 3.0).numpy()
    counts = tpairs.neighbor_counts(T(p), T(p), T(b), 0.0, 3.0).numpy()
    assert (counts < 4).any() and (counts == 0).any()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert np.all(got[counts == 0] == 0.0)


@pytest.fixture(scope="module")
def traj4096():
    return _lattice_traj(4096, 2, seed=0)


def _slab_params(n, box_z):
    return jqtet2.suggest_window(n, box_z), jslab.suggest_pad(n, box_z, 6.5)


def test_slab_prep_matches_jax(traj4096):
    """Same z-sort (stable), extended array and coverage as the JAX prep;
    the port's window starts are columns, not 128-aligned."""
    pos, boxes = traj4096
    window, pad = _slab_params(4096, float(boxes[0, 2]))
    want = jslab.slab_prep_traj(jnp.asarray(pos), jnp.asarray(boxes), 4.5, 256, window, pad)
    got = tslab.slab_prep_traj(T(pos), T(boxes), ((4.5, window),), 256, pad)
    np.testing.assert_array_equal(got.order0.numpy(), np.asarray(want.order0))
    np.testing.assert_array_equal(got.ext_t.numpy(), np.asarray(want.ext_t))
    np.testing.assert_array_equal(got.covered[0].numpy(), np.asarray(want.covered))
    assert got.n_tiles == want.n_tiles and got.ws[0] >= want.w
    assert np.all(got.starts[0].numpy() >= np.asarray(want.starts) * 128)


def test_kernel_contract_matches_pallas_kernel(traj4096):
    """The JAX prep, carried over by interop, through q_window_plain equals
    the Pallas kernel (interpret mode) on the same windows."""
    pos, boxes = traj4096
    window, pad = _slab_params(4096, float(boxes[0, 2]))
    pj, bj = jnp.asarray(pos), jnp.asarray(boxes)
    with pltpu.force_tpu_interpret_mode():
        q_want, ok_want, cov_want = jqtet2.order_param_q_traj(
            pj, bj, 0.0, 10.0, margin=4.5, row_tile=256, window=window, pad=pad, unsort=False
        )
    jp = jslab.slab_prep_traj(pj, bj, 4.5, 256, window, pad)
    prep = interop.slab_prep_from_jax(
        np.asarray(jp.ext_t), (np.asarray(jp.starts),), (np.asarray(jp.covered),),
        np.asarray(jp.order0), (jp.w,), jp.n_tiles, "cpu",
    )
    np.testing.assert_array_equal(prep.starts[0].numpy(), np.asarray(jp.starts) * 128)
    before = tqtet2.q_window_plain.calls
    q, ok = tqtet2.q_window(
        prep.ext_t[:, :, pad : pad + 4096], prep.ext_t, prep.starts[0], T(boxes), prep.ws[0], 256,
        0.0, 100.0, 4.5 * 4.5,
    )
    assert tqtet2.q_window_plain.calls == before + 1  # CPU tensor -> plain version
    assert bool(np.asarray(cov_want).all())
    np.testing.assert_allclose(q.numpy(), np.asarray(q_want), atol=TOL)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_want))


@pytest.mark.parametrize("case,tier", [("slab4096", "slab"), ("brute1024", "brute"),
                                       ("sparse512", "brute")])
def test_certified_matches_jax_certified(case, tier, traj4096):
    if case == "slab4096":
        (pos, boxes), high = traj4096, 10.0
    elif case == "brute1024":
        (pos, boxes), high = _lattice_traj(1024, 2, seed=11), 10.0
    else:
        (pos, boxes), high = _sparse_traj(), 50.0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqtet2.order_param_q_certified(jnp.asarray(pos), jnp.asarray(boxes), 0.0, high))
    got = tqtet2.order_param_q_certified(T(pos), T(boxes), 0.0, high).numpy()
    assert jqtet2.last_tier == tqtet2.last_tier == tier
    np.testing.assert_allclose(got, want, atol=TOL)


def _tied_cluster_traj():
    """A 4096-water box with a hole holding one center and 8 neighbors all at
    exactly 2.5 A (float32-exact offsets); 5 of them share the center's z.
    Which 4 enter q is decided only by the stable z-sort (column order
    among equal z) and the lowest-column tie-break."""
    pos, boxes = _lattice_traj(4096, 1, seed=21)
    c = np.array([24.5, 24.0, 24.25], np.float32)
    offsets = np.array([
        [2.5, 0, 0], [0, 2.5, 0], [-2.5, 0, 0], [1.5, 2, 0], [2, -1.5, 0],
        [1.5, 0, -2], [0, 1.5, 2], [0, 0, 2.5],
    ], np.float32)
    keep = np.linalg.norm(pos[0] - c, axis=1) > 4.5
    pos = np.concatenate([pos[0][keep], c[None], c + offsets])[None]
    return pos.astype(np.float32), boxes


def test_distance_ties_resolve_as_in_jax():
    pos, boxes = _tied_cluster_traj()
    center = pos.shape[1] - 9
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqtet2.order_param_q_certified(jnp.asarray(pos), jnp.asarray(boxes)))
    got = tqtet2.order_param_q_certified(T(pos), T(boxes)).numpy()
    assert jqtet2.last_tier == tqtet2.last_tier == "slab"
    np.testing.assert_allclose(got, want, atol=TOL)
    # the plain q paths choose the lowest index among ties, as lax.top_k
    p, b = pos[0], boxes[0]
    want_xla = np.asarray(jqtet.order_param_q(p[center : center + 1], p, b))
    for fn in (tqtet.order_param_q, tqtet.order_param_q_fused):
        np.testing.assert_allclose(fn(T(p[center : center + 1]), T(p), T(b)).numpy(),
                                   want_xla, atol=TOL)


def test_straggler_rows_are_patched_to_jax_value(traj4096):
    """A margin just under the 3 largest 4th-neighbor distances leaves 3
    rows uncertified; the brute form of the kernel contract recomputes them."""
    pos, boxes = traj4096
    d4 = np.concatenate([
        tpairs.topk_neighbors(T(pos[f]), T(pos[f]), T(boxes[f]), 4, 0.0, 10.0).dist[:, 3].numpy()
        for f in range(2)
    ])
    margin = float(np.sort(d4)[-4:-2].mean())
    q_slab, ok, cov = tqtet2.order_param_q_traj(
        T(pos), T(boxes), 0.0, 10.0, margin=margin, row_tile=256,
        window=jqtet2.suggest_window(4096, float(boxes[0, 2]), margin=margin),
        pad=jslab.suggest_pad(4096, float(boxes[0, 2]), margin + 2.0),
    )
    assert bool(cov.all()) and int((~ok).sum()) == 3
    before = tqtet2.q_window_plain.calls
    got = tqtet2.order_param_q_certified(T(pos), T(boxes), 0.0, 10.0, margin=margin).numpy()
    assert tqtet2.last_tier == "slab"
    assert tqtet2.q_window_plain.calls - before >= 2  # slab form + >= 1 patched frame
    want = np.stack([np.asarray(jqtet.order_param_q(pos[f], pos[f], boxes[f], 0.0, 10.0))
                     for f in range(2)])
    np.testing.assert_allclose(got, want, atol=TOL)
    bad = ~ok.numpy()
    np.testing.assert_allclose(got[bad], want[bad], atol=TOL)


@pytest.mark.parametrize("window,n,seg", [(1500, 4096, 512), (5000, 4096, 1536), (700, 1000, 128)])
def test_clamp_window_and_suggest_pad_match_jax(window, n, seg):
    assert tslab.clamp_window(window, n, seg) == jslab.clamp_window(window, n, seg)
    assert tslab.suggest_pad(n, 49.7, 6.5) == jslab.suggest_pad(n, 49.7, 6.5)


def test_q_window_out_of_range_start_gives_nan():
    """A window start past C - w marks its tile NaN / not ok, as the kernel
    does, instead of reading outside the columns."""
    ext = torch.rand(1, 3, 300)
    q, ok = tqtet2.q_window(ext, ext, torch.tensor([0, 50], dtype=torch.int32),
                            torch.ones(1, 3), 260, 256, 0.0, 1.0, 1.0)
    assert torch.isfinite(q[0, :256]).all() and torch.isnan(q[0, 256:]).all()
    assert not ok[0, 256:].any()


def test_q_window_rejects_bad_inputs():
    ext = torch.rand(1, 3, 300)
    starts = torch.zeros(2, dtype=torch.int32)
    boxes = torch.ones(1, 3)
    good = (ext, ext, starts, boxes, 300, 256, 0.0, 1.0, 1.0)
    tqtet2.q_window(*good)
    bad = [
        (ext.double(), ext.double(), starts, boxes.double(), 300, 256, 0.0, 1.0, 1.0),
        (ext, ext, starts.long(), boxes, 300, 256, 0.0, 1.0, 1.0),
        (ext, ext, starts, boxes, 301, 256, 0.0, 1.0, 1.0),
        (ext, ext, starts, boxes, 300, 200, 0.0, 1.0, 1.0),
        (ext, ext, starts[:1], boxes, 300, 256, 0.0, 1.0, 1.0),
        (ext.transpose(1, 2).contiguous().transpose(1, 2), ext, starts, boxes, 300, 256,
         0.0, 1.0, 1.0),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            tqtet2.q_window(*args)


def test_q_window_raises_on_other_devices():
    ext = torch.rand(1, 3, 256, device="meta")
    with pytest.raises(RuntimeError):
        tqtet2.q_window(ext, ext, torch.zeros(1, dtype=torch.int32, device="meta"),
                        torch.ones(1, 3, device="meta"), 256, 256, 0.0, 1.0, 1.0)
