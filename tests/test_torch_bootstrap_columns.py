"""The stats layer's many-series bootstrap (`stats/blocks.block_average_columns`):
one resample draw shared by every series of a call gives, bit for bit, the
intervals of one `block_average` per series, the port's and the JAX
package's; `seed=None` draws series by series from the global stream as
before; and each driver call bootstraps with one draw."""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.stats import blocks as jblocks
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import orderparams, voronoi_driver
from waterorderlib_tpu_torch.io.synthetic import make_water_box
from waterorderlib_tpu_torch.stats import blocks

torch.set_num_threads(1)


def _series(lengths, seed=7):
    """Columns of the given lengths: noisy ones, and for each length a
    constant one and one holding a NaN."""
    rs = np.random.RandomState(seed)
    out = []
    for n in lengths:
        out.append(rs.normal(0.3, 0.05, size=n).cumsum() / n)
        out.append(np.full(n, 0.625))
        nan = rs.normal(size=n)
        nan[n // 2] = np.nan
        out.append(nan)
        out.append(rs.standard_t(3, size=n).astype(np.float32))
    return out


def _per_series_loop(series, seed):
    """Today's per-column evaluation, verbatim: a draw per series."""
    out = []
    for v in series:
        v = np.asarray(v, dtype=np.float64)
        n_blocks = max(1, min(20, len(v)))
        len_block = len(v) / n_blocks
        means = np.array(
            [np.mean(v[int(i * len_block) : int((i + 1) * len_block)]) for i in range(n_blocks)]
        )
        rs = np.random.RandomState(seed) if seed is not None else np.random
        picks = rs.randint(0, n_blocks, size=(10000, n_blocks))
        out.append(jblocks.get_ci(np.sort(np.mean(means[picks], axis=1))))
    return out


@pytest.mark.parametrize("lengths", [[1024], [256], [32], [7], [1024, 7, 32, 7]],
                         ids=["F1024", "F256", "F32", "F7", "mixed"])
@pytest.mark.parametrize("seed", [0, 2147702171])
def test_shared_draw_equals_a_draw_per_series(lengths, seed):
    series = _series(lengths)
    got = blocks.block_average_columns(series, seed=seed)
    assert len(got) == len(series)
    want = _per_series_loop(series, seed)
    jax = [jblocks.block_average(v, seed=seed) for v in series]
    port = [blocks.block_average(v, seed=seed) for v in series]
    for other in (want, jax, port):
        assert np.array_equal(got, other, equal_nan=True)
    assert np.isnan(got[2]) and got[1] == 0.0  # the NaN column, the constant one
    pairs = blocks.mean_and_ci_columns(series, seed=seed)
    one = [blocks.mean_and_ci(v, seed=seed) for v in series]
    assert np.array_equal(np.array(pairs), np.array(one), equal_nan=True)
    assert np.array_equal([p[1] for p in pairs], got, equal_nan=True)


def test_draws_counted_once_a_length():
    before = clock.totals()
    blocks.block_average_columns(_series([64, 9, 64]), seed=3)
    after = clock.totals()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert delta("bootstrap:draws") == 2 and delta("bootstrap:columns") == 12


@pytest.mark.parametrize("k", [0, 11])
def test_seed_none_draws_from_the_global_stream_as_before(k):
    series = _series([256, 7])
    np.random.seed(k)
    want = _per_series_loop(series, None)
    want_state = np.random.get_state()
    np.random.seed(k)
    got = blocks.block_average_columns(series, seed=None)
    got_state = np.random.get_state()
    assert np.array_equal(got, want, equal_nan=True)
    assert got_state[0] == want_state[0] and np.array_equal(got_state[1], want_state[1])
    assert got_state[2:] == want_state[2:]
    assert len(set(np.asarray(got)[~np.isnan(got)])) > 2  # independent draws


@pytest.fixture(scope="module")
def system():
    top, traj = make_water_box(216, n_frames=5, seed=9)
    wat = top.get_wat_inds()[0]
    return top, traj, [[wat[t::2]] for t in range(5)]


def _run(fn, system, out, **kw):
    top, traj, pops = system
    return fn(top, traj, output_dir=out, device="cpu", **kw)


# driver, its keyword arguments, the number of statistics it returns
DRIVERS = {
    "tet": (orderparams.tet_order_calc, "pops", 2),
    "three_body": (orderparams.three_body_calc, "pops", 5),
    "lsi": (orderparams.lsi_calc, "pops", 2),
    "hex": (orderparams.hex_order_calc, None, 2),
    "voronoi": (voronoi_driver.voronoi_calc, None, 6),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_a_driver_call_draws_once(name, system, tmp_path, monkeypatch):
    fn, pops, n_stats = DRIVERS[name]
    kw = {"sub_inds": system[2], "n_pops": 1} if pops else {}
    if name == "voronoi":
        kw["engine"] = "device"
    seen = []
    shared = blocks.block_average_columns

    def spy(series, *a, **k):
        seen.append(list(series))
        return shared(seen[-1], *a, **k)

    monkeypatch.setattr(blocks, "block_average_columns", spy)
    clock.recorded_calls()
    with clock.stage_times():
        res = _run(fn, system, str(tmp_path), **kw)
    calls = clock.recorded_calls()
    assert len(calls) == 1 and len(seen) == 1
    cols = 2 if pops else 1  # every water, then the population
    counts = calls[0].counts
    assert counts["bootstrap:draws"] == 1
    assert counts["bootstrap:columns"] == n_stats * cols == len(seen[0])
    assert len(res) == n_stats
    # each returned [means, CIs] equals a per-column block_average loop
    it = iter(seen[0])
    for means, cis in res:
        assert len(means) == len(cis) == cols
        per_frame = [next(it) for _ in range(cols)]
        want = [jblocks.block_average(v, seed=0) for v in per_frame]
        assert np.array_equal(cis, want, equal_nan=True)
        assert np.array_equal(means, [np.nanmean(v) for v in per_frame], equal_nan=True)
