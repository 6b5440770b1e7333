"""The exactness arguments of csrc/lsi_window.cu's split-shell kernel, on the
CPU, as torch and numpy emulations of what the kernel does.

1. One scan of the union of the narrow and the wide window, each distinct
   column once (up to two column ranges): a column's imaged dsq (magnitude
   minimum image, fmaf chain) serves the in-shell test where the column
   lies in the narrow window and the annulus test where it lies in the wide
   one, and the raw distance is taken on annulus hits only. Windows that
   stick out of each other, lie apart or touch give `lsi_split_window_plain`'s
   two passes bit for bit.
2. The 12 smallest in-shell distances carry no payload: whatever order
   the lanes meet them in, a buffer of keys merged 32 at a time keeps the
   same multiset, and the count (an integer sum) flags rows with more
   than 12 as incomplete.
3. The next-shell pick is the minimum of (raw dsq bits << 32) | column
   keys: the first column among equal raw distances in any visiting order;
   its imaged dsq, recomputed from its column, is the plain version's.
4. The warp epilogue (slot j in lane j: 12 in-shell lanes, the next-shell
   pick in lane 12) gives `lsi._epilogue`'s values bit for bit.
The CUDA kernel itself is held against the plain version on the card
(chip_smoke.py); the plain version is held here against the JAX package's
split-shell Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.ops.pallas import lsi_slab2 as jls
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu_torch.ops.cuda import lsi, slab, window

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

HIGH, OUTER = 3.7, 7.4
SCALARS = (0.0, HIGH, HIGH * HIGH, OUTER * OUTER)
SENT = torch.iinfo(torch.int64).max
N_BRUTE = 600


def _bits(x):
    return x.contiguous().view(torch.int32)


def _mag(d, box_l):
    a = d.abs()
    return torch.minimum(a, box_l - a)


def _shifted(n, f, seed, cluster=False):
    """Jittered-lattice frames at water density, a third of the atoms stored
    shifted by +/-L; with `cluster`, 16 atoms packed around atom 0 (rows
    with more than 12 in-shell neighbors)."""
    L = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, L, seed=seed)
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), L) for _ in range(f)])
    if cluster:
        pos[:, -16:] = np.clip(pos[:, :1] + rs.normal(scale=1.2, size=(f, 16, 3)), 0.0, L - 1e-3)
    some = rs.uniform(size=pos.shape[:2]) < 1.0 / 3.0
    pos = pos + rs.randint(-1, 2, size=pos.shape) * some[..., None] * L
    return pos.astype(np.float32), np.tile(np.float32([L] * 3), (f, 1))


def _lattice():
    """8^3 sites of spacing 3 A in a 24 A box: exact float32 distances, so
    raw distances tie in the annulus; every third site stored shifted by +L
    in x."""
    g = np.stack(np.meshgrid(*(np.arange(8),) * 3, indexing="ij"), -1).reshape(-1, 3) * 3.0
    g[::3, 0] += 24.0
    return g[None].astype(np.float32), np.float32([[24.0] * 3])


def _brute(pos, boxes):
    pos, boxes = torch.from_numpy(pos), torch.from_numpy(boxes)
    n = pos.shape[1]
    ext, raw = slab.brute_cols(pos, boxes), slab.brute_raw(pos)
    starts = torch.zeros(-(-n // 128), dtype=torch.int32)
    return [ext, ext, starts, boxes, n, 128, raw, raw, starts, n, *SCALARS]


def _windows(args, w_n, s_n, w_w, s_w):
    """args with one narrow and one wide window start per tile, given as
    per-tile lists (or one value for all tiles)."""
    n_t = args[2].numel()
    out = list(args)
    out[2] = torch.tensor(np.broadcast_to(s_n, (n_t,)), dtype=torch.int32)
    out[8] = torch.tensor(np.broadcast_to(s_w, (n_t,)), dtype=torch.int32)
    out[4], out[9] = w_n, w_w
    return tuple(out)


def _args(kind):
    if kind == "slab":  # the windows lsi_certified plans
        pos, boxes = (torch.from_numpy(a) for a in _shifted(2600, 1, 6))
        n = pos.shape[1]
        w_wide, pad = slab.plan(n, float(boxes[0, 2]), OUTER, 128)
        w_narrow = slab.suggest_window(n, float(boxes[0, 2]), margin=HIGH, row_tile=128)
        prep = slab.slab_prep_traj(pos, boxes, ((HIGH, w_narrow), (OUTER, w_wide)), 128, pad)
        assert all(bool(c.all()) for c in prep.covered)
        raw = slab.raw_ext_t(pos, prep.order0, pad)
        return (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes, prep.ws[0],
                128, raw[:, :, pad : pad + n], raw, prep.starts[1], prep.ws[1], *SCALARS)
    if kind == "lattice":
        return tuple(_brute(*_lattice()))
    if kind == "cluster":
        return tuple(_brute(*_shifted(N_BRUTE, 1, 7, cluster=True)))
    b = _brute(*_shifted(N_BRUTE, 2, 5))
    if kind == "brute":
        return tuple(b)
    if kind == "sticks_out":  # narrow partly left of, partly right of, inside the wide one
        return _windows(b, 240, [0, 300, 120, 360, 200], 300, [100, 180, 120, 290, 20])
    if kind == "apart":  # the two windows lie apart, or touch
        return _windows(b, 100, [0, 500, 0, 400, 250], 260, [300, 0, 100, 140, 0])
    if kind == "narrow20":  # windows of 20 columns, narrower than a warp
        return _windows(b, 20, [7, 97, 300, 480, 555], 20, [0, 110, 290, 500, 570])
    raise ValueError(kind)


KINDS = ["brute", "slab", "lattice", "cluster", "sticks_out", "apart", "narrow20"]


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    args = _args(request.param)
    return request.param, args, lsi.lsi_split_window_plain(*args)


def _ranges(s_n, w_n, s_w, w_w):
    """The kernel's column ranges: the union of the two windows, one range
    where they overlap or touch, else two."""
    e_n, e_w = s_n + w_n, s_w + w_w
    if max(s_n, s_w) <= min(e_n, e_w):
        return [(min(s_n, s_w), max(e_n, e_w))]
    return sorted([(s_n, e_n), (s_w, e_w)])


def _warp_buffer(values, k, rs):
    """The in-shell selection as the kernel runs it, in a random visiting
    order: keys of dsq bits alone offered 32 lanes at a time, those below the
    12th key so far buffered, every 32 buffered merged into a sorted list of
    32, a flush at the end. Returns the k smallest kept, ascending."""
    keys = [int(v) << 32 for v in values[rs.permutation(len(values))]]
    L, buf, thr = [], [], SENT
    for j0 in range(0, len(keys), 32):
        buf += [x for x in keys[j0 : j0 + 32] if x < thr]
        if len(buf) >= 32:
            L, buf = sorted(L + buf[:32])[:32], buf[32:]
            thr = L[k - 1] if len(L) >= k else SENT
    L = sorted(L + buf)[:32]
    return [x >> 32 for x in L[:k]]


def _kernel(args, seed=0):
    """lsi_split_window's outputs as the kernel computes them (slots in
    the sequential epilogue, and the warp epilogue's outputs)."""
    (rows, cols, starts, boxes, w, rt, raw_rows, raw_cols, starts_w, w_wide, low_sq, high,
     high_sq, outer_sq) = args
    rs = np.random.RandomState(seed)
    low, hi2, out2 = (torch.tensor(v, dtype=torch.float32) for v in (low_sq, high_sq, outer_sq))
    F, _, n_rows = rows.shape
    n_cols = cols.shape[2]
    outs, outs_warp = lsi._outs(rows, 4), lsi._outs(rows, 4)
    for t, (s_n, s_w) in enumerate(zip(starts.tolist(), starts_w.tolist())):
        r0, r1 = t * rt, min(n_rows, (t + 1) * rt)
        if not (0 <= s_n <= n_cols - w and 0 <= s_w <= n_cols - w_wide):
            for o in (outs, outs_warp):
                o[0][:, r0:r1], o[1][:, r0:r1], o[2][:, r0:r1], o[3][:, r0:r1] = (
                    float("nan"), False, 0, True)
            continue
        col = torch.cat([torch.arange(a, b) for a, b in _ranges(s_n, w, s_w, w_wide)])
        assert len(set(col.tolist())) == col.numel()  # each distinct column once
        d = cols[:, :, None, col] - rows[:, :, r0:r1, None]
        m = _mag(d, boxes[:, :, None, None])
        dsq = window.dot3(m[:, 0], m[:, 0], m[:, 1], m[:, 1], m[:, 2], m[:, 2], fused=True)
        in_n = (col >= s_n) & (col < s_n + w)
        in_w = (col >= s_w) & (col < s_w + w_wide)
        shell = in_n & (dsq > low) & (dsq <= hi2)
        ann = in_w & (dsq > hi2) & (dsq <= out2)
        count = shell.sum(dim=-1)
        # the in-shell multiset, in a random order for every row
        cd = torch.full((F, r1 - r0, lsi.K_IN), torch.inf)
        for f in range(F):
            for i in range(r1 - r0):
                vals = _bits(dsq[f, i][shell[f, i]]).numpy().astype(np.int64)
                kept = _warp_buffer(vals, lsi.K_IN, rs)
                cd[f, i, : len(kept)] = torch.tensor(kept, dtype=torch.int32).view(torch.float32)
        # the next-shell pick: the least (raw bits, column) key
        e = raw_cols[:, :, None, col] - raw_rows[:, :, r0:r1, None]
        rsq = window.dot3(e[:, 0], e[:, 0], e[:, 1], e[:, 1], e[:, 2], e[:, 2], fused=True)
        key = torch.where(ann & (rsq < torch.inf), (_bits(rsq).long() << 32) | col, SENT)
        best = key.min(dim=-1).values
        has = best != SENT
        j = torch.where(has, best & 0xFFFFFFFF, 0)
        dj = cols[:, :, None, :].expand(-1, -1, r1 - r0, -1).gather(
            3, j[:, None, :, None].expand(-1, 3, -1, -1))[..., 0] - rows[:, :, r0:r1]
        mj = _mag(dj, boxes[:, :, None])
        img = window.dot3(mj[:, 0], mj[:, 0], mj[:, 1], mj[:, 1], mj[:, 2], mj[:, 2], fused=True)
        best_raw = torch.where(has, (best >> 32).to(torch.int32).view(torch.float32), torch.inf)
        dist = torch.cat([sqrt_f32(cd), torch.where(has, sqrt_f32(img), torch.inf)[..., None]], -1)
        rawsq = torch.cat([torch.full_like(cd, torch.inf), best_raw[..., None]], -1)
        fin = torch.cat([torch.isfinite(cd), has[..., None]], -1)
        lsi._store(outs, r0, r1, *lsi._epilogue(dist, rawsq, fin, high))
        lsi._store(outs_warp, r0, r1, *_warp_epilogue(dist, rawsq, fin, high))
        outs[3][:, r0:r1] = outs_warp[3][:, r0:r1] = count > lsi.K_IN
    return outs, outs_warp


def _warp_epilogue(dist, rawsq, fin, high):
    """csrc/lsi_window.cu `lsi_epilogue_warp` over 32 lanes (slot j in lane
    j, the lanes past the given slots empty), in torch: the shuffles as
    indexing, the ballots as reductions."""
    n = dist.shape[-1]
    pad = lambda x, v: torch.cat([x, torch.full_like(x[..., :1], v).expand(  # noqa: E731
        *x.shape[:-1], 32 - n)], dim=-1)
    dist, rawsq, fin = pad(dist, torch.inf), pad(rawsq, torch.inf), pad(fin, False)
    slot = torch.arange(32)
    n_near = (fin & (dist <= high)).sum(dim=-1)
    isnext = fin & (dist > high)
    has_next = isnext.any(dim=-1)
    b = torch.where(isnext & (rawsq < torch.inf), (_bits(rawsq).long() << 32) | slot, SENT)
    b = b.min(dim=-1).values
    at_best = dist.gather(-1, (b & 31)[..., None])[..., 0]
    next_dist = torch.where(b != SENT, at_best, 0.0)
    last = torch.where(n_near > 1, n_near - 1, 0)
    final_gap = next_dist - dist.gather(-1, last[..., None])[..., 0]
    denom = torch.where(n_near > 1, n_near, 1).to(torch.float32)
    dnext = torch.cat([dist[..., 1:], dist[..., 31:]], dim=-1)  # __shfl_down: lane 31 keeps its own
    gap, inner = dnext - dist, dnext < torch.inf
    s = final_gap
    for j in range(31):
        s = torch.where((j < n_near - 1) & inner[..., j], s + gap[..., j], s)
    mean = s / denom
    t = final_gap - mean
    var = t * t
    for j in range(31):
        g = gap[..., j] - mean
        var = torch.where((j < n_near - 1) & inner[..., j], var + g * g, var)
    return var / denom, (n_near > 1) & has_next, n_near.to(torch.float32)


def _equal(got, want):
    assert torch.equal(_bits(torch.nan_to_num(got[0], 7.0)), _bits(torch.nan_to_num(want[0], 7.0)))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_union_scan_gives_the_plain_outputs(case):
    kind, args, want = case
    got, got_warp = _kernel(args)
    _equal(got, want)
    _equal(got_warp, want)
    if kind in ("brute", "slab", "lattice"):
        assert float(want[1].float().mean()) > 0.9  # the epilogue sees real shells
    if kind == "sticks_out":  # a narrow window reaches past each end of a wide one
        s_n, s_w = args[2].long(), args[8].long()
        assert bool((s_n < s_w).any() and (s_n + args[4] > s_w + args[9]).any())
    if kind == "apart":  # windows apart and touching both occur
        s_n, s_w = args[2].long(), args[8].long()
        gap = torch.maximum(s_n, s_w) - torch.minimum(s_n + args[4], s_w + args[9])
        assert bool((gap > 0).any() and (gap == 0).any())


def test_in_shell_selection_is_order_free_and_count_flags_overflow(case):
    kind, args, want = case
    first, _ = _kernel(args, seed=1)
    again, _ = _kernel(args, seed=2)
    _equal(first, again)
    if kind == "cluster":
        assert bool(want[3].any()) and bool(first[3].any())  # more than 12 in a shell


def test_next_shell_pick_among_equal_raw_distances():
    """On the 3 A lattice many rows have several annulus candidates at the
    least raw distance; the least key takes the first column of them, as
    the plain version's lowest-column rule does, whatever the order."""
    args = _args("lattice")
    rows, cols, _, boxes, w, _, raw_rows, raw_cols = args[:8]
    d = cols[:, :, None, :] - rows[:, :, :, None]
    m = _mag(d, boxes[:, :, None, None])
    dsq = window.dot3(m[:, 0], m[:, 0], m[:, 1], m[:, 1], m[:, 2], m[:, 2], fused=True)
    e = raw_cols[:, :, None, :] - raw_rows[:, :, :, None]
    rsq = window.dot3(e[:, 0], e[:, 0], e[:, 1], e[:, 1], e[:, 2], e[:, 2], fused=True)
    ann = (dsq > HIGH * HIGH) & (dsq <= OUTER * OUTER)
    rawm = torch.where(ann, rsq, torch.inf)
    least = rawm.min(dim=-1, keepdim=True).values
    ties = ((rawm == least) & torch.isfinite(rawm)).sum(dim=-1)
    assert int((ties > 1).sum()) > 100
    assert bool(torch.isfinite(least).all())  # every row has an annulus candidate
    col = torch.arange(w)
    key = torch.where(ann, (_bits(rsq).long() << 32) | col, SENT)
    rs = np.random.RandomState(3)
    perm = torch.from_numpy(rs.permutation(w))
    pick = key[..., perm].min(dim=-1).values & 0xFFFFFFFF
    first = torch.where((rawm == least) & torch.isfinite(rawm), col, w).min(dim=-1).values
    assert torch.equal(pick, first)


def test_plain_split_matches_the_pallas_kernel():
    """The plain version on the JAX package's own split prep (windows 768 and
    1024) equals the Pallas split-shell kernel in interpret mode: the
    emulation above is held to the JAX package through it."""
    from waterorderlib_tpu.ops.pallas import slab as jslab
    from waterorderlib_tpu_torch import interop

    pos, boxes = _shifted(1024, 1, 9)
    pad = 512
    with pltpu.force_tpu_interpret_mode():
        v, ok, cnt, cov = jls.lsi_traj_split(jnp.asarray(pos), jnp.asarray(boxes), 0.0, HIGH,
                                             window_narrow=768, window_wide=1024, pad=pad,
                                             seg=256, unsort=False)
    assert bool(np.asarray(cov).all())
    jm = jslab.slab_prep_traj_multi(jnp.asarray(pos), jnp.asarray(boxes),
                                    ((HIGH, 768), (OUTER, 1024)), 128, pad)
    prep = interop.slab_prep_from_jax(
        np.asarray(jm.ext_t), [np.asarray(s) for s in jm.starts],
        [np.asarray(c) for c in jm.covered], np.asarray(jm.order0), jm.ws, jm.n_tiles, "cpu")
    raw = slab.raw_ext_t(torch.from_numpy(pos), prep.order0, pad)
    n = pos.shape[1]
    args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], torch.from_numpy(boxes),
            prep.ws[0], 128, raw[:, :, pad : pad + n], raw, prep.starts[1], prep.ws[1], *SCALARS)
    want = lsi.lsi_split_window_plain(*args)
    got, _ = _kernel(args)
    _equal(got, want)
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(want[2].numpy(), np.asarray(cnt).astype(np.int32))
    np.testing.assert_allclose(want[0].numpy(), np.asarray(v), atol=2e-5)
