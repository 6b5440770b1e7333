"""The exactness arguments of csrc/voronoi_topk.cu's z-window kernel, on the
CPU, as a numpy emulation of what the kernel does.

1. Along each side of a row's place in a z-sorted candidate array (the
   first candidate whose z is >= the row's), |fl(cz - z)| and fl(dz*dz) do
   not decrease, and fl(dz*dz) <= dsq = ((dx*dx) + (dy*dy)) + (dz*dz), in
   float32: on mirrored water boxes, on a lattice whose distances and z tie
   exactly, and with +inf parked slots.
2. The kernel's scan (each row from its place outward on both sides, 32
   candidates a step; a side stops at the first chunk whose nearest
   candidate has fl(dz*dz) strictly above the bound) feeding WarpSelect
   (csrc/warp_select.cuh, its bitonic network emulated lane by lane), with
   `split` warps a row that share a bound through their published entries
   and merge their lists at the end, returns exactly
   `voronoi_window_topk_plain`'s (dist, pos): at k 64 to 256, on full
   scans and on windows clamped at both ends of the array, for rows at both
   ends, a planted tie at the k-th distance on both sides of a row (where a
   stop at fl(dz*dz) >= the bound loses a slot), and rows with fewer than k
   finite candidates; the warps of a row in any order.
3. On one fixture the emulation, through the port's `_windowed_topk`, also
   agrees with the JAX package's `_windowed_topk` and
   `ops.pairs.topk_neighbors`, as the plain version does.
The CUDA kernel itself is held against the plain version on the card
(chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops import pairs as jpairs
from waterorderlib_tpu.surface import voronoi_device as jvd
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk
from waterorderlib_tpu_torch.surface import voronoi_device as tvd

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

SENT = np.uint64(2**64 - 1)
LANE = np.arange(32)
HI, LO = np.uint64(32), np.uint64(0xFFFFFFFF)
DIST_TOL = 2e-6  # A: one ulp of d^2, as tests/test_torch_voronoi_topk.py


# --- fixtures: (centers (F, R, 3), exts (F, P, 3), starts, row_block, win) ---


def _water(n, seed):
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(seed)
    return ((base + rs.normal(scale=0.6, size=base.shape)) % box_l).astype(np.float32), box_l


def _lattice():
    """8^3 sites of spacing 3 A in a 24 A box: coordinates, differences and
    squares are exact in float32, so distances and z tie exactly."""
    g = np.stack(np.meshgrid(*(np.arange(8),) * 3, indexing="ij"), -1).reshape(-1, 3) * 3.0
    return (g + 1.5).astype(np.float32), 24.0


def _window_args(pts, box_l, rows, row_block, win=None):
    """The kernel's arguments as `_windowed_topk` makes them: the rows
    `rows` of the points against their mirror set (win None: the full
    scan)."""
    p = torch.from_numpy(pts)[None]
    ext = tvd.mirror_points_device(p, torch.tensor([box_l], dtype=torch.float32))
    win = ext.shape[1] if win is None else win
    _, exts, _, cs, start = tvd._window_prep(p[:, rows], ext, row_block, win)
    return cs, exts, start.to(torch.int32), row_block, win


def _parked():
    """60 finite candidates (one coincident with a row: dropped) and 40
    parked +inf slots, which z-sort last: fewer than k finite candidates."""
    rs = np.random.RandomState(9)
    pts = rs.uniform(0.0, 12.0, (60, 3)).astype(np.float32)
    ext = np.concatenate([pts, np.full((40, 3), np.inf, np.float32)])
    ext = ext[np.argsort(ext[:, 2], kind="stable")]
    cs = np.concatenate([pts[:3], [[6.0, 6.0, -1.0], [6.0, 6.0, 13.0]]]).astype(np.float32)
    cs = np.concatenate([cs[np.argsort(cs[:, 2], kind="stable")], np.tile(cs[-1:], (3, 1))])
    return (torch.from_numpy(cs)[None], torch.from_numpy(ext)[None],
            torch.zeros((1, 1), dtype=torch.int32), 8, 100)


def _tie(k, n_inner):
    """One row at O = (50, 50, 50) and a tie at the k-th distance, 6 A, on
    both sides of it: n_inner candidates within 5.9 A and 2 A in z; six at
    exactly 6 A
    along the axes (dsq 36 exactly), so P- = O - 6 z and P+ = O + 6 z have
    fl(dz*dz) equal to the k-th dsq; 40 candidates far in x at each of z =
    44 and z = 56, after P- and before P+ in the stable z order, so a chunk's
    nearest candidate has z 44 (56) and fl(dz*dz) 36 where P- (P+) lies at or
    beyond it; fillers far in x with z over [14, 86], and 400 between 6.05
    and 6.7 A of the row with 2 < |dz| < 5.5: they pass the bound until the
    list holds the tie, so their merges bring the bound down to the k-th
    dsq before the left side reaches z = 44. The row itself is a candidate
    (dsq 0: dropped). With n_inner = k - 2 the slots k - 1 and k
    go to the tied candidates of the lowest positions, P- and one at z = 50;
    with k - 6 all six are kept."""
    rs = np.random.RandomState(k + n_inner)
    o = np.float32([50.0, 50.0, 50.0])
    inner = []
    while len(inner) < n_inner:
        v = np.round(rs.uniform(-5.9, 5.9, 3) * 16.0) / 16.0
        if 0.0 < np.dot(v, v) < 5.9**2 and abs(v[2]) < 2.0:
            inner.append(v)
    axes = np.array([[0, 0, -6], [6, 0, 0], [-6, 0, 0], [0, 6, 0], [0, -6, 0], [0, 0, 6]])
    block = [[20.0 + 0.5 * i, 0.0, dz] for dz in (-6.0, 6.0) for i in range(40)]
    fill = np.stack([rs.uniform(15.0, 30.0, 300) * rs.choice([-1, 1], 300),
                     rs.uniform(-30.0, 30.0, 300), rs.uniform(-36.0, 36.0, 300)], -1)
    shell = []
    while len(shell) < 400:
        v = rs.normal(size=3)
        v *= rs.uniform(6.05, 6.7) / np.linalg.norm(v)
        if 2.0 < abs(v[2]) < 5.5:
            shell.append(v)
    # P- before the z = 44 block and P+ after the z = 56 block in the stable order
    cand = np.concatenate([[[0.0, 0.0, 0.0]], axes[:1], inner, axes[1:5], block, axes[5:], fill,
                           shell])
    ext = (cand + o).astype(np.float32)
    ext = ext[np.argsort(ext[:, 2], kind="stable")]
    return (torch.from_numpy(o)[None, None], torch.from_numpy(ext)[None],
            torch.zeros((1, 1), dtype=torch.int32), 1, ext.shape[0])


def _case(name, k):
    if name == "full":  # the last tier: 64 rows of a water box, the full scan
        pts, box_l = _water(500, 2)
        rows = np.sort(np.random.RandomState(5).choice(500, 64, replace=False))
        return _window_args(pts, box_l, torch.from_numpy(rows), 64)
    if name == "clamped":  # windows clamped at 0 and at P - win
        pts, box_l = _water(500, 3)
        args = _window_args(pts, box_l, torch.arange(500), 64, 1280)
        st = args[2][0]
        assert int(st[0]) == 0 and int(st[-1]) == args[1].shape[1] - 1280
        return args
    if name == "ends":  # rows at both ends of the array, and beyond them
        pts, box_l = _water(400, 4)
        cs, exts, st, _, win = _window_args(pts, box_l, torch.arange(8), 8)
        e = exts[0]
        lo, hi = e[0].clone(), e[-1].clone()
        far = torch.stack([lo - torch.tensor([0.0, 0.0, 3.0]), lo, e[1], e[2], e[-3], e[-2], hi,
                           hi + torch.tensor([0.0, 0.0, 3.0])])
        return far[None].contiguous(), exts, st, 8, win
    if name == "lattice":
        pts, box_l = _lattice()
        rows = np.sort(np.random.RandomState(6).choice(512, 32, replace=False))
        return _window_args(pts, box_l, torch.from_numpy(rows), 32)
    if name == "parked":
        return _parked()
    if name == "tie_split":
        return _tie(k, k - 2)
    assert name == "tie_all"
    return _tie(k, k - 6)


# --- the emulation -----------------------------------------------------------


def _bitonic_sort(v):
    size = 2
    while size <= 32:
        d = size >> 1
        while d > 0:
            o = v[LANE ^ d]
            up = ((LANE & d) == 0) == ((LANE & size) == 0)
            v = np.where(up, np.minimum(v, o), np.maximum(v, o))
            d >>= 1
        size <<= 1
    return v


class _WarpSelect:
    """WarpSelect<R> of one warp: L[r, lane] is entry 32 r + lane of its
    sorted list; a lane's key below thr waits in the buffer (in lane order)
    and every 32 waiting keys are merged: sorted across the lanes, the
    reversed keys against L's last register, then a bitonic merge over the
    registers and the lanes."""

    def __init__(self, R, k):
        self.L = np.full((R, 32), SENT, np.uint64)
        self.thr, self.buf, self.k = SENT, [], k

    def _merge(self, v):
        R = self.L.shape[0]
        L = self.L.copy()
        L[R - 1] = np.minimum(L[R - 1], _bitonic_sort(v)[31 - LANE])
        dr = R // 2
        while dr > 0:
            for r in range(R):
                if r & dr == 0:
                    a, b = L[r].copy(), L[r + dr].copy()
                    L[r], L[r + dr] = np.minimum(a, b), np.maximum(a, b)
            dr >>= 1
        d = 16
        while d > 0:
            o = L[:, LANE ^ d]
            L = np.where((LANE & d) != 0, np.maximum(L, o), np.minimum(L, o))
            d >>= 1
        self.L, self.thr = L, L.reshape(-1)[self.k - 1]

    def offer(self, real, key):
        """The 32 lanes' keys; True if a merge followed."""
        self.buf += list(key[real & (key < self.thr)])
        if len(self.buf) < 32:
            return False
        v, self.buf = np.array(self.buf[:32], np.uint64), self.buf[32:]
        self._merge(v)
        return True

    def flush(self):
        if self.buf:
            self._merge(np.array(self.buf + [SENT] * (32 - len(self.buf)), np.uint64))
            self.buf = []


def _registers(k):
    return next(r for r in (1, 2, 4, 8) if 32 * r >= k)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _row_scan(c, ext, s, win, k, split, rng=None, strict=True):
    """One row of window_topk_kernel<R, split>: the row's list of k keys
    (dsq bits << 32 | position) and the lanes it offered. rng: the warps'
    order in each round (None: in turn); strict False stops a side at
    fl(dz*dz) >= the bound (the wrong rule)."""
    cx, cy, cz = (np.float32(v) for v in c)
    x, y, z = ext[:, 0], ext[:, 1], ext[:, 2]
    e = s + win
    place = s + int(np.searchsorted(z[s:e], cz, side="left"))
    at = -(-k // split) - 1
    warps = [{"ws": _WarpSelect(_registers(k), k), "jr": place + 32 * w,
              "jl": place - 1 - 32 * w, "pub": SENT} for w in range(split)]
    tested = 0

    def chunk(ws, j, inside, bound):
        jj = np.where(inside, j, s)
        dz = cz - z[jj]
        dz2 = dz * dz
        b0, far = _bits(dz2[0]), np.uint32(bound >> HI)
        if (b0 > far) if strict else (b0 >= far):
            return None
        dx, dy = cx - x[jj], cy - y[jj]
        d = (dx * dx + dy * dy) + dz2
        key = (_bits(d).astype(np.uint64) << HI) | j.astype(np.uint64)
        return ws.offer(inside & (d > 0) & (d < np.inf) & (key < bound), key)

    live = list(range(split))
    while live:
        for w in (rng.permutation(live) if rng is not None else live):
            st = warps[w]
            ws, bound = st["ws"], st["ws"].thr
            if split > 1:
                bound = min(bound, max(v["pub"] for v in warps))
            merged = False
            if st["jr"] < e:
                got = chunk(ws, st["jr"] + LANE, st["jr"] + LANE < e, bound)
                if got is None:
                    st["jr"] = e
                else:
                    merged |= got
                    tested += min(32, e - st["jr"])
                    st["jr"] += 32 * split
            if st["jl"] >= s:
                got = chunk(ws, st["jl"] - LANE, st["jl"] - LANE >= s, bound)
                if got is None:
                    st["jl"] = s - 1
                else:
                    merged |= got
                    tested += min(32, st["jl"] - s + 1)
                    st["jl"] -= 32 * split
            if split > 1 and merged:
                st["pub"] = ws.L.reshape(-1)[at]
        live = [w for w in live if warps[w]["jr"] < e or warps[w]["jl"] >= s]
    for st in warps:
        st["ws"].flush()
    first = warps[0]["ws"]
    for st in warps[1:]:
        for r in range(first.L.shape[0]):
            first.offer(st["ws"].L[r] != SENT, st["ws"].L[r])
    first.flush()
    return first.L.reshape(-1)[:k], tested


def _emulate(args, k, split, rows=None, rng=None, strict=True):
    """(dist, pos) of the kernel's launch on `rows` (frame, row) pairs
    (None: all), and the lanes offered."""
    cs, exts, starts, row_block, win = args
    F, R, _ = cs.shape
    rows = [(f, r) for f in range(F) for r in range(R)] if rows is None else rows
    dist = torch.full((len(rows), k), torch.inf)
    pos = torch.full((len(rows), k), -1, dtype=torch.int32)
    tested = 0
    for i, (f, r) in enumerate(rows):
        keys, t = _row_scan(cs[f, r].numpy(), exts[f].numpy(), int(starts[f, r // row_block]),
                            win, k, split, rng, strict)
        tested += t
        ok = keys != SENT
        dsq = torch.from_numpy((keys[ok] >> HI).astype(np.uint32).view(np.float32))
        dist[i, : len(dsq)] = sqrt_f32(dsq)
        pos[i, : len(dsq)] = torch.from_numpy((keys[ok] & LO).astype(np.int32))
    return dist, pos, tested


def _z_sides(c, z):
    """Per row, fl(cz - z) and fl(dz*dz) over the z-sorted candidates, and
    each row's place (the first z >= cz)."""
    cz = c[:, 2, None]
    dz = cz - z[None]
    return dz, dz * dz, torch.searchsorted(z.contiguous(), c[:, 2].contiguous(), side="left")


# --- 1. the stop's bound -----------------------------------------------------


@pytest.mark.parametrize("name", ["full", "clamped", "ends", "lattice", "parked", "tie_split"])
def test_dz_square_bounds_dsq_and_grows_along_each_side(name):
    cs, exts, starts, row_block, win = _case(name, 256)
    for f in range(cs.shape[0]):
        c, e = cs[f], exts[f]
        dz, dz2, place = _z_sides(c, e[:, 2])
        dx, dy = c[:, 0, None] - e[None, :, 0], c[:, 1, None] - e[None, :, 1]
        dsq = (dx * dx + dy * dy) + dz2
        both = ~torch.isnan(dsq)
        assert bool((dz2[both] <= dsq[both]).all())
        if name == "lattice":  # exact ties: many candidates at a row's z, and at one distance
            pos0 = dsq[0][dsq[0] > 0]
            assert bool((dz == 0).sum(-1).gt(1).all()) and torch.unique(pos0).numel() < len(pos0)
        for r in range(c.shape[0]):
            p = int(place[r])
            right, left = dz[r, p:].abs(), dz[r, :p].flip(0).abs()
            for side, sq in ((right, dz2[r, p:]), (left, dz2[r, :p].flip(0))):
                assert bool((side[1:] >= side[:-1]).all()) and bool((sq[1:] >= sq[:-1]).all())
            assert bool((dz[r, p:] <= 0).all()) and bool((dz[r, :p] > 0).all())
        if name == "parked":  # +inf slots sort last: fl(dz*dz) = +inf stops the right side
            assert bool(torch.isinf(dz2[:, -40:]).all()) and bool(torch.isinf(dsq[:, -40:]).all())


# --- 2. the scan and the selection against the plain version ------------------

CASES = ["full", "clamped", "ends", "lattice", "parked", "tie_split", "tie_all"]


def _check_rows(args, name):
    """The (frame, row) pairs emulated: all rows, or for the clamped case
    the first and last row blocks' rows and a few between."""
    F, R = args[0].shape[:2]
    if name != "clamped":
        return [(f, r) for f in range(F) for r in range(R)]
    return [(0, r) for r in (*range(8), 250, 251, *range(R - 8, R))]


@pytest.mark.parametrize("k", [64, 96, 128, 192, 256])
@pytest.mark.parametrize("name", CASES)
def test_outward_scan_equals_plain(name, k):
    args = _case(name, k)
    cs, exts, starts, row_block, win = args
    want_d, want_p = vtopk.voronoi_window_topk_plain(cs, exts, starts, k, row_block, win)
    rows = _check_rows(args, name)
    if name in ("full", "ends", "lattice"):
        rows = rows[:: 4 if k >= 192 else 2]
    wd = torch.stack([want_d[f, r] for f, r in rows])
    wp = torch.stack([want_p[f, r] for f, r in rows])
    splits = (1, 2, 4, 8) if name.startswith("tie") or name == "parked" else (1, 4)
    for split in splits:
        rng = None if split == 1 else np.random.RandomState(split + k)
        d, p, tested = _emulate(args, k, split, rows, rng)
        assert torch.equal(d.view(torch.int32), wd.view(torch.int32)), (split, d, wd)
        assert torch.equal(p, wp), split
        if name == "full":  # the stop prunes the full scan
            assert tested < 0.75 * len(rows) * win, tested
    if name == "parked":  # fewer than k finite candidates: the list is not full
        assert bool(torch.isinf(wd[:, 60:]).all()) and bool((wp[:, 60:] == -1).all())
    if name.startswith("tie"):
        pos_z = exts[0, wp[0].long(), 2]
        kth = wd[0, k - 1]
        assert float(kth) == 6.0 and int((want_d[0, 0] == 6.0).sum()) == (2 if name == "tie_split"
                                                                          else 6)
        assert 44.0 in pos_z.tolist() and (56.0 in pos_z.tolist()) == (name == "tie_all")


@pytest.mark.parametrize("k", [64, 128, 256])
def test_a_stop_at_equality_loses_the_tied_slot(k):
    """The planted tie discriminates the stop rule: stopping a side at
    fl(dz*dz) >= the bound skips P- (its z = 44 block's chunk starts at
    fl(dz*dz) = 36, the k-th dsq, before P- is offered), strictly above it
    does not."""
    args = _case("tie_split", k)
    want = vtopk.voronoi_window_topk_plain(*args[:3], k, *args[3:])
    d, p, _ = _emulate(args, k, 1, strict=True)
    assert torch.equal(p, want[1][0])
    d, p, _ = _emulate(args, k, 1, strict=False)
    assert not torch.equal(p, want[1][0])


def test_window_split_fills_the_card_only_on_launches_with_few_rows():
    """One warp a row from WINDOW_WARPS rows on (tier 1, the (48, 96) full
    scan at 2,048 waters), two at the last tier's 1,024, up to eight."""
    splits = {n: vtopk._window_split(n) for n in (32_768, 4_096, 2_048, 1_024, 512, 256, 64, 1)}
    assert splits == {32_768: 1, 4_096: 1, 2_048: 1, 1_024: 2, 512: 4, 256: 8, 64: 8, 1: 8}


# --- 3. against the JAX package ---------------------------------------------


@pytest.mark.parametrize("win_kind", ["narrow", "full"])
def test_emulation_matches_jax(win_kind, monkeypatch):
    """The emulated kernel behind the port's `_windowed_topk` on 300 water
    points against the JAX package's `_windowed_topk` (a window of 5/8 of
    the set) and its full scan `ops.pairs.topk_neighbors`, with
    tests/test_torch_voronoi_topk.py's tolerances: covered and valid equal,
    distances within DIST_TOL, index sets equal but on rows whose K-th
    distance ties."""
    n, k = 300, 64
    pts, box_l = _water(n, 0)
    p = torch.from_numpy(pts)[None]
    ext = tvd.mirror_points_device(p, torch.tensor([box_l], dtype=torch.float32))
    ext_j = jvd.mirror_points_device(jnp.asarray(pts), box_l)
    p4 = int(ext_j.shape[0])
    win = p4 * 5 // 8 if win_kind == "narrow" else p4
    if win < p4:
        ref = jvd._windowed_topk(jnp.asarray(pts), ext_j, k, 128, win)
    else:
        nl = jpairs.topk_neighbors(jnp.asarray(pts), ext_j, jnp.asarray([jvd._NO_PBC_BOX] * 3,
                                   jnp.float32), k=k, low_cut=0.0, high_cut=jnp.inf,
                                   row_block=128)
        ref = (nl.dist, nl.idx, nl.valid, np.ones(n, bool))
    plain = tvd._windowed_topk(p, ext, k, 128, win)
    seen = {}

    def emulated(cs, exts, starts, kk, row_block, w):
        seen["rows"] = cs.shape[1]
        d, pos, seen["tested"] = _emulate((cs, exts, starts, row_block, w), kk,
                                          vtopk._window_split(cs.shape[0] * cs.shape[1]))
        return d.reshape(*cs.shape[:2], kk), pos.reshape(*cs.shape[:2], kk)

    monkeypatch.setattr(vtopk, "voronoi_window_topk", emulated)
    out = tvd._windowed_topk(p, ext, k, 128, win)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    dj, ij, vj, cj = (np.asarray(x) for x in ref)
    dt, it, vt, ct = (x[0].numpy() for x in out)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(dt, dj, atol=DIST_TOL, rtol=0)
    differ = [r for r in range(n) if set(it[r].tolist()) != set(ij[r].tolist())]
    for r in differ:
        np.testing.assert_allclose(np.sort(dt[r]), np.sort(dj[r]), atol=DIST_TOL)
    assert len(differ) <= 0.01 * n, differ
    if win_kind == "narrow":
        assert 0 < int(ct.sum()) < n
    else:  # the stop prunes the full scan
        assert seen["tested"] < 0.75 * seen["rows"] * win
