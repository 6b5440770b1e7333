"""The exactness arguments of csrc/qtet_window.cu, on the CPU, as numpy and
torch emulations of what its two forms do.

1. The scan takes dsq by the magnitude minimum image, fminf(|d|, L - |d|),
   with the plain version's unfused sum: on a slab form's windows, whose pad
   copies lie within +/-L, its bits are the compare-selects' bits.
2. The row form (one row a thread): columns in ascending order, 4 at a
   time, a hit entering the row's list only within min(margin, 4.5 A)^2 and
   when strictly nearer than its 4th; a row with fewer than 4 hits within
   that filter and more in its shell is scanned again taking every hit. Its
   4 slots are the plain version's (4 rounds of lowest-column extraction),
   ties included.
3. The lane form (rows a warp, lane j the columns j, j + 32, ...): each
   lane's list, the same filter and second scan, and the merge of the 32
   lists by (dsq bits << 32) | column keys in 4 rounds of a minimum give
   the same slots.
4. The epilogue recomputes each slot's signed displacement from its column
   with the compare-selects: the plain version's stored displacements, bit
   for bit, so q and ok follow the plain version's operations.
The fixtures: a cubic lattice whose 4th and 5th neighbors tie exactly, a
slab form of a jittered lattice, pairs planted at exactly the margin and
the shell's edge with a coincident pair, and a sparse box where every row
is scanned again. The CUDA kernel itself is held against the plain version
on the card (chip_smoke.py); the plain version against the JAX package's q.
"""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.order import qtet as jqtet
from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu_torch.ops.cuda import qtet2, slab, window

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

F32 = np.float32
INF = F32(np.inf)
SENT = np.uint64(2**64 - 1)
FILTER = F32(4.5)  # kFilter
TOP = 4


def _bits(x):
    return x.contiguous().view(torch.int32)


def _jittered(n, f, seed):
    L = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, L, seed=seed)
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), L) for _ in range(f)])
    return pos.astype(F32), np.tile(F32([L] * 3), (f, 1))


def _cubic():
    """8^3 sites of spacing 3 A in a 24 A box: exact float32 distances; each
    row's 6 nearest tie at 3 A, so its 4th and 5th neighbors tie."""
    g = np.stack(np.meshgrid(*(np.arange(8),) * 3, indexing="ij"), -1).reshape(-1, 3) * 3.0
    return g[None].astype(F32), F32([[24.0] * 3])


def _planted():
    """A jittered 1024-water frame with every atom within 10.5 A of two
    centers removed; C1 gets neighbors at 2.5 A (three), exactly 4.5 A (the
    margin and the filter), exactly 10 A (the shell's edge) and 0 A (a
    coincident atom); C2 three at 2.5 A, its 4th at 4.5625 A (beyond the
    filter) and one at 10 A."""
    pos, boxes = _jittered(1024, 1, 4)
    c1, c2 = F32([16.0, 16.0, 8.0]), F32([16.0, 16.0, 24.0])
    keep = np.ones(pos.shape[1], bool)
    for c in (c1, c2):
        d = pos[0] - c
        d -= boxes[0] * np.round(d / boxes[0])
        keep &= (d * d).sum(-1) > 10.5**2
    off1 = [[2.5, 0, 0], [0, 2.5, 0], [0, 0, 2.5], [-4.5, 0, 0], [0, 0, 10.0], [0, 0, 0]]
    off2 = [[2.5, 0, 0], [0, 2.5, 0], [0, 0, 2.5], [-4.5625, 0, 0], [0, 0, -10.0]]
    planted = np.concatenate([c1[None], c1 + F32(off1), c2[None], c2 + F32(off2)])
    out = np.concatenate([pos[0][keep], planted])[None]
    return np.mod(out, boxes[0]).astype(F32), boxes


def _sparse():
    rs = np.random.RandomState(13)
    return rs.uniform(0, 200.0, (2, 512, 3)).astype(F32), np.full((2, 3), 200.0, F32)


def _brute(pos, boxes, high=10.0, margin=None):
    pos, boxes = torch.from_numpy(pos), torch.from_numpy(boxes)
    n = pos.shape[1]
    ext = slab.brute_cols(pos, boxes)
    starts = torch.zeros(-(-n // 128), dtype=torch.int32)
    m = high if margin is None else margin
    return (ext, ext, starts, boxes, n, 128, 0.0, high * high, m * m)


def _slab():
    pos, boxes = (torch.from_numpy(a) for a in _jittered(4096, 1, 0))
    n = pos.shape[1]
    win, pad = slab.plan(n, float(boxes[0, 2]), 4.5, 256)
    prep = slab.slab_prep_traj(pos, boxes, ((4.5, win),), 256, pad)
    assert bool(prep.covered[0].all())
    return (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes, prep.ws[0], 256,
            0.0, 100.0, 4.5 * 4.5)


def _args(kind):
    if kind == "cubic":
        return _brute(*_cubic())
    if kind == "slab":
        return _slab()
    if kind == "planted":
        return _brute(*_planted(), margin=4.5)
    return _brute(*_sparse(), high=50.0, margin=4.5)


@pytest.fixture(scope="module", params=["cubic", "slab", "planted", "sparse"])
def case(request):
    args = _args(request.param)
    tops = list(window.topk_tiles(*args[:6], args[6], args[7], TOP))
    return request.param, args, tops


def _window_dsq(args, r0, r1, s, mag):
    """(F, r, w) float32 dsq of rows [r0, r1) against the window at s: by the
    magnitude image (`mag`) or the compare-selects, the unfused sum."""
    rows, cols, _, boxes, w = args[:5]
    d = (cols[:, :, None, s : s + w] - rows[:, :, r0:r1, None]).numpy()
    L = boxes.numpy()[:, :, None, None]
    if mag:
        a = np.abs(d)
        e = np.minimum(a, L - a)
    else:
        e = np.where(d > L * F32(0.5), d - L, d)
        e = np.where(e < -L * F32(0.5), e + L, e)
    return (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]


def _insert(d, c, take, dsq, col):
    """Top4::insert over any leading shape: (dsq, col) enters where `take`
    and dsq < its 4th, after the entries equal to it."""
    p = take[..., None] & (dsq[..., None] < d)
    nd, nc = d.copy(), c.copy()
    for k in range(TOP - 1, 0, -1):
        nd[..., k] = np.where(p[..., k - 1], d[..., k - 1], np.where(p[..., k], dsq, d[..., k]))
        nc[..., k] = np.where(p[..., k - 1], c[..., k - 1], np.where(p[..., k], col, c[..., k]))
    nd[..., 0] = np.where(p[..., 0], dsq, d[..., 0])
    nc[..., 0] = np.where(p[..., 0], col, c[..., 0])
    return nd, nc


def _row_form(D, shell, filt):
    """The row form's pass over one tile's window: (d, c) lists of shape
    (F, r, 4), 4 columns at a time, `take` against the list before the 4."""
    shape = D.shape[:2]
    d, c = np.full(shape + (TOP,), INF, F32), np.zeros(shape + (TOP,), np.int64)
    w = D.shape[-1]
    for j0 in range(0, w, 4):
        group = range(j0, min(j0 + 4, w))
        take = [shell[..., j] & (D[..., j] <= filt) & (D[..., j] < d[..., -1]) for j in group]
        for t, j in zip(take, group):  # in column order
            d, c = _insert(d, c, t, D[..., j], j)
    return d, c


def _lane_form(D, shell, filt):
    """The lane form's pass: lane j takes the columns j, j + 32, ...; each
    lane a list of its own; then the merge of the 32 lists by key in 4
    rounds of a minimum, the winning lane's list moving up one."""
    F, r, w = D.shape
    nb = -(-w // 32)
    Dp = np.full((F, r, nb * 32), np.nan, F32)
    Dp[..., :w] = D
    Sp = np.zeros((F, r, nb * 32), bool)
    Sp[..., :w] = shell
    d = np.full((F, r, 32, TOP), INF, F32)
    c = np.zeros((F, r, 32, TOP), np.int64)
    cols = np.arange(nb * 32).reshape(nb, 32)
    for b in range(nb):
        x, s = Dp[..., 32 * b : 32 * (b + 1)], Sp[..., 32 * b : 32 * (b + 1)]
        d, c = _insert(d, c, s & (x <= filt) & (x < d[..., -1]), x, cols[b])
    key = np.where(d < INF, (d.view(np.uint32).astype(np.uint64) << np.uint64(32))
                   | c.astype(np.uint64), SENT)
    out = np.full((F, r, TOP), SENT, np.uint64)
    for t in range(TOP):
        m = key[..., 0].min(axis=-1)
        out[..., t] = m
        win = (key[..., 0] == m[..., None]) & (m[..., None] != SENT)
        key = np.where(win[..., None], np.concatenate([key[..., 1:], np.full_like(key[..., :1],
                                                                                  SENT)], -1), key)
    fin = out != SENT
    dd = np.where(fin, (out >> np.uint64(32)).astype(np.uint32).view(F32), INF)
    return dd.astype(F32), np.where(fin, out & np.uint64(0xFFFFFFFF), 0).astype(np.int64)


def _slots(args, form):
    """Each tile's 4 slots as the kernel's form takes them: [(r0, r1, dsq,
    window column, count)], the second scan (every hit) for the rows that
    need it."""
    rows, cols, starts, boxes, w, rt, low_sq, high_sq, margin_sq = args
    low, high = F32(low_sq), F32(high_sq)
    filt = min(F32(margin_sq), FILTER * FILTER)
    run = _row_form if form == "row" else _lane_form
    out = []
    for t, s in enumerate(starts.tolist()):
        r0, r1 = t * rt, min(rows.shape[2], (t + 1) * rt)
        D = _window_dsq(args, r0, r1, s, mag=True)
        shell = (D > low) & (D <= high)
        count = shell.sum(-1)
        d, c = run(D, shell, filt)
        found = (d < INF).sum(-1)
        again = (found < TOP) & (count > found)
        if again.any():
            d2, c2 = run(D, shell, F32(np.inf))
            d, c = np.where(again[..., None], d2, d), np.where(again[..., None], c2, c)
        out.append((r0, r1, d, c, count, again))
    return out


def test_magnitude_image_keeps_dsq_bits_on_pad_copies():
    args = _slab()
    rows, cols, starts = args[:3]
    n_pad = int((cols[0, 2] < 0).sum() + (cols[0, 2] >= args[3][0, 2]).sum())
    assert n_pad > 0  # the windows reach the pad copies, at z +/- L
    for t, s in enumerate(starts.tolist()):
        r0, r1 = t * 256, min(rows.shape[2], (t + 1) * 256)
        m, c = _window_dsq(args, r0, r1, s, True), _window_dsq(args, r0, r1, s, False)
        assert np.array_equal(m.view(np.int32), c.view(np.int32))


@pytest.mark.parametrize("form", ["row", "lane"])
def test_forms_give_the_plain_slots(case, form):
    kind, args, tops = case
    again_rows = []
    for (r0, r1, d, c, count, again), (p0, p1, top) in zip(_slots(args, form), tops):
        assert (r0, r1) == (p0, p1)
        assert np.array_equal(count, top.count.numpy())
        filled = np.arange(TOP) < np.minimum(count, TOP)[..., None]
        assert np.array_equal(filled, top.ok.numpy())
        want_d = np.where(filled, top.dsq.numpy(), INF)
        assert np.array_equal(np.where(filled, d, INF).view(np.int32), want_d.view(np.int32))
        start = int(args[2][r0 // args[5]])
        assert np.array_equal(np.where(filled, start + c, 0), np.where(filled, top.col.numpy(), 0))
        again_rows.append(again)
    again = np.concatenate(again_rows, axis=-1)
    if kind == "cubic":  # the 4th and 5th neighbors tie exactly: the column decides
        D = _window_dsq(args, 0, 128, 0, mag=True)
        Dm = np.sort(np.where((D > 0) & (D <= 100.0), D, INF), axis=-1)
        assert bool((Dm[..., 3] == Dm[..., 4]).all())
    if kind == "sparse":  # rows with a shell are scanned again
        assert int(again.sum()) > 100
    if kind == "planted":  # C2's 4th lies beyond the filter, C1's at its edge
        n = args[0].shape[2]
        assert bool(again[0, n - 6]) and not bool(again[0, n - 13])


def test_epilogue_displacements_are_the_stored_ones(case):
    """q_of recomputes each slot's displacement from its column with the
    compare-selects; those are the plain version's stored vectors, bit for
    bit, so q and ok are the plain version's."""
    kind, args, tops = case
    rows, cols, starts, boxes = args[:4]
    for t, (r0, r1, top) in enumerate(tops):
        s = int(starts[t])
        disp = window.window_disp(rows, cols, boxes, r0, r1, s, args[4])
        fc = (top.col - s).clamp(min=0)
        stored = disp.gather(3, fc[:, None].expand(-1, 3, -1, -1))
        L = boxes[:, :, None, None]
        F, r, k = top.col.shape
        idx = top.col.clamp(min=0).reshape(F, 1, r * k).expand(F, 3, r * k)
        d = cols.gather(2, idx).reshape(F, 3, r, k) - rows[:, :, r0:r1, None]
        d = torch.where(d > L * 0.5, d - L, d)
        d = torch.where(d < -L * 0.5, d + L, d)
        ok = top.ok[:, None].expand(-1, 3, -1, -1)
        assert torch.equal(_bits(torch.where(ok, d, 0.0)), _bits(torch.where(ok, stored, 0.0)))
    q, ok = qtet2.q_window_plain(*args)
    if kind == "planted":  # C1's 4th at exactly the margin: ok; C2's beyond it: not
        n = rows.shape[2]
        assert bool(ok[0, n - 13]) and not bool(ok[0, n - 6])
    if kind == "cubic":  # and the JAX package's q agrees, ties and all
        p, b = args[0][0].T.numpy(), args[3][0].numpy()
        want = np.asarray(jqtet.order_param_q(p, p, b, 0.0, 10.0, row_block=512))
        np.testing.assert_allclose(q[0].numpy(), want, atol=1e-5)
