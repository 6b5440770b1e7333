"""The exactness arguments of csrc/lsi_window.cu's K = 24 kernel, on the
CPU, as torch and numpy emulations of what the kernel does.

1. The scan takes the minimum image by magnitude, fminf(|d|, L - |d|). The
   slab form's pad copies lie within +/-L in z, so d lies in (-2L, 2L);
   the square equals the compare-selects' square bit for bit there, so
   dsq is the plain version's.
2. The kernel keeps each row's 24 smallest keys (dsq's bits << 32) |
   window column: ordering the candidates by that key gives
   `lsi_window_plain`'s slots (its 24 rounds of lowest-column extraction)
   and, through the epilogue, its values exactly, on lattice frames whose
   distances tie exactly and on random frames.
3. WarpSelect (csrc/warp_select.cuh), its bitonic network emulated lane by
   lane, keeps exactly those keys when the lanes offer a window's columns
   j, j + 32, ... in turn.
4. The warp epilogue (one slot a lane: ballot counts, the next-shell pick
   as a minimum over (raw bits, slot) keys, the sums as an ordered chain)
   gives `lsi._epilogue`'s values bit for bit.
The CUDA kernel itself is held against the plain version on the card
(chip_smoke.py). The random frames also go through the JAX package's LSI.
"""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.order import lsi as jlsi
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu_torch.ops.cuda import lsi, slab, window

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

HIGH, OUTER = 3.7, 7.4
SCALARS = (0.0, HIGH, OUTER * OUTER)
SENT = torch.iinfo(torch.int64).max


def _bits(x):
    return x.contiguous().view(torch.int32)


def _mag(d, box_l):
    a = d.abs()
    return torch.minimum(a, box_l - a)


def _mi(d, box_l):
    d = torch.where(d > box_l * 0.5, d - box_l, d)
    return torch.where(d < -box_l * 0.5, d + box_l, d)


@pytest.mark.parametrize("box_l", [23.7011, 49.6507, 101.27])
def test_magnitude_square_over_the_pad_range(box_l):
    L = np.float32(box_l)
    rs = np.random.RandomState(3)
    inf = np.float32(np.inf)
    edges = [np.float32(0), L / 2, np.nextafter(L / 2, inf), np.nextafter(L / 2, -inf), L,
             np.nextafter(L, inf), np.nextafter(L, -inf), L * np.float32(1.5),
             np.nextafter(2 * L, -inf)]
    d = np.concatenate([edges, [-e for e in edges], rs.uniform(-2 * L, 2 * L, 200_000)])
    dt, Lt = torch.from_numpy(d.astype(np.float32)), torch.tensor(L)
    m, s = _mag(dt, Lt), _mi(dt, Lt)
    assert torch.equal(_bits(m * m), _bits(s * s))
    inside = dt.abs() < Lt
    assert torch.equal(_bits(m[inside]), _bits(s[inside].abs()))


def _shifted(n, f, seed):
    """Jittered-lattice frames at water density, a third of the atoms stored
    shifted by +/-L (the same wrapped frame, other raw distances)."""
    L = (n / 0.033456) ** (1.0 / 3.0)
    rs = np.random.RandomState(seed)
    base = water_oxygen_lattice(n, L, seed=seed)
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), L) for _ in range(f)])
    some = rs.uniform(size=pos.shape[:2]) < 1.0 / 3.0
    pos = pos + rs.randint(-1, 2, size=pos.shape) * some[..., None] * L
    return pos.astype(np.float32), np.tile(np.float32([L] * 3), (f, 1))


def _lattice():
    """8^3 sites of a cubic lattice of spacing 3 A in a 24 A box: every
    coordinate and difference is exact in float32, so distances tie
    exactly (the 24th neighbor falls inside the 24-member shell at sqrt(45));
    every third atom is stored shifted by +L in x, and a few sites are moved
    by planted offsets that keep their distances tied."""
    g = np.stack(np.meshgrid(*(np.arange(8),) * 3, indexing="ij"), -1).reshape(-1, 3) * 3.0
    g[5] += [0.5, 0.0, 0.0]
    g[77] += [0.0, 0.5, 0.0]
    g[300] += [0.0, 0.0, -0.5]
    g[::3, 0] += 24.0
    return g[None].astype(np.float32), np.float32([[24.0] * 3])


def _args(kind):
    """lsi_window arguments (the brute or the slab form)."""
    if kind == "lattice":
        pos, boxes = _lattice()
    elif kind == "random":
        pos, boxes = _shifted(600, 2, 5)
    else:
        pos, boxes = _shifted(2600, 1, 6)
    pos, boxes = torch.from_numpy(pos), torch.from_numpy(boxes)
    n = pos.shape[1]
    if kind != "slab":
        ext, raw = slab.brute_cols(pos, boxes), slab.brute_raw(pos)
        starts = torch.zeros(-(-n // 128), dtype=torch.int32)
        return pos, (ext, ext, starts, boxes, n, 128, raw, raw, *SCALARS)
    win, pad = slab.plan(n, float(boxes[0, 2]), OUTER, 128)
    prep = slab.slab_prep_traj(pos, boxes, ((OUTER, win),), 128, pad)
    assert bool(prep.covered[0].all())
    raw = slab.raw_ext_t(pos, prep.order0, pad)
    return pos, (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes, prep.ws[0],
                 128, raw[:, :, pad : pad + n], raw, *SCALARS)


@pytest.fixture(scope="module", params=["lattice", "random", "slab"])
def case(request):
    pos, args = _args(request.param)
    return request.param, pos, args, lsi.lsi_window_plain(*args)


def _keys(rows, cols, boxes, r0, r1, s, w, low_sq, outer_sq):
    """(F, r, w) int64 keys of the kernel's scan: dsq by the magnitude
    minimum image and its fmaf chain, (dsq bits << 32) | window column, and
    SENT outside (low, outer]."""
    d = cols[:, :, None, s : s + w] - rows[:, :, r0:r1, None]
    m = _mag(d, boxes[:, :, None, None])
    dsq = window.dot3(m[:, 0], m[:, 0], m[:, 1], m[:, 1], m[:, 2], m[:, 2], fused=True)
    ok = (dsq > low_sq) & (dsq <= outer_sq)
    key = (_bits(dsq).long() << 32) | torch.arange(w)
    return torch.where(ok, key, SENT)


def _decode(top):
    """(dsq, window column, fin) of keys; +inf and fin False for SENT."""
    fin = top != SENT
    dsq = (top >> 32).to(torch.int32).view(torch.float32)
    return torch.where(fin, dsq, torch.inf), top & 0xFFFFFFFF, fin


def _key_lsi(args):
    """lsi_window's outputs with the 24 slots taken by sorting the keys."""
    rows, cols, starts, boxes, w, rt, raw_rows, raw_cols, low_sq, high, outer_sq = args
    outs = lsi._outs(rows, 3)
    for t, s in enumerate(starts.tolist()):
        r0, r1 = t * rt, min(rows.shape[2], (t + 1) * rt)
        keys = _keys(rows, cols, boxes, r0, r1, s, w, low_sq, outer_sq)
        top = torch.sort(keys, dim=-1).values[..., : lsi.K]
        dsq, col, fin = _decode(top)
        rawsq = torch.where(fin, lsi._raw_dsq(raw_rows, raw_cols, r0, r1, s + col), torch.inf)
        lsi._store(outs, r0, r1, *lsi._epilogue(sqrt_f32(dsq), rawsq, fin, high))
    return outs


def test_key_order_gives_the_plain_slots_and_values(case):
    kind, pos, args, want = case
    got = _key_lsi(args)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    rows, cols, starts, boxes, w, rt = args[:6]
    for t, (r0, r1, top) in enumerate(window.topk_tiles(rows, cols, starts, boxes, w, rt,
                                                        args[8], args[10], lsi.K, fused=True)):
        keys = _keys(rows, cols, boxes, r0, r1, int(starts[t]), w, args[8], args[10])
        dsq, col, fin = _decode(torch.sort(keys, dim=-1).values[..., : lsi.K])
        assert torch.equal(fin, top.ok)
        assert torch.equal(_bits(dsq), _bits(top.dsq))
        assert torch.equal(torch.where(fin, int(starts[t]) + col, 0), torch.where(fin, top.col, 0))
    if kind == "lattice":  # ties decide slots here
        d = sqrt_f32(_decode(torch.sort(_keys(rows, cols, boxes, 0, 128, 0, w, args[8],
                                                args[10]), dim=-1).values)[0])
        assert bool((d[..., 23] == d[..., 24]).any())
    if kind == "random":  # and the JAX package's LSI agrees, as the port's tests hold it
        for f in range(pos.shape[0]):
            p, b = pos[f].numpy(), args[3][f].numpy()
            ref = jlsi.lsi(p, p, b, 0.0, HIGH, k=24, row_block=512)
            np.testing.assert_array_equal(got[1][f].numpy(), np.asarray(ref.valid))
            np.testing.assert_allclose(got[0][f].numpy(), np.asarray(ref.lsi), atol=2e-5)


def _bitonic_merge(L, v):
    """WarpSelect<1>::merge over 32 lanes (numpy uint64 arrays), step by
    step: the bitonic sort of v across lanes, the reversed keys against L,
    the bitonic merge."""
    lane = np.arange(32)
    size = 2
    while size <= 32:
        d = size >> 1
        while d > 0:
            o = v[lane ^ d]
            up = ((lane & d) == 0) == ((lane & size) == 0)
            v = np.where(up, np.minimum(v, o), np.maximum(v, o))
            d >>= 1
        size <<= 1
    L = np.minimum(L, v[31 - lane])
    d = 16
    while d > 0:
        o = L[lane ^ d]
        L = np.where(lane & d, np.maximum(L, o), np.minimum(L, o))
        d >>= 1
    return L


def _warp_select(keys, k):
    """WarpSelect<1> of one row: the lanes offer keys[j0 + lane] in turns of
    32 (the kernel's column order), each below thr into the buffer in lane
    order, a merge for every 32 buffered, a flush at the end. Returns L."""
    sent = np.uint64(2**64 - 1)
    L = np.full(32, sent, np.uint64)
    thr, buf, merges = sent, [], 0
    for j0 in range(0, len(keys), 32):
        batch = keys[j0 : j0 + 32]
        buf += [x for x in batch if x < thr]
        if len(buf) >= 32:
            L, buf, merges = _bitonic_merge(L, np.array(buf[:32], np.uint64)), buf[32:], merges + 1
            thr = L[k - 1]
    if buf:
        L = _bitonic_merge(L, np.array(buf + [sent] * (32 - len(buf)), np.uint64))
    return L, merges


@pytest.mark.parametrize("k", [24, 1, 32])
def test_warp_select_keeps_the_k_smallest_keys(case, k):
    kind, _, args, _ = case
    rows, cols, starts, boxes, w = args[:5]
    keys = _keys(rows, cols, boxes, 0, 128, int(starts[0]), w, args[8], args[10])
    keys = keys[0, :: 4 if kind == "slab" else 2].numpy().astype(np.uint64)  # SENT: 2^63 - 1
    keys[keys == np.uint64(2**63 - 1)] = np.uint64(2**64 - 1)
    n_merges = 0
    for row in keys:
        L, merges = _warp_select(list(row), k)
        want = np.sort(row)[:k]
        assert np.array_equal(L[:k], want)
        n_merges += merges
    assert n_merges > 0


def _warp_epilogue(dist, rawsq, fin, high):
    """csrc/lsi_window.cu `lsi_epilogue_warp` over (F, r, 24) slots, in
    torch: the lanes' values side by side, the shuffles as indexing."""
    inf = torch.tensor(torch.inf)
    pad = lambda x, v: torch.cat([x, torch.full_like(x[..., :8], v)], dim=-1)  # noqa: E731
    dist, rawsq, fin = pad(dist, torch.inf), pad(rawsq, torch.inf), pad(fin, False)
    slot = torch.arange(32)
    n_near = (fin & (dist <= high)).sum(dim=-1)
    isnext = fin & (dist > high)
    has_next = isnext.any(dim=-1)
    b = torch.where(isnext & (rawsq < inf), (_bits(rawsq).long() << 32) | slot, SENT)
    b = b.min(dim=-1).values
    at_best = dist.gather(-1, (b & 31)[..., None])[..., 0]
    next_dist = torch.where(b != SENT, at_best, 0.0)
    last = torch.where(n_near > 1, n_near - 1, 0)
    final_gap = next_dist - dist.gather(-1, last[..., None])[..., 0]
    denom = torch.where(n_near > 1, n_near, 1).to(torch.float32)
    dnext = torch.cat([dist[..., 1:], dist[..., 31:]], dim=-1)  # __shfl_down: lane 31 keeps its own
    gap, inner = dnext - dist, dnext < inf
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


def test_warp_epilogue_equals_the_sequential_epilogue(case):
    _, _, args, _ = case
    rows, cols, starts, boxes, w, rt, raw_rows, raw_cols, low_sq, high, outer_sq = args
    checked = 0
    for t, s in enumerate(starts.tolist()[:6]):
        r0, r1 = t * rt, min(rows.shape[2], (t + 1) * rt)
        top = torch.sort(_keys(rows, cols, boxes, r0, r1, s, w, low_sq, outer_sq),
                         dim=-1).values[..., : lsi.K]
        dsq, col, fin = _decode(top)
        rawsq = torch.where(fin, lsi._raw_dsq(raw_rows, raw_cols, r0, r1, s + col), torch.inf)
        dist = sqrt_f32(dsq)
        got, want = _warp_epilogue(dist, rawsq, fin, high), lsi._epilogue(dist, rawsq, fin, high)
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        checked += int(want[1].sum())
    assert checked > 100


def test_library_key_follows_included_headers(tmp_path, monkeypatch):
    """build.py names each library by a hash of its source and of the csrc/
    headers the source includes: an edited warp_select.cuh renames the
    libraries of both sources that include it, and no other (no nvcc)."""
    from waterorderlib_tpu_torch.ops.cuda import build

    names = ("voronoi_topk", "lsi_window", "hbond")
    for f in (*(f"{n}.cu" for n in names), "warp_select.cuh"):
        (tmp_path / f).write_bytes((build.CSRC / f).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._sources("lsi_window")] == ["lsi_window.cu", "warp_select.cuh"]
    assert [p.name for p in build._sources("hbond")] == ["hbond.cu"]
    before = {n: build._library(n) for n in names}
    header = tmp_path / "warp_select.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._library(n) for n in names}
    assert after["voronoi_topk"] != before["voronoi_topk"]
    assert after["lsi_window"] != before["lsi_window"]
    assert after["hbond"] == before["hbond"]
    assert all(p.parent == build.BUILD_DIR and p.name.startswith(f"lib{n}-")
               for n, p in after.items())
