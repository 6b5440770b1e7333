"""The port's Voronoi K-nearest search (ops/cuda/voronoi_topk.py plain
versions, surface/voronoi_device.py search prep) against
waterorderlib_tpu.surface.voronoi_device and its Pallas kernels.

On CPU tensors the kernel's wrappers run their plain versions (the kernel
equals them exactly on the card: chip_smoke.py). Tolerances: `covered`,
`valid`, the cell-grid table, overflow and dropped flags equal exactly;
distances within 2e-6 A (XLA's CPU backend contracts the window form's
sum of squares into fmas, the port's order is ((dx*dx) + (dy*dy)) +
(dz*dz): one ulp of d^2); index sets equal on every row but those whose
K-th distance ties with a candidate left out, which are listed. The
mirrors and every sizing helper equal the JAX package's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops import pairs as jpairs
from waterorderlib_tpu.ops.pallas.voronoi_topk import voronoi_topk_pallas
from waterorderlib_tpu.surface import voronoi_device as jvd
from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk
from waterorderlib_tpu_torch.surface import voronoi_device as tvd

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

DIST_TOL = 2e-6  # A: one ulp of d^2 at the fixtures' distances


def _water_points(n=500, jitter=0.6, seed=0):
    """tests/test_voronoi_device.py's liquid-like fixture, float32."""
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(seed)
    return ((base + rs.normal(scale=jitter, size=base.shape)) % box_l).astype(np.float32), box_l


def _port(pts, box_l):
    """(points (1, n, 3), ext (1, 4n, 3), box (1,)) as the port's tensors."""
    p = torch.from_numpy(pts)[None]
    box = torch.tensor([box_l], dtype=torch.float32)
    return p, tvd.mirror_points_device(p, box), box


def _tie_rows(i_a, i_b, d_a, d_b):
    """Rows whose index sets differ; each must be a tie at the K-th
    boundary: the same sorted distances within DIST_TOL."""
    rows = [r for r in range(len(i_a)) if set(i_a[r].tolist()) != set(i_b[r].tolist())]
    for r in rows:
        np.testing.assert_allclose(np.sort(d_a[r]), np.sort(d_b[r]), atol=DIST_TOL)
    return rows


def _assert_search_equal(jax_out, port_out, rows=None):
    dj, ij, vj, cj = (np.asarray(x) for x in jax_out)
    dt, it, vt, ct = (x[0].numpy() for x in port_out)
    if rows is not None:
        dj, ij, vj, cj, dt, it, vt, ct = (x[rows] for x in (dj, ij, vj, cj, dt, it, vt, ct))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(dt, dj, atol=DIST_TOL, rtol=0)
    ties = _tie_rows(it, ij, dt, dj)
    assert len(ties) <= 0.01 * len(it), ties
    return ties


@pytest.mark.parametrize("n", [300, 500])
@pytest.mark.parametrize("win_kind", ["suggest", "narrow", "full"])
def test_window_plain_matches_jax(n, win_kind):
    """The z-window form against `_windowed_topk` (a window narrower than
    the set) and against the full scan `_cells_blocked` takes otherwise
    (`ops.pairs.topk_neighbors`); `_suggest_win` is the full scan at these
    sizes, so "narrow" forces a window of 5/8 of the set."""
    pts, box_l = _water_points(n)
    p, ext, _ = _port(pts, box_l)
    ext_j = jvd.mirror_points_device(jnp.asarray(pts), box_l)
    p4 = int(ext_j.shape[0])
    win = {"suggest": jvd._suggest_win(n, p4, box_l, 64), "narrow": p4 * 5 // 8,
           "full": p4}[win_kind]
    assert win == tvd._suggest_win(n, p4, box_l, 64) or win_kind != "suggest"
    if win < p4:
        ref = jvd._windowed_topk(jnp.asarray(pts), ext_j, 64, 128, win)
    else:
        nl = jpairs.topk_neighbors(jnp.asarray(pts), ext_j, jnp.asarray([jvd._NO_PBC_BOX] * 3,
                                   jnp.float32), k=64, low_cut=0.0, high_cut=jnp.inf, row_block=128)
        ref = (nl.dist, nl.idx, nl.valid, np.ones(n, bool))
    out = tvd._windowed_topk(p, ext, 64, 128, win)
    _assert_search_equal(ref, out)
    if win_kind == "narrow":
        assert 0 < int(out[3].sum()) < n  # the window misses some rows


def test_window_plain_matches_pallas_interpret():
    """The window form against `voronoi_topk_pallas` in interpret mode, on
    tests/test_voronoi_device.py's fixture (300 uniform points, 256
    centers, the whole set as the window, seg 384)."""
    rs = np.random.RandomState(3)
    n = 300
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    pts = rs.uniform(0, box_l, (n, 3)).astype(np.float32)
    ext_j = jvd.mirror_points_device(jnp.asarray(pts), box_l)
    with pltpu.force_tpu_interpret_mode():
        ref = voronoi_topk_pallas(jnp.asarray(pts[:256]), ext_j, 64, row_block=128,
                                  win=int(ext_j.shape[0]), seg=384)
    _, ext, _ = _port(pts, box_l)
    out = tvd._windowed_topk(torch.from_numpy(pts[:256])[None], ext, 64, 128, ext.shape[1])
    assert bool(np.asarray(ref[3]).all())
    _assert_search_equal(ref, out)


def _grid_fixture(n=512, seed=11):
    pts, box_l = _water_points(n, seed=seed)
    return pts, box_l, jvd.mirror_points_device(jnp.asarray(pts), box_l)


@pytest.mark.parametrize("k_search", [48, 64])
def test_cellgrid_plain_matches_xla(k_search):
    """The cell-grid form and its table against `_cellgrid_build` and
    `_cellgrid_topk(select="xla")` (512 points, n_side 5, cap 64)."""
    pts, box_l, ext_j = _grid_fixture()
    p, ext, box = _port(pts, box_l)
    tj = jvd._cellgrid_build(ext_j, jnp.float32(box_l), 5, 64)
    pos, idx, overflow, dropped, s = tvd._cellgrid_build(ext, box, 5, 64)
    tbl = np.asarray(tj[0]).reshape(125, 4, 64)
    np.testing.assert_array_equal(pos[0].numpy(), tbl[:, :3])
    np.testing.assert_array_equal(idx[0].numpy(), tbl[:, 3].astype(np.int32))
    np.testing.assert_array_equal(overflow[0].numpy(), np.asarray(tj[1]))
    assert bool(dropped[0]) == bool(tj[2]) and float(s[0]) == float(tj[3])
    ref = jvd._cellgrid_topk(jnp.asarray(pts), ext_j, jnp.float32(box_l), k_search, 64, 5, 64,
                             select="xla")
    out = tvd._cellgrid_topk(p, tvd._cellgrid_build(ext, box, 5, 64), k_search, 5)
    _assert_search_equal(ref, out)
    assert int(out[3].sum()) > 0.5 * len(pts)


def test_cellgrid_plain_matches_pallas_interpret():
    """The cell-grid form against `cellgrid_extract_pallas` in interpret
    mode, on tests/test_voronoi_device.py's fixture (k_search 48): the
    same coverage, and on covered rows the same candidates."""
    pts, box_l, ext_j = _grid_fixture()
    with pltpu.force_tpu_interpret_mode():
        ref = jvd._cellgrid_topk(jnp.asarray(pts), ext_j, jnp.float32(box_l), 48, 64, 5, 64,
                                 select="pallas")
    p, ext, box = _port(pts, box_l)
    out = tvd._cellgrid_topk(p, tvd._cellgrid_build(ext, box, 5, 64), 48, 5)
    cov = np.asarray(ref[3])
    np.testing.assert_array_equal(out[3][0].numpy(), cov)
    _assert_search_equal(ref, out, rows=np.where(cov)[0])


def test_cellgrid_overflow_vetoes_coverage():
    """A cell holding more than cap candidates vetoes every row whose
    neighborhood touches it, as in the JAX package (its fixture: 40 points
    in a 0.15 A cluster at the center of cell (2, 2, 2), n_side 6, cap
    16)."""
    n = 500
    pts, box_l = _water_points(n, seed=9)
    rs = np.random.RandomState(3)
    n_side, cap = 6, 16
    ccenter = 1.5 * box_l / (n_side - 2)
    cluster = ccenter + rs.normal(scale=0.15, size=(40, 3))
    pts = np.concatenate([pts[:-40], cluster]).astype(np.float32)
    ext_j = jvd.mirror_points_device(jnp.asarray(pts), box_l)
    ref = jvd._cellgrid_topk(jnp.asarray(pts), ext_j, jnp.float32(box_l), 32, 128, n_side, cap)
    p, ext, box = _port(pts, box_l)
    out = tvd._cellgrid_topk(p, tvd._cellgrid_build(ext, box, n_side, cap), 32, n_side)
    cov = out[3][0].numpy()
    np.testing.assert_array_equal(cov, np.asarray(ref[3]))
    near = np.linalg.norm(pts - ccenter, axis=1) < 1.0
    assert near.sum() >= 40 and not cov[near].any() and cov.sum() > 0
    _assert_search_equal(ref, out, rows=np.where(cov)[0])


@pytest.mark.parametrize("n,density,k_search", [
    (300, 0.033456, 64), (2048, 0.033456, 64), (3456, 0.033456, 64), (12_294, 0.0334, 96),
    (12_294, 0.0334, 192), (4096, 0.02, 128), (131_072, 0.033456, 256), (100, 0.01, 64),
])
def test_mirrors_and_sizing_match_jax(n, density, k_search):
    """mirror_points_device, mirror_points_pruned (ext, ext_map,
    margin_eff) and every sizing helper equal the JAX package's."""
    box_l = (n / density) ** (1.0 / 3.0)
    assert tvd._suggest_win(n, 4 * n, box_l, k_search) == jvd._suggest_win(n, 4 * n, box_l,
                                                                             k_search)
    for rows in (1, 64, 300, 5000):
        w = tvd._suggest_win_subset(n, box_l, k_search, rows)
        assert w == jvd._suggest_win_subset(n, box_l, k_search, rows)
        assert tvd._quantize_win(w, 4 * n) == jvd._quantize_win(w, 4 * n)
    budget = tvd._suggest_mirror_budget(n, box_l, k_search)
    assert budget == jvd._suggest_mirror_budget(n, box_l, k_search)
    for s_factor in (1.12, 1.4):
        assert (tvd._suggest_cellgrid(n, box_l, k_search, s_factor)
                == jvd._suggest_cellgrid(n, box_l, k_search, s_factor))
    if n > 5000:
        return
    rs = np.random.RandomState(n)
    pts = rs.uniform(0, box_l, (n, 3)).astype(np.float32)
    pts[: n // 10, 0] = pts[n // 10 : 2 * (n // 10), 0]  # depth ties across points
    ext = tvd.mirror_points_device(torch.from_numpy(pts), box_l)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jvd.mirror_points_device(
        jnp.asarray(pts), box_l)))
    b = budget or 128
    e_t, m_t, g_t = tvd.mirror_points_pruned(torch.from_numpy(pts)[None],
                                             torch.tensor([box_l]), b)
    e_j, m_j, g_j = jvd.mirror_points_pruned(jnp.asarray(pts), box_l, b)
    np.testing.assert_array_equal(e_t[0].numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(m_t[0].numpy(), np.asarray(m_j))
    assert float(g_t[0]) == float(g_j)


def test_planted_tie_goes_to_the_lowest_lane():
    """Equal distances keep the lowest lane (window position or grid slot
    order), and coincident candidates are dropped."""
    c = torch.zeros((1, 8, 3))
    e = torch.full((1, 64, 3), 50.0)
    e[0, :, 0] += torch.arange(64, dtype=torch.float32)
    for lane in (3, 7, 40, 41):
        e[0, lane] = torch.tensor([1.0, 0.0, 0.0] if lane % 2 else [0.0, 1.0, 0.0])
    e[0, 10] = 0.0
    dist, pos = vtopk.voronoi_window_topk(c, e, torch.zeros((1, 1), dtype=torch.int32), 3, 8, 64)
    assert pos[0, 0].tolist() == [3, 7, 40] and bool((dist[0, :, :3] == 1.0).all())
    dist, pos = vtopk.voronoi_window_topk(c, e, torch.tensor([[5]], dtype=torch.int32), 3, 8, 40)
    assert pos[0, 0].tolist() == [7, 40, 41]
    # the grid: one 3x3x3 block of cells, the tie split over two cells
    n_side, cap = 3, 4
    tbl = torch.full((1, 27, 3, cap), float("inf"))
    ids = torch.full((1, 27, cap), -1, dtype=torch.int32)
    for cell, slot, xyz, cid in ((20, 1, (0.0, 0.0, 1.0), 5), (4, 2, (0.0, 1.0, 0.0), 9),
                                 (4, 0, (1.0, 0.0, 0.0), 2), (13, 0, (0.0, 0.0, 0.0), 7)):
        tbl[0, cell, :, slot] = torch.tensor(xyz)
        ids[0, cell, slot] = cid
    dist, idx = vtopk.voronoi_cellgrid_topk(c[:, :1], torch.tensor([[13]], dtype=torch.int32),
                                            tbl, ids, n_side, 4)
    assert idx[0, 0].tolist() == [2, 9, 5, -1]  # cells in order, then slots; self dropped
    assert dist[0, 0, :3].tolist() == [1.0, 1.0, 1.0] and dist[0, 0, 3] == float("inf")


def test_wrappers_check_their_inputs():
    c = torch.zeros((1, 8, 3))
    e = torch.zeros((1, 64, 3))
    st = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        vtopk.voronoi_window_topk(c.half(), e.half(), st, 3, 8, 64)
    with pytest.raises(TypeError):
        vtopk.voronoi_window_topk(c, e.double(), st, 3, 8, 64)
    with pytest.raises(ValueError):
        vtopk.voronoi_window_topk(c, e, st, 3, 5, 64)  # rows not whole blocks
    with pytest.raises(ValueError):
        vtopk.voronoi_window_topk(c, e, st.long(), 3, 8, 64)
    with pytest.raises(ValueError):
        vtopk.voronoi_window_topk(c, e, st, 3, 8, 65)  # window beyond the candidates
    with pytest.raises(ValueError):
        vtopk.voronoi_window_topk(c, e, st, vtopk.MAX_K + 1, 8, 64)
    with pytest.raises(ValueError):
        vtopk.voronoi_window_topk(c, e.transpose(1, 2).contiguous().transpose(1, 2), st, 3, 8,
                                  64)
    with pytest.raises(RuntimeError):
        vtopk.voronoi_window_topk(c.to("meta"), e.to("meta"), st.to("meta"), 3, 8, 64)
    with pytest.raises(ValueError):  # the lane count is the kernel's: an int64 (1,) tensor
        vtopk.voronoi_window_topk(c, e, st, 3, 8, 64, tested=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # and CPU tensors run the plain version
        vtopk.voronoi_window_topk(c, e, st, 3, 8, 64, tested=torch.zeros(1, dtype=torch.int64))
    tbl = torch.zeros((1, 27, 3, 4))
    ids = torch.zeros((1, 27, 4), dtype=torch.int32)
    cid = torch.tensor([[13]], dtype=torch.int32)
    with pytest.raises(ValueError):
        vtopk.voronoi_cellgrid_topk(c[:, :1], cid, tbl, ids, 4, 3)  # n_side^3 cells
    with pytest.raises(ValueError):
        vtopk.voronoi_cellgrid_topk(c[:, :1], cid.long(), tbl, ids, 3, 3)
    with pytest.raises(ValueError):
        vtopk.voronoi_cellgrid_topk(c, cid, tbl, ids, 3, 3)  # one cell id a row
    # CPU tensors run the plain versions and leave the launch counts alone
    before = (vtopk.voronoi_window_topk.launches, vtopk.voronoi_cellgrid_topk.launches)
    calls = vtopk.voronoi_cellgrid_topk_plain.calls
    vtopk.voronoi_cellgrid_topk(c[:, :1], cid, tbl, ids, 3, 3)
    assert vtopk.voronoi_cellgrid_topk_plain.calls == calls + 1
    assert (vtopk.voronoi_window_topk.launches, vtopk.voronoi_cellgrid_topk.launches) == before


# --- the cell-grid kernel's grouped mapping, around the plain selection -----


def _grouped_emulation(centers, cid, tbl_pos, tbl_idx, n_side, k):
    """csrc/voronoi_topk.cu's grouped mapping with a plain selection: the
    wrapper's row order (`_cellgrid_order`), GROUP_ROWS sorted rows a
    block; per run of one frame and cell among them, its 27 neighbors
    staged in SCAN_ORDER, only slots with finite coordinates, each tagged
    with its lane o * cap + slot; per row of the run the k smallest dsq over
    the staged slots, ties to the lowest lane; the results written to the
    row's own place (the inverse of the sort by cell)."""
    F, R, _ = centers.shape
    cap = tbl_idx.shape[-1]
    order, flat_cid = vtopk._cellgrid_order(cid).numpy(), cid.reshape(-1).numpy()
    offs = vtopk._offsets(n_side)
    dist = torch.full((F * R, k), float("inf"), dtype=centers.dtype)
    idx = torch.full((F * R, k), -1, dtype=torch.int32)
    done = np.zeros(F * R, int)
    for first in range(0, F * R, vtopk.GROUP_ROWS):
        last, a = min(first + vtopk.GROUP_ROWS, F * R), first
        while a < last:
            f, c0 = order[a] // R, int(flat_cid[order[a]])
            b = a + 1
            while b < last and order[b] // R == f and flat_cid[order[b]] == c0:
                b += 1
            rows, a = order[a:b], b
            xyz, lanes, ids = [], [], []
            for o in vtopk.SCAN_ORDER:
                planes = tbl_pos[f, c0 + offs[o]]  # (3, cap)
                slots = torch.nonzero(torch.isfinite(planes).all(0))[:, 0]
                xyz.append(planes[:, slots])
                lanes.append(o * cap + slots)
                ids.append(tbl_idx[f, c0 + offs[o], slots])
            x, y, z = torch.cat(xyz, 1)
            lanes, ids = torch.cat(lanes).numpy(), torch.cat(ids)
            dsq = vtopk._dsq(centers.reshape(-1, 3)[torch.as_tensor(rows)], x, y, z)
            for n, row in enumerate(rows):
                keep = ((dsq[n] > 0) & torch.isfinite(dsq[n])).numpy()
                d = dsq[n].numpy()[keep]
                pick = np.lexsort((lanes[keep], d))[:k]  # by dsq, then lane
                dist[row, :len(pick)] = vtopk._sqrt(torch.as_tensor(d[pick]))
                idx[row, :len(pick)] = ids[torch.as_tensor(np.nonzero(keep)[0][pick])]
                done[row] += 1
    assert (done == 1).all()
    return dist.reshape(F, R, k), idx.reshape(F, R, k)


def _grid_case(name):
    """(centers, cid, tbl_pos, tbl_idx, n_side, k) of a fixture: "tier1" a
    small box's tier-1 shape (1,200 points, 2 frames, grid (5, 96): ~44
    rows to an inner cell), "escalation" a sparse subset of it (40 rows and
    24 bucket-padding copies of the first, 3 frames, k 96 at grid (6, 96):
    one row to an inner cell; three cells of the table emptied), "tie" the
    planted cross-cell tie."""
    if name == "tie":
        tbl = torch.full((1, 27, 3, 4), float("inf"))
        ids = torch.full((1, 27, 4), -1, dtype=torch.int32)
        for cell, slot, xyz, c in ((20, 1, (0.0, 0.0, 1.0), 5), (4, 2, (0.0, 1.0, 0.0), 9),
                                   (4, 0, (1.0, 0.0, 0.0), 2), (13, 0, (0.0, 0.0, 0.0), 7)):
            tbl[0, cell, :, slot] = torch.tensor(xyz)
            ids[0, cell, slot] = c
        return torch.zeros((1, 1, 3)), torch.tensor([[13]], dtype=torch.int32), tbl, ids, 3, 4
    pts, box_l = _water_points(1200, seed=3)
    frames = 2 if name == "tier1" else 3
    pb = torch.from_numpy(np.stack([(pts + 0.37 * f) % box_l for f in range(frames)]))
    box = torch.full((frames,), box_l)
    n_side, cap, k = (5, 96, 32) if name == "tier1" else (6, 96, 96)
    pos, ids, _, _, s = tvd._cellgrid_build(tvd.mirror_points_device(pb, box), box, n_side, cap)
    if name == "escalation":
        rows = np.random.RandomState(5).choice(1200, 40, replace=False)
        pb = pb[:, torch.as_tensor(np.concatenate([rows, np.full(24, rows[0])]))].contiguous()
        for cell in (31, 62, 93):
            pos[:, cell], ids[:, cell] = float("inf"), -1
    _, cid = tvd._cellgrid_rows(pb, s, n_side)
    return pb, cid, pos, ids, n_side, k


@pytest.mark.parametrize("case", ["tier1", "escalation", "tie"])
def test_cellgrid_grouping_matches_plain(case):
    """The grouped mapping's decomposition (rows sorted by cell, each run of
    one cell in a block's rows staged once without its empty slots, read in
    SCAN_ORDER, ties by lane) gives exactly `voronoi_cellgrid_topk_plain`'s
    dist and idx: at a tier-1 shape, on a sparse escalation subset with
    padding rows and empty cells, and on the planted cross-cell tie."""
    args = _grid_case(case)
    want = vtopk.voronoi_cellgrid_topk_plain(*args)
    got = _grouped_emulation(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "tie":
        assert got[1][0, 0].tolist() == [2, 9, 5, -1]
    if case == "tier1":  # the wrapper picks this mapping here, and not on the subset
        assert vtopk._cellgrid_grouped(args[0].shape[1], 5, 96)
    if case == "escalation":
        assert not vtopk._cellgrid_grouped(args[0].shape[1], 6, 96)


def test_cellgrid_order_sorts_each_frame_by_cell():
    """`_cellgrid_order`: every row once, each frame's rows in a block of
    their own, sorted stably by cell (a long run of one cell, the bucket
    padding's copies, stays in row order)."""
    rs = np.random.RandomState(2)
    for F, R, n_side in ((1, 1, 3), (3, 200, 5), (2, 700, 10), (4, 64, 6)):
        cid = torch.as_tensor(rs.randint(0, min(8, n_side ** 3), size=(F, R)), dtype=torch.int32)
        cid[0, : R // 2] = cid[0, 0]
        order = vtopk._cellgrid_order(cid).long()
        assert order.dtype == torch.int64 and sorted(order.tolist()) == list(range(F * R))
        assert ((order // R).reshape(F, R) == torch.arange(F)[:, None]).all()
        keys = cid.reshape(-1)[order].reshape(F, R)
        assert (keys[:, 1:] >= keys[:, :-1]).all()
        runs = order.reshape(F, R)
        same = keys[:, 1:] == keys[:, :-1]
        assert (runs[:, 1:][same] > runs[:, :-1][same]).all()


def test_cellgrid_shared_memory_fits():
    """The grouped mapping is picked only where its dynamic shared memory
    fits one block (232,448 B) and its tags (lane << 16 | position) fit;
    the direct one needs none beyond its static buffers; every k the
    checks admit has its list size (32, 64, 128 or 256 keys)."""
    assert vtopk.SMEM_MAX == 232_448
    assert sorted(vtopk.SCAN_ORDER) == list(range(27)) and vtopk.SCAN_ORDER[0] == 13
    for cap in range(1, 600):
        picked = vtopk._cellgrid_grouped(10 ** 6, 5, cap)
        assert picked == (vtopk.grouped_smem(cap) <= vtopk.SMEM_MAX)
        if picked:
            assert 27 * cap <= 0xFFFF
    assert vtopk.grouped_smem(64) == 38_768 and vtopk._cellgrid_grouped(10 ** 6, 5, 422)
    assert not vtopk._cellgrid_grouped(10 ** 6, 5, 423)
    assert not vtopk._cellgrid_grouped(vtopk.GROUP_MIN * 8 ** 3 - 1, 10, 64)
    for k in range(1, vtopk.MAX_K + 1):
        vtopk._check_k(k)
