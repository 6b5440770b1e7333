"""The port's device Voronoi contacts (surface/voronoi_device.py
`voronoi_contacts_hybrid`, `voronoi_contacts_hybrid_frames`) against
waterorderlib_tpu.surface.voronoi_device, against the port's own volumes
frame batch, and against Qhull.

Tolerances, each with its reason:
- against the JAX package in float32: the same certified counts; atom_area
  and atom_vol within 1e-5 relative (the cells' band,
  tests/test_torch_voronoi_device.py); a contact entry is a face's area,
  whose rounding scales with its cell's area, so entries within 1e-5 of
  the larger of the two cells' areas, and wat_area (2 area minus a row sum
  of up to twice the area) within 1e-5 of 4 area;
- `rows=` against the full call: the JAX package's own test (the doubling
  quirk may flip on a sliver face when only one side was computed);
- against the volumes batch: certified counts per tier, vol and area equal
  (the same cells);
- against Qhull: float64 cells within 1e-6 relative, contact entries by
  the JAX package's host-parity rule (5e-2, or off by the quirk factor on
  at most 1% of the nonzero entries).
"""

import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.surface import voronoi_device as jvd
from waterorderlib_tpu_torch.surface import voronoi_device as tvd
from waterorderlib_tpu_torch.surface.voronoi import voronoi_contacts

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REL = 1e-5


def _water_points(n=500, jitter=0.6, seed=0):
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(seed)
    return (base + rs.normal(scale=jitter, size=base.shape)) % box_l, box_l


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


def _same_contacts(got, want, rows=None):
    """got, want: (contacts, atom_area, wat_area, atom_vol, n_cert) of the
    same cells; `rows`: the computed rows (None: all)."""
    assert got[4] == want[4]
    area = np.asarray(want[1][0], np.float64)
    assert _rel(got[1], want[1]) <= REL and _rel(got[3], want[3]) <= REL
    scale = np.maximum(area[:, None], area[None, :])
    assert np.all(np.abs(got[0] - want[0]) <= REL * scale)
    sel = np.arange(len(area)) if rows is None else rows
    assert np.all(np.abs(got[2][0, sel] - want[2][0, sel]) <= REL * 4 * area[sel])


def _host_rule(cd, ch):
    """The JAX package's contact parity rule against the host Qhull path
    (test_hybrid_contacts_parity_vs_host_f32)."""
    flip = np.abs(cd - ch) > 5e-2
    assert flip.sum() <= 0.01 * (ch > 0).sum()
    ratio = cd[flip] / np.maximum(ch[flip], 1e-12)
    assert np.all((np.abs(ratio - 2.0) < 0.05) | (np.abs(ratio - 0.5) < 0.02)
                  | (np.abs(ratio - 1.0) < 0.05))


def test_contacts_hybrid_matches_jax():
    """One frame, 300 liquid points, float32: the port's one-frame call (a
    frame batch of one) against the JAX function's per-call ladder."""
    pts, box_l = _water_points(300)
    pts = pts.astype(np.float32)
    want = tuple(np.asarray(x) if not isinstance(x, int) else x
                 for x in jvd.voronoi_contacts_hybrid(pts, box_l, 300))
    got = tvd.voronoi_contacts_hybrid(pts, box_l, 300, device="cpu")
    assert got[0].shape == (300, 300) and got[1].shape == (1, 300)
    _same_contacts(got, want)
    np.testing.assert_array_equal(got[0], got[0].T)


def test_contacts_rows_restriction_matches_full():
    """rows= computes only the requested cells; on them it matches the full
    call (the JAX package's test, on the port)."""
    pts, box_l = _water_points(300)
    pts = pts.astype(np.float32)
    sel = np.array([3, 50, 123, 222, 299])
    cf, aaf, waf, avf, _ = tvd.voronoi_contacts_hybrid(pts, box_l, 300, device="cpu")
    cr, aar, war, avr, n_r = tvd.voronoi_contacts_hybrid(pts, box_l, 300, rows=sel, device="cpu")
    assert n_r <= len(sel)
    d = np.abs(cr[sel] - cf[sel])
    mism = d > 1e-4
    if mism.any():
        ratio = cr[sel][mism] / np.maximum(cf[sel][mism], 1e-12)
        assert np.all((np.abs(ratio - 2.0) < 0.05) | (np.abs(ratio - 0.5) < 0.02))
        assert mism.sum() <= 3
    np.testing.assert_allclose(aar[0, sel], aaf[0, sel], rtol=1e-6)
    np.testing.assert_allclose(avr[0, sel], avf[0, sel], rtol=1e-6)
    np.testing.assert_allclose(war[0, sel], waf[0, sel], atol=1.0)
    others = np.setdiff1d(np.arange(300), sel)
    assert np.all(avr[0, others] == 0.0)


def _npt_frames():
    base, box0 = _water_points(500)
    scales = np.array([1.0, 0.97, 1.05])
    return np.stack([base * s for s in scales]).astype(np.float32), box0 * scales


def test_contacts_frames_match_jax():
    """3 NPT frames x 500 points, a row subset: the port's batched ladder
    against the JAX per-frame one, frame by frame."""
    pos, box_ls = _npt_frames()
    sel = np.arange(0, 500, 7)
    want = list(jvd.voronoi_contacts_hybrid_frames(pos, box_ls, 500, rows=sel))
    tvd.tier_stats.clear()
    got = list(tvd.voronoi_contacts_hybrid_frames(pos, box_ls, 500, rows=sel, device="cpu"))
    assert tvd.tier_stats[(32, 64)]["launches"] == 1  # one search launch for the batch
    assert len(got) == 3
    for g, w in zip(got, want):
        _same_contacts(g, tuple(np.asarray(x) if not isinstance(x, int) else x for x in w),
                       rows=sel)


def test_contacts_frames_cells_equal_volumes_batch():
    """rows=None: the contacts batch builds the volumes batch's cells: the
    same certified count at every tier, the same vol and area."""
    pos, box_ls = _npt_frames()
    tvd.tier_stats.clear()
    vb, ab, nb = tvd.voronoi_volumes_hybrid_frames(pos, box_ls, 500, device="cpu")
    vol_tiers = {k: v["certified"] for k, v in tvd.tier_stats.items() if k != "host"}
    tvd.tier_stats.clear()
    got = list(tvd.voronoi_contacts_hybrid_frames(pos, box_ls, 500, device="cpu"))
    con_tiers = {k: v["certified"] for k, v in tvd.tier_stats.items() if k != "host"}
    assert con_tiers == vol_tiers and len(vol_tiers) >= 2
    assert sum(g[4] for g in got) == nb
    np.testing.assert_array_equal(np.concatenate([g[3] for g in got]), vb)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), ab)


def test_forced_host_close():
    """A one-tier ladder leaves uncertified rows to the host close, from
    tier 1's candidates: the frame batch equals the per-frame call and the
    JAX function."""
    pos, box_ls = _npt_frames()
    one = ((32, 64),)
    tvd.tier_stats.clear()
    got = list(tvd.voronoi_contacts_hybrid_frames(pos[:2], box_ls[:2], 500, tiers=one,
                                                  device="cpu"))
    assert tvd.tier_stats["host"]["rows"] > 0
    for t in range(2):
        single = tvd.voronoi_contacts_hybrid(pos[t], float(box_ls[t]), 500, tiers=one,
                                             device="cpu")
        for a, b in zip(got[t][:4], single[:4]):
            np.testing.assert_array_equal(a, b)
        assert got[t][4] == single[4] < 500
    want = jvd.voronoi_contacts_hybrid(pos[0], float(box_ls[0]), 500, tiers=one)
    _same_contacts(got[0], tuple(np.asarray(x) if not isinstance(x, int) else x for x in want))


def test_pallas_contacts_on_cpu_against_clip_and_qhull():
    """cell_impl="pallas" (the fused kernel's plain version) against "clip"
    in float32, and in float64 against the host Qhull contacts."""
    pos, box_ls = _npt_frames()
    sel = np.arange(0, 500, 5)
    res = {}
    for impl in ("clip", "pallas"):
        tvd.tier_stats.clear()
        res[impl] = list(tvd.voronoi_contacts_hybrid_frames(
            pos[:2], box_ls[:2], 500, rows=sel, cell_impl=impl, device="cpu"))
        assert tvd.tier_stats[(32, 64)]["cells"] == impl
    for a, b in zip(res["pallas"], res["clip"]):
        _same_contacts(a, b, rows=sel)
    pts = pos[0].astype(np.float64)
    got = next(tvd.voronoi_contacts_hybrid_frames(pts[None], box_ls[:1], 500, rows=sel,
                                                  cell_impl="pallas", device="cpu"))
    ch, aah, wah, avh = voronoi_contacts(pts, float(box_ls[0]), 500)
    assert got[4] >= 0.95 * len(sel)
    assert _rel(got[1][0, sel], aah[0, sel]) <= 1e-6 and _rel(got[3][0, sel], avh[0, sel]) <= 1e-6
    _host_rule(got[0][sel], ch[sel])


def test_rows_form_equals_dense():
    """The drivers' rows form: the dense matrix's rows, and its wat_area
    there, exactly; the dense form is np.maximum(C, C.T)."""
    rs = np.random.RandomState(0)
    num, sel = 40, np.array([3, 7, 8, 20, 39])
    block = np.where(rs.uniform(size=(len(sel), num)) < 0.3, rs.uniform(size=(len(sel), num)), 0.0)
    vol, area = rs.uniform(20, 40, num), rs.uniform(40, 80, num)
    dense, aa, wa, av = tvd._contacts_result(block, sel, vol, area, num, dense=True)
    c = np.zeros((num, num))
    c[sel] = block
    np.testing.assert_array_equal(dense, np.maximum(c, c.T))
    rows, aa2, wat_rows, av2 = tvd._contacts_result(block, sel, vol, area, num, dense=False)
    np.testing.assert_array_equal(rows, dense[sel])
    np.testing.assert_array_equal(wat_rows, wa[0, sel])
    np.testing.assert_array_equal(aa, aa2)
    np.testing.assert_array_equal(av, av2)


def test_contacts_options_raise(monkeypatch):
    pts, box_l = _water_points(64)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        next(tvd.voronoi_contacts_hybrid_frames(pts[None], [box_l], 64, mesh=object(),
                                                device="cpu"))
    with pytest.raises(ValueError, match="cell_impl"):
        tvd.voronoi_contacts_hybrid(pts, box_l, 64, cell_impl="pallas_always", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tvd.voronoi_contacts_hybrid_frames(pts[None], [box_l], 64))
