"""The port's device Voronoi cells (surface/voronoi_device.py) against
waterorderlib_tpu.surface.voronoi_device, and against Qhull.

Tolerances, each with its reason:
- the clip builder fed the JAX package's own candidates
  (`interop.voronoi_candidates_from_jax`): vol, area and r_cell within
  1e-5 relative, face areas within 1e-5 of the cell's area (a face sums
  signed edge triangles, whose cancellation spreads the vertices'
  rounding over the face), face vertex counts and
  `ok_shape` equal but for listed flips (at most 1% of the rows): XLA's
  CPU backend contracts sums of products into fmas, the port does not, so
  the two round apart by an ulp or two and a certificate at its edge can
  flip;
- whole calls (search and cells): the same, plus `certified` flips listed
  and co-certified volumes within 1e-5 relative;
- certified float32 cells against Qhull in float64: 1.5e-3 relative (the
  JAX package's band, test_clip_certified_error_band); float64 on CPU:
  1e-6 relative (its f64 subprocess test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.surface import voronoi_device as jvd
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.surface import voronoi_device as tvd
from waterorderlib_tpu_torch.surface.voronoi import voronoi_volumes

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REL = 1e-5
F32_BAND = 1.5e-3
F64_BAND = 1e-6


def _water_points(n=500, jitter=0.6, seed=0):
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(seed)
    return (base + rs.normal(scale=jitter, size=base.shape)) % box_l, box_l


def _bcc_points(a=3.1, n=4, jitter=1e-3, seed=0):
    g = np.arange(n) * a
    corners = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([corners, corners + a / 2.0]) + a * 0.25
    box_l = n * a
    rs = np.random.RandomState(seed)
    return (pts + rs.normal(scale=jitter, size=pts.shape)) % box_l, box_l


def _flips(a, b, limit=0.01):
    """Rows where two boolean flags differ: listed, and at most `limit` of
    the rows."""
    rows = np.where(np.asarray(a) != np.asarray(b))[0]
    assert len(rows) <= limit * len(a), rows
    return rows


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


@pytest.mark.parametrize("fixture,k,k_search", [
    ("water500", 32, 64), ("uniform160", 32, 64), ("water300", 48, 96),
])
def test_clip_builder_on_jax_candidates(fixture, k, k_search):
    """`_cell_moments_clip` on the JAX package's candidate payload (the
    full-scan search of `_cells_blocked`) against its own clip builder."""
    if fixture == "uniform160":
        pts = np.random.RandomState(3).uniform(0, 11.0, (160, 3)).astype(np.float32)
        box_l = 11.0
    else:
        pts, box_l = _water_points(int(fixture[5:]))
        pts = pts.astype(np.float32)
    ext = jvd.mirror_points_device(jnp.asarray(pts), box_l)
    ref = jvd._cells_blocked(jnp.asarray(pts), ext, jnp.asarray([jvd._NO_PBC_BOX] * 3,
                             jnp.float32), k, k_search, 256, 1e-4, win=int(ext.shape[0]))
    rel_all = np.asarray(ext)[np.asarray(ref["nbr_idx"])] - pts[:, None, :]
    cand = interop.voronoi_candidates_from_jax(rel_all, ref["nbr_valid"], ref["nbr_idx"],
                                               ref["nbr_dist"], "cpu")
    out = tvd._clip_cells(cand.rel_all, cand.valid, k, 1e-4)
    flips = _flips(out["ok_shape"].numpy(), ref["ok_shape"])
    same = np.ones(len(pts), bool)
    same[flips] = False
    for key in ("vol", "area", "r_cell"):
        assert _rel(out[key].numpy()[same], np.asarray(ref[key])[same]) <= REL, key
    gap = np.abs(out["face_area"].numpy() - np.asarray(ref["face_area"])).max(1)
    assert np.all(gap[same] <= REL * np.asarray(ref["area"])[same])
    nv_rows = np.where((out["face_nverts"].numpy() != np.asarray(ref["face_nverts"])).any(1))[0]
    assert len(nv_rows) <= 0.01 * len(pts), nv_rows


def test_nanmedian_is_numpys():
    """`_nanmedian` is numpy's (jnp.nanmedian's) median: the midpoint of the
    two middle values for an even count, not torch.nanmedian's lower one."""
    rs = np.random.RandomState(0)
    x = rs.uniform(1.0, 30.0, (40, 64)).astype(np.float32)
    x[rs.uniform(size=x.shape) < 0.3] = np.nan
    x[0] = np.nan  # no number: NaN, as numpy gives
    x[1, 1:] = np.nan
    x[2, :2] = 4.0
    x[2, 2:] = np.nan  # an even count of equal values
    got = tvd._nanmedian(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got, want)
    assert (~np.isnan(x[3:])).sum(1).min() < 64 and np.isnan(got[0])
    even = (~np.isnan(x)).sum(1) % 2 == 0
    assert even[3:].any() and not np.array_equal(
        got[3:][even[3:]], torch.from_numpy(x[3:][even[3:]]).nanmedian(-1).values.numpy())


def test_bcc_truncated_octahedron_golden():
    """Interior BCC cells are certified truncated octahedra: volume a^3/2
    (5e-3 relative), 14 faces, 6 squares and 8 hexagons."""
    a = 3.1
    pts, box_l = _bcc_points(a=a)
    out = tvd.voronoi_cells_device(pts.astype(np.float32), box_l, len(pts), device="cpu")
    cert = out["certified"].numpy()
    vol = out["vol"].numpy()
    interior = np.minimum(pts, box_l - pts).min(axis=1) > a
    assert interior.sum() >= 8 and cert.sum() >= 0.9 * len(pts) and cert[interior].all()
    np.testing.assert_allclose(vol[interior], a**3 / 2.0, rtol=5e-3)
    nv = out["face_nverts"].numpy()
    assert np.all((nv[interior] > 0).sum(axis=1) == 14)
    assert np.all(np.sort(nv[interior], axis=1)[:, -14:].sum(axis=1) == 6 * 4 + 8 * 6)


def test_cubic_lattice_never_miscertified():
    """The simple-cubic lattice (every vertex degenerate): no cell is
    certified with a wrong volume at any tier, and the hybrid returns a^3
    and 6 a^2 (2e-2, the JAX test's bound)."""
    a, n = 3.0, 4
    g = np.arange(n) * a + a / 2.0
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    for k, ks in tvd.DEFAULT_TIERS[:3]:
        out = tvd.voronoi_cells_device(pts, n * a, len(pts), k=k, k_search=ks, device="cpu")
        cert = out["certified"].numpy()
        np.testing.assert_allclose(out["vol"].numpy()[cert], a**3, rtol=2e-2)
    vol, area, _ = tvd.voronoi_volumes_hybrid(pts, n * a, len(pts), device="cpu")
    np.testing.assert_allclose(vol, a**3, rtol=2e-2)
    np.testing.assert_allclose(area, 6 * a**2, rtol=2e-2)


@pytest.mark.parametrize("case", ["water500", "grid512", "pruned1024", "window500"])
def test_cells_device_matches_jax(case):
    """`voronoi_cells_device` against the JAX function: the full scan
    (water500), an explicit cell grid below the 3,072-point auto cut
    (grid512: n_side 5, cap 64), the pruned mirror set (pruned1024) and a
    forced z-window (window500, 1,280 lanes: a third of the rows go
    uncovered)."""
    n = {"grid512": 512, "pruned1024": 1024}.get(case, 500)
    pts, box_l = _water_points(n, seed=11 if case == "grid512" else 0)
    pts = pts.astype(np.float32)
    kw = {"grid512": dict(cg=(5, 64)), "pruned1024": dict(prune_mirrors=True),
          "window500": dict(win=1280)}.get(case, {})
    ref = jvd.voronoi_cells_device(pts, box_l, n, **kw)
    out = tvd.voronoi_cells_device(pts, box_l, n, device="cpu", **kw)
    assert ("prune_margin" in out) == ("prune_margin" in ref) == (case == "pruned1024")
    np.testing.assert_array_equal(out["win_covered"].numpy(), np.asarray(ref["win_covered"]))
    flips = _flips(out["certified"].numpy(), ref["certified"])
    both = out["certified"].numpy() & np.asarray(ref["certified"])
    assert both.sum() >= 0.5 * n
    for key in ("vol", "area"):
        assert _rel(out[key].numpy()[both], np.asarray(ref[key])[both]) <= REL, (key, flips)
    np.testing.assert_array_equal(out["nbr_idx"].numpy()[both], np.asarray(ref["nbr_idx"])[both])


def _tier_counts(monkeypatch):
    """Certified rows per (k, k_search) of the JAX ladder, recorded around
    its voronoi_cells_device."""
    counts = {}
    real = jvd.voronoi_cells_device

    def counting(*args, **kw):
        out = real(*args, **kw)
        key = (kw.get("k", 32), kw.get("k_search", 64))
        counts[key] = counts.get(key, 0) + int(np.asarray(out["certified"]).sum())
        return out

    monkeypatch.setattr(jvd, "voronoi_cells_device", counting)
    return counts


def test_hybrid_matches_jax_tier_by_tier(monkeypatch):
    """`voronoi_volumes_hybrid` on the 500-point liquid: the certified count
    of every tier of the ladder equals the JAX package's, and the volumes
    and areas agree within 1e-5 relative."""
    pts, box_l = _water_points(500)
    pts = pts.astype(np.float32)
    counts = _tier_counts(monkeypatch)
    vj, aj, nj = jvd.voronoi_volumes_hybrid(pts, box_l, 500)
    tvd.tier_stats.clear()
    vt, at, nt = tvd.voronoi_volumes_hybrid(pts, box_l, 500, device="cpu")
    port = {k: v["certified"] for k, v in tvd.tier_stats.items() if k != "host"}
    assert port == counts and nt == nj
    assert len(counts) >= 3  # the ladder ran past tier 2
    assert _rel(vt, vj) <= REL and _rel(at, aj) <= REL
    vh, ah = voronoi_volumes(pts.astype(np.float64), box_l, 500)
    assert _rel(vt, vh) <= F32_BAND and _rel(at, ah) <= F32_BAND


def test_hybrid_frames_npt_matches_jax():
    """`voronoi_volumes_hybrid_frames` on three frames whose boxes differ
    (NPT: the 300-point liquid scaled by 1, 0.97 and 1.05) against the JAX
    function: the same certified total, volumes and areas within 1e-5
    relative, each frame's volumes summing to its box (1e-3)."""
    base, box0 = _water_points(300)
    scales = np.array([1.0, 0.97, 1.05])
    pos = np.stack([base * s for s in scales]).astype(np.float32)
    box_ls = box0 * scales
    vj, aj, nj = jvd.voronoi_volumes_hybrid_frames(pos, box_ls, 300)
    vt, at, nt = tvd.voronoi_volumes_hybrid_frames(pos, box_ls, 300, device="cpu")
    assert nt == nj
    assert _rel(vt, vj) <= REL and _rel(at, aj) <= REL
    np.testing.assert_allclose(vt.sum(axis=1), box_ls**3, rtol=1e-3)


def test_hybrid_frames_matches_per_frame():
    """A batch of two frames gives what its frames give run one by one
    (one-frame batches): the same certified count, volumes and areas within
    1e-5 relative (the JAX package's test_hybrid_frames_matches_per_frame,
    on the port alone)."""
    base, box_l = _water_points(300, seed=4)
    rs = np.random.RandomState(5)
    pos = np.stack([(base + rs.normal(scale=0.1, size=base.shape)) % box_l
                    for _ in range(2)]).astype(np.float32)
    vb, ab, nb = tvd.voronoi_volumes_hybrid_frames(pos, np.full(2, box_l), 300, device="cpu")
    ref = [tvd.voronoi_volumes_hybrid(pos[t], box_l, 300, device="cpu") for t in range(2)]
    assert nb == sum(r[2] for r in ref)
    assert _rel(vb, np.stack([r[0] for r in ref])) <= REL
    assert _rel(ab, np.stack([r[1] for r in ref])) <= REL


@pytest.mark.parametrize("case", ["default500", "pruned2100", "one_tier500"])
def test_per_frame_is_a_batch_of_one(case):
    """`voronoi_volumes_hybrid(p, L, n)` is `voronoi_volumes_hybrid_frames(
    p[None], [L], n)` exactly: volumes, areas, the certified total and every
    tier's certified count, on the default ladder (the 2,100-point case on
    the pruned mirror set) and on a one-tier ladder, whose host close reads
    tier 1's candidates instead of searching for every row."""
    n = 2100 if case == "pruned2100" else 500
    pts, box_l = _water_points(n)
    pts = pts.astype(np.float32)
    kw = dict(tiers=((32, 64),)) if case == "one_tier500" else {}
    res, tiers = [], []
    for call in (lambda: tvd.voronoi_volumes_hybrid(pts, box_l, n, device="cpu", **kw),
                 lambda: tvd.voronoi_volumes_hybrid_frames(pts[None], [box_l], n, device="cpu",
                                                           **kw)):
        tvd.tier_stats.clear()
        res.append(call())
        tiers.append({key: dict(v) for key, v in tvd.tier_stats.items()})
    (v1, a1, n1), (vb, ab, nb) = res
    np.testing.assert_array_equal(v1, vb[0])
    np.testing.assert_array_equal(a1, ab[0])
    assert n1 == nb and tiers[0] == tiers[1]
    ladder = [key for key in tiers[0] if key != "host"]
    if case == "pruned2100":
        assert tvd._suggest_mirror_budget(n, box_l, 64) > 0
    if case == "one_tier500":
        host = tiers[0]["host"]
        assert ladder == [(32, 64)] and host["rows"] == n - n1
        assert host["full_search"] < host["rows"]
    else:
        assert len(ladder) >= 3


def test_f64_cpu_matches_qhull():
    """float64 on CPU tensors: tier-1 certified cells and the whole hybrid
    within 1e-6 relative of the port's Qhull copy."""
    pts, box_l = _water_points(500)
    vh, ah = voronoi_volumes(pts, box_l, 500)
    out = tvd.voronoi_cells_device(pts, box_l, 500, device="cpu")
    assert out["vol"].dtype == torch.float64
    cert = out["certified"].numpy()
    assert cert.sum() >= 0.75 * 500
    assert _rel(out["vol"].numpy()[cert], vh[cert]) <= F64_BAND
    assert _rel(out["area"].numpy()[cert], ah[cert]) <= F64_BAND
    vd, ad, nc = tvd.voronoi_volumes_hybrid(pts, box_l, 500, device="cpu")
    assert nc >= 0.95 * 500
    assert _rel(vd, vh) <= F64_BAND and _rel(ad, ah) <= F64_BAND


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_certified_error_band(seed):
    """Every cell certified at tier 1 in float32 lies within 1.5e-3 of Qhull
    in float64 (the JAX package's regression band, uniform random points)."""
    rs = np.random.RandomState(seed)
    n = 300
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    pts = rs.uniform(0, box_l, (n, 3))
    vh, _ = voronoi_volumes(pts, box_l, n)
    out = tvd.voronoi_cells_device(pts.astype(np.float32), box_l, n, device="cpu")
    cert = out["certified"].numpy() & np.isfinite(vh)
    assert cert.sum() > 100
    assert _rel(out["vol"].numpy()[cert], vh[cert]) < F32_BAND


def test_options_not_ported_raise():
    """Every cell_impl of the JAX package runs; an unknown one raises, and
    so do mesh= (not ported) and k_search < k."""
    pts, box_l = _water_points(64)
    for impl in ("pallas", "triple"):
        out = tvd.voronoi_cells_device(pts, box_l, 64, cell_impl=impl, device="cpu")
        assert out["vol"].shape == (64,)
    with pytest.raises(ValueError, match="cell_impl"):
        tvd.voronoi_cells_device(pts, box_l, 64, cell_impl="pallas_always", device="cpu")
    with pytest.raises(ValueError, match="cell_impl"):
        tvd.voronoi_volumes_hybrid(pts, box_l, 64, cell_impl="qhull", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        tvd.voronoi_volumes_hybrid_frames(pts[None], [box_l], 64, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        tvd.voronoi_cells_device(pts, box_l, 64, k=64, k_search=32, device="cpu")


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, box_l = _water_points(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvd.voronoi_cells_device(pts, box_l, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvd.voronoi_volumes_hybrid_frames(pts[None], [box_l], 64)
