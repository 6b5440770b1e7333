"""The port's fused Voronoi cell kernel (ops/cuda/voronoi_cells.py, its plain
version on CPU tensors) against the JAX package's `voronoi_cells_pallas` in
interpret mode, and the port's triple builder against the JAX package's
`_cell_moments`.

Tolerances, as the JAX package's own tests set them
(tests/test_voronoi_device.py, the Pallas cell tests): `ok_shape` and
`extra_cut` equal on every row, face vertex counts equal where both are ok;
vol, area and r_cell within 1e-5 relative; face areas within 5e-5 Å² at (32,
64), and within 1e-5 of the cell's area at (40, 96), where larger faces
carry more of the rounding (the JAX wide-tier test checks volumes only).
The Pallas kernel sums faces with a matmul in no fixed order and the port in
slot order, so the two round apart. `dedup_mode="always"` is the clip
builder itself: equal bit for bit. The triple builder: the port's clip-
builder tolerances (tests/test_torch_voronoi_device.py): flags equal but
for listed flips (at most 1% of rows), vol, area and r_cell within 1e-5.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterorderlib_tpu.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu.ops import pairs as ops_pairs
from waterorderlib_tpu.ops.pallas import voronoi_cells as jcells
from waterorderlib_tpu.surface import voronoi_device as jvd
from waterorderlib_tpu_torch import interop
from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vc
from waterorderlib_tpu_torch.surface import voronoi_device as tvd
from waterorderlib_tpu_torch.utils import logging as tlog

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REL = 1e-5


def _water_points(n=500, jitter=0.6, seed=0):
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    base = np.asarray(water_oxygen_lattice(n, box_l, seed=1), float)
    rs = np.random.RandomState(seed)
    return (base + rs.normal(scale=jitter, size=base.shape)) % box_l, box_l


def _cubic(a=3.0, ng=6):
    g = np.arange(ng) * a + a / 2.0
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3), ng * a


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


def _kernel_inputs(pts, box_l, k=32, ks=64):
    """The JAX tests' kernel inputs: the full-scan search's candidates,
    parked, and the boundary flag. Returns numpy (rel_all, rel_parked,
    valid, is_boundary, d_far)."""
    pts = jnp.asarray(pts, jnp.float32)
    ext = jvd.mirror_points_device(pts, box_l)
    box = jnp.asarray([jvd._NO_PBC_BOX] * 3, jnp.float32)
    nl = ops_pairs.topk_neighbors(pts, ext, box, k=ks, low_cut=0.0, high_cut=jnp.inf,
                                  row_block=64)
    rel_all = ext[nl.idx] - pts[:, None, :]
    park = jnp.asarray(jvd._park_directions(ks), jnp.float32) * jnp.float32(jvd._FAR)
    rel_parked = jnp.where(nl.valid[..., None], rel_all, park)
    is_b = jnp.any(nl.idx[:, :k] >= pts.shape[0], axis=1)
    return tuple(np.asarray(x) for x in (rel_all, rel_parked, nl.valid, is_b, nl.dist[:, -1]))


_CASES = {"water160": (lambda: _water_points(160), 32, 64),
          "cubic216": (_cubic, 32, 64),
          "water120": (lambda: _water_points(120, seed=2), 40, 96)}


@pytest.mark.parametrize("case", list(_CASES))
def test_fused_plain_matches_pallas_interpret(case):
    """The plain fused version against `voronoi_cells_pallas(...,
    interpret=True)` on the JAX tests' fixtures. On the 6^3 cubic lattice
    the tangency test must fire on interior rows (no boundary flag) and
    every cell certify at a^3."""
    make, k, ks = _CASES[case]
    pts, box_l = make()
    _, rel_parked, valid, is_b, d_far = _kernel_inputs(pts, box_l, k, ks)
    ref = {key: np.asarray(v) for key, v in jcells.voronoi_cells_pallas(
        jnp.asarray(rel_parked), jnp.asarray(valid), jnp.asarray(is_b), k, 1e-4,
        interpret=True).items()}
    args = interop.voronoi_cells_inputs_from_jax(rel_parked, valid, is_b, "cpu")
    before = vc.voronoi_cells_fused_plain.calls
    out = {key: v.numpy() for key, v in vc.voronoi_cells_fused(*args, k, 1e-4).items()}
    assert vc.voronoi_cells_fused_plain.calls == before + 1
    np.testing.assert_array_equal(out["ok_shape"], ref["ok_shape"])
    np.testing.assert_array_equal(out["extra_cut"], ref["extra_cut"])
    both = out["ok_shape"] & ref["ok_shape"]
    assert both.sum() >= 0.5 * len(pts)
    for key in ("vol", "area", "r_cell"):
        assert _rel(out[key][both], ref[key][both]) <= REL, key
    np.testing.assert_array_equal(out["face_nverts"][both], ref["face_nverts"][both])
    gap = np.abs(out["face_area"][both] - ref["face_area"][both]).max(1)
    if k == 32:
        assert gap.max() <= 5e-5
    else:
        assert np.all(gap <= REL * ref["area"][both])
    if case == "cubic216":
        a = 3.0
        assert int((~is_b).sum()) >= 8  # the rows without the boundary flag
        cert = out["ok_shape"] & (d_far >= 2.0 * out["r_cell"])
        assert cert.sum() == len(pts)
        np.testing.assert_allclose(out["vol"], a**3, rtol=1e-2)


def test_always_is_the_clip_builder_and_auto_skips_dedup():
    """dedup_mode="always" equals the clip builder exactly; "auto" equals it
    on the rows it dedups (boundary or tangent) and on the 160-point liquid
    leaves some interior rows undeduped with the same moments."""
    pts, box_l = _water_points(160)
    _, rel_parked, valid, is_b, _ = _kernel_inputs(pts, box_l)
    rel, ok, flag = interop.voronoi_cells_inputs_from_jax(rel_parked, valid, is_b, "cpu")
    clip = tvd._clip_cells(rel, ok, 32, 1e-4)
    always = vc.voronoi_cells_fused(rel, ok, flag, 32, 1e-4, dedup_mode="always")
    for key in clip:
        assert torch.equal(always[key], clip[key]), key
    auto = vc.voronoi_cells_fused(rel, ok, flag, 32, 1e-4)
    assert (~flag).sum() > 0
    for key in ("vol", "area"):
        assert torch.equal(auto[key][flag], clip[key][flag]), key
        assert _rel(auto[key].numpy(), clip[key].numpy()) <= REL, key
    # with no boundary flag anywhere, the tangency test alone decides
    none = vc.voronoi_cells_fused(rel, ok, torch.zeros_like(flag), 32, 1e-4)
    np.testing.assert_array_equal(none["ok_shape"].numpy(), auto["ok_shape"].numpy())


def test_fits_voronoi_cells_is_jaxs():
    """The copied fit predicate equals the JAX package's over a sweep."""
    for k in range(2, 66, 3):
        for ks in range(k, 140, 7):
            assert vc.fits_voronoi_cells(k, ks) == jcells.fits_voronoi_cells(k, ks), (k, ks)
    assert vc.fits_voronoi_cells(32, 64) and vc.fits_voronoi_cells(40, 96)
    assert not vc.fits_voronoi_cells(48, 96) and not vc.fits_voronoi_cells(32, 130)


def test_input_checks(monkeypatch):
    """Wrong dtypes, shapes, sizes and modes raise; so does a CUDA device
    without a GPU, on the wrapper's route through the hybrid."""
    rel = torch.zeros((4, 64, 3))
    valid = torch.ones((4, 64), dtype=torch.bool)
    flag = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        vc.voronoi_cells_fused(rel.half(), valid, flag, 32, 1e-4)
    with pytest.raises(TypeError):
        vc.voronoi_cells_fused(rel.int(), valid, flag, 32, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(rel[..., :2].contiguous(), valid, flag, 32, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(rel, valid[:, :32], flag, 32, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(rel, valid, flag.int(), 32, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(rel, valid, flag, 65, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(torch.zeros((4, 130, 3)), torch.ones((4, 130), dtype=torch.bool),
                               flag, 32, 1e-4)
    with pytest.raises(ValueError):
        vc.voronoi_cells_fused(rel, valid, flag, 32, 1e-4, dedup_mode="never")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        vc.voronoi_cells_fused(rel.to("meta"), valid.to("meta"), flag.to("meta"), 32, 1e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, box_l = _water_points(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvd.voronoi_volumes_hybrid(pts, box_l, 64, cell_impl="pallas")


def test_pallas_serves_the_fitting_tiers():
    """cell_impl="pallas" builds with the fused kernel's plain version at the
    tiers `fits_voronoi_cells` admits (tier 1 of both ladders) and with the
    clip builder elsewhere; volumes within 1e-5 of cell_impl="clip". On CPU
    "clip" never calls the kernel's plain version, and no tier counts rows
    built on the CUDA kernel (`kernel_rows`)."""
    pts, box_l = _water_points(300, seed=3)
    pts = pts.astype(np.float32)
    res = {}
    for impl in ("clip", "pallas"):
        tvd.tier_stats.clear()
        before = vc.voronoi_cells_fused_plain.calls
        res[impl] = tvd.voronoi_volumes_hybrid(pts, box_l, 300, cell_impl=impl, device="cpu")
        cells = {key: v["cells"] for key, v in tvd.tier_stats.items() if key != "host"}
        assert all(v["kernel_rows"] == 0 for key, v in tvd.tier_stats.items() if key != "host")
        calls = vc.voronoi_cells_fused_plain.calls - before
        if impl == "pallas":
            assert cells[(32, 64)] == "pallas" and calls == 1
            assert all(v == "clip" for key, v in cells.items() if key != (32, 64))
            assert len(cells) >= 2
        else:
            assert set(cells.values()) == {"clip"} and calls == 0
    assert _rel(res["pallas"][0], res["clip"][0]) <= REL
    assert _rel(res["pallas"][1], res["clip"][1]) <= REL
    assert tvd._tier_impl("pallas", 40, 96) == "pallas"
    assert tvd._tier_impl("pallas", 48, 96) == "clip"


@pytest.mark.parametrize("seed", [4, 5])
def test_triple_builder_matches_jax(seed):
    """The port's triple builder on the JAX package's candidates against its
    vmapped `_cell_moments` (the clip-vs-triple test's builder), on 160
    liquid points."""
    import jax

    pts, box_l = _water_points(160, seed=seed)
    rel_all, _, valid, _, _ = _kernel_inputs(pts, box_l)
    ref = jax.vmap(lambda r, o: jvd._cell_moments(r, o, 32, 1e-4))(
        jnp.asarray(rel_all), jnp.asarray(valid))
    ref = {key: np.asarray(v) for key, v in ref.items()}
    out = tvd._clip_cells(torch.tensor(rel_all), torch.tensor(valid), 32, 1e-4,
                          builder=tvd._cell_moments_triple)
    out = {key: v.numpy() for key, v in out.items()}
    flips = np.where(out["ok_shape"] != ref["ok_shape"])[0]
    assert len(flips) <= 0.01 * len(pts), flips
    both = out["ok_shape"] & ref["ok_shape"]
    assert both.sum() >= 0.5 * len(pts)
    for key in ("vol", "area", "r_cell"):
        assert _rel(out[key][both], ref[key][both]) <= REL, key
    np.testing.assert_array_equal(out["face_nverts"][both], ref["face_nverts"][both])


def test_triple_hybrid_and_warning_once(caplog):
    """cell_impl="triple" runs through the hybrid on its three tiers
    (k <= 64) and warns once per process; its certified volumes agree with
    the clip builder's within the JAX package's 2e-4 (the two builders'
    certificates differ)."""
    tlog._LOGGED_ONCE.discard(("voronoi_triple_bound",))
    pts, box_l = _water_points(100, seed=6)
    pts = pts.astype(np.float32)
    with caplog.at_level("WARNING", logger="waterorderlib_tpu_torch"):
        tvd.tier_stats.clear()
        vt, at, nt = tvd.voronoi_volumes_hybrid(pts, box_l, 100, cell_impl="triple",
                                                device="cpu")
        assert all(key == "host" or key[0] <= 64 for key in tvd.tier_stats)
        tvd.voronoi_cells_device(pts, box_l, 100, cell_impl="triple", device="cpu")
    warned = [r for r in caplog.records if "cell_impl='triple'" in r.getMessage()]
    assert len(warned) == 1
    vc_, ac_, _ = tvd.voronoi_volumes_hybrid(pts, box_l, 100, device="cpu")
    np.testing.assert_allclose(vt, vc_, rtol=2e-4)
    np.testing.assert_allclose(at, ac_, rtol=2e-4)
    assert tvd._tiers_for("triple", tvd.DEFAULT_TIERS) == tvd.DEFAULT_TIERS[:3]


def test_pair_table_is_pair_tables():
    """The kernel's pair table (i | j << 8 a pair) lists `_pair_tables(k)`'s
    pairs in its order, the port's and the JAX package's, for k = 2..64; the
    kernel's closed form for face f's slot e (the other plane e, or e + 1
    from e = f on; the pair id i (2k - i - 1) / 2 + j - i - 1) gives its
    face_pairs and face_other."""
    for k in range(2, vc.MAX_K + 1):
        prs, face_pairs, face_other = tvd._pair_tables(k)
        np.testing.assert_array_equal(prs, np.asarray(jvd._pair_tables(k)[0]))
        tbl = vc.pair_table(k)
        assert tbl.dtype == np.int32 and tbl.shape == (k * (k - 1) // 2,)
        np.testing.assert_array_equal(np.stack([tbl & 0xFF, tbl >> 8], 1), prs)
        for f in range(k):
            for e in range(k - 1):
                o = e if e < f else e + 1
                i, j = min(f, o), max(f, o)
                assert face_other[f, e] == o
                assert face_pairs[f, e] == i * (2 * k - i - 1) // 2 + j - i - 1


def test_shared_memory_fits_every_accepted_shape():
    """The dynamic shared memory the wrapper asks for, rows_per_block(k, ks)
    rows of row_bytes(k, ks), stays within one block's 232,448 B for every
    (k, ks) the checks accept (k = 2..64, ks = k..128); (32, 64) takes
    13,504 B a row, one row a block (16 an SM), as does (40, 96) (10 an SM)
    and (64, 128), the largest row, 51,712 B (4 an SM)."""
    assert vc.SMEM_MAX == 232_448
    for k in range(2, vc.MAX_K + 1):
        for ks in range(k, vc.MAX_KS + 1):
            r = vc.rows_per_block(k, ks)
            assert r in (1, 2, 4) and r * vc.row_bytes(k, ks) <= vc.SMEM_MAX, (k, ks)
            assert vc.row_bytes(k, ks) % 16 == 0
    assert vc.row_bytes(32, 64) == 13_504 and vc.rows_per_block(32, 64) == 1
    assert vc.rows_per_block(40, 96) == 1
    assert vc.MAX_K == 64
    assert vc.row_bytes(64, 128) == 51_712 and vc.rows_per_block(64, 128) == 1


@pytest.mark.parametrize("k,ks,dev,dtype,want", [
    (32, 64, "cuda", torch.float32, True),
    (40, 96, "cuda", torch.float32, True),
    (48, 96, "cuda", torch.float32, True),
    (64, 128, "cuda", torch.float32, True),
    (96, 192, "cuda", torch.float32, False),
    (128, 256, "cuda", torch.float32, False),
    (32, 64, "cuda", torch.float64, False),
    (64, 128, "cuda", torch.float64, False),
    (32, 64, "cpu", torch.float32, False),
    (64, 128, "cpu", torch.float32, False),
])
def test_clip_on_kernel_rule(k, ks, dev, dtype, want):
    """The clip builder's rows go to the cell kernel in dedup mode "always"
    exactly where they are CUDA float32 and the tier fits the kernel (every
    tier of both ladders up to (64, 128)); "pallas" keeps its "auto" rule
    and "triple" its PyTorch builder on every device."""
    assert tvd._clip_on_kernel(dev, dtype, k, ks) is want
    rows = SimpleNamespace(device=torch.device(dev), dtype=dtype, shape=(0, ks, 3))
    assert tvd._cell_kernel_mode("clip", rows, k) == ("always" if want else None)
    assert tvd._cell_kernel_mode("pallas", rows, k) == "auto"
    assert tvd._cell_kernel_mode("triple", rows, k) is None


def test_always_at_64_is_the_clip_builder():
    """At the widest tier the kernel now holds, (64, 128), on 160 liquid
    points: the wrapper admits k = 64 and, in dedup mode "always", returns
    the port's clip builder key by key (on CPU tensors it runs that builder,
    so this part checks the wrapper's bound and routing); and the port's
    clip arithmetic at (64, 128) against the JAX package's vmapped
    `_cell_moments_clip` on the same candidates, at the triple builder's
    tolerances above (flags equal but for at most 1% of rows; vol, area and
    r_cell within 1e-5; face vertex counts equal and face areas within 1e-5
    of the cell's area where both are ok)."""
    import jax

    pts, box_l = _water_points(160, seed=7)
    rel_all, rel_parked, valid, is_b, _ = _kernel_inputs(pts, box_l, 64, 128)
    rel, ok, flag = interop.voronoi_cells_inputs_from_jax(rel_parked, valid, is_b, "cpu")
    clip = tvd._clip_cells(rel, ok, 64, 1e-4)
    always = vc.voronoi_cells_fused(rel, ok, flag, 64, 1e-4, dedup_mode="always")
    assert set(always) == set(clip)
    for key in clip:
        assert torch.equal(always[key], clip[key]), key
    out = {key: v.numpy() for key, v in always.items()}
    ref = jax.vmap(lambda r, o: jvd._cell_moments_clip(r, o, 64, 1e-4))(
        jnp.asarray(rel_all), jnp.asarray(valid))
    ref = {key: np.asarray(v) for key, v in ref.items()}
    flips = np.where(out["ok_shape"] != ref["ok_shape"])[0]
    assert len(flips) <= 0.01 * len(pts), flips
    both = out["ok_shape"] & ref["ok_shape"]
    assert both.sum() >= 0.5 * len(pts)
    for key in ("vol", "area", "r_cell"):
        assert _rel(out[key][both], ref[key][both]) <= REL, key
    np.testing.assert_array_equal(out["face_nverts"][both], ref["face_nverts"][both])
    gap = np.abs(out["face_area"][both] - ref["face_area"][both]).max(1)
    assert np.all(gap <= REL * ref["area"][both])


@pytest.mark.parametrize("entry", ["volumes", "contacts"])
def test_clip_routed_through_the_cell_kernel_is_bit_identical(monkeypatch, entry):
    """The clip builder's route through `voronoi_cells_fused` (its inputs
    parked by `_fused_inputs`, escalation subsets without their bucket
    padding), forced on CPU tensors where the wrapper runs its plain
    version: every result equal to the PyTorch builder's to the bit, with
    the same tiers, rows and certified counts, the `cells` labels "clip",
    and one plain call at each tier up to (64, 128)."""
    pts, box_l = _water_points(300, seed=3)
    pts = pts.astype(np.float32)
    sel = np.arange(0, 300, 7)

    def call():
        tvd.tier_stats.clear()
        if entry == "volumes":
            out = tvd.voronoi_volumes_hybrid(pts, box_l, 300, device="cpu")
        else:
            out = tvd.voronoi_contacts_hybrid(pts, box_l, 300, rows=sel, device="cpu")
        return out, {key: dict(v) for key, v in tvd.tier_stats.items()}

    ref, ref_tiers = call()
    monkeypatch.setattr(tvd, "_clip_on_kernel", lambda dev, dtype, k, ks: k <= vc.MAX_K)
    before = vc.voronoi_cells_fused_plain.calls
    got, tiers = call()
    assert tiers == ref_tiers
    ladder = [key for key in tiers if key != "host"]
    assert all(tiers[key]["cells"] == "clip" for key in ladder)
    assert vc.voronoi_cells_fused_plain.calls - before == sum(key[0] <= 64 for key in ladder)
    assert len(ladder) >= 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
