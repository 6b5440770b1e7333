"""The split tier's escalation (ops/cuda/lsi.py `lsi_certified` and
`_escalate`, the escalation form of `lsi_split_window`) against plain
references written from the definition of the LSI, on the CPU; and, on the
card, the escalation form's kernel against its plain version.

References: `bench_torch/reference/lsi.py` (plain float64 PyTorch; it
refuses rows with 24 or more neighbors within high_cut) and, for such rows,
`tests/reference/refimpl.py`'s float64 `lsi`. Both take the next-shell atom
of least raw distance among every candidate in (high, high + 3.7].

Every box plants overfull shells: atoms packed around a center so that it
holds more than the split kernel's 12 in-shell slots (then more than the
escalation's first rung of 32). The tier rule is forced to the split tier,
as `lsi_calc` takes it from ~8.4k waters on.

Tolerances: valid flags and counts exactly; LSI to TOL = 2e-5 A^2, the JAX
package's own bound between its kernels and its XLA path (float32 roots
and sums of the same gaps; the rows here agree to ~3e-7). A row given the
K = 24 pick where the definition's next-shell atom is its 25th candidate
moves by more than 1e-3 A^2, so it fails TOL by fifty times.
"""

import types

import numpy as np
import pytest
import torch

from bench_torch.checks import lsi as lsi_check
from bench_torch.core import waterbox
from bench_torch.reference.lsi import lsi_frames
from reference import refimpl
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import orderparams
from waterorderlib_tpu_torch.io.synthetic import water_oxygen_lattice
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory
from waterorderlib_tpu_torch.ops.cuda import lsi as tl
from waterorderlib_tpu_torch.ops.cuda import slab

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

T = torch.from_numpy
TOL = 2e-5  # A^2
HIGH, OUTER = 3.7, 7.4


def _box_len(n):
    return (n / 0.033456) ** (1.0 / 3.0)


def _mi(d, box_len):
    return d - box_len * np.round(d / box_len)


def _lattice(n, seed, rs):
    box_len = _box_len(n)
    p = np.mod(water_oxygen_lattice(n, box_len, seed=seed) + rs.normal(scale=0.1, size=(n, 3)),
               box_len)
    return p, box_len


def _pack(p, c, k, box_len, rs, r_lo=2.6, r_hi=3.5):
    """Move k atoms lying more than 12 A from atom c to distances in
    [r_lo, r_hi] around it: c's shell overfills."""
    dist = np.linalg.norm(_mi(p - p[c], box_len), axis=1)
    far = rs.choice(np.flatnonzero(dist > 12.0), size=k, replace=False)
    dirs = rs.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    p[far] = np.mod(p[c] + dirs * rs.uniform(r_lo, r_hi, size=(k, 1)), box_len)
    return far


def _planted_25th():
    """One frame of 1024 waters. The atom c nearest the box centre gets 8
    more atoms within 3.7 A (~14 in its shell: incomplete for the split
    kernel), and each next-shell candidate among its 24 nearest is stored
    shifted by +L in z, so the next-shell atom of least raw distance is its
    25th candidate by imaged distance. Returns (pos, boxes, c, the 25th)."""
    n = 1024
    rs = np.random.RandomState(11)
    p, box_len = _lattice(n, 11, rs)
    c = int(np.argmin(np.linalg.norm(p - box_len / 2, axis=1)))
    _pack(p, c, 8, box_len, rs)
    dist = np.linalg.norm(_mi(p - p[c], box_len), axis=1)
    dist[c] = np.inf
    order = np.argsort(dist, kind="stable")
    top24 = order[:24]
    assert int((dist[top24] <= HIGH).sum()) > tl.K_IN
    p[top24[dist[top24] > HIGH], 2] += box_len
    return p[None].astype(np.float32), np.float32([[box_len] * 3]), c, int(order[24])


def _assert_definition(got, pos, boxes):
    """Each frame of `got` (lsi, valid, count) equals refimpl's float64 LSI:
    valid and count exactly, the LSI to TOL."""
    for f in range(pos.shape[0]):
        x, b = pos[f].astype(np.float64), boxes[f].astype(np.float64)
        vals, valid, counts = refimpl.lsi(x, x, b, 0.0, HIGH)
        np.testing.assert_array_equal(got[1][f].numpy(), valid)
        np.testing.assert_array_equal(got[2][f].numpy(), counts)
        np.testing.assert_allclose(got[0][f].numpy()[valid], vals, rtol=0, atol=TOL)


def _forced(monkeypatch, pos, boxes):
    """lsi_certified on the split tier: its outputs and the escalation
    counters' increments (rows, last)."""
    monkeypatch.setattr(tl, "split_tier", lambda *a: True)
    before = (clock.total("lsi:escalation:rows"), clock.total("lsi:escalation:last"))
    got = tl.lsi_certified(T(pos), T(boxes))
    assert tl.last_tier == "slab-split"
    return got, (clock.total("lsi:escalation:rows") - before[0],
                 clock.total("lsi:escalation:last") - before[1])


def test_planted_25th_neighbor_row_gets_the_definitions_pick(monkeypatch):
    """The overfull row whose next-shell atom is its 25th candidate is
    redone by the escalation and equals the definition (both references);
    the K = 24 tier, which the dispatch takes without the forced rule, picks
    among the 24 nearest and misses the definition by more than 1e-3."""
    pos, boxes, c, _ = _planted_25th()
    k24 = tl.lsi_certified(T(pos), T(boxes))
    assert tl.last_tier == "brute"
    split_calls, window_calls = tl.lsi_split_window_plain.calls, tl.lsi_window_plain.calls
    got, (rows, last) = _forced(monkeypatch, pos, boxes)
    assert rows >= 1 and last == 0
    # the split launch and one escalation rung; no K = 24 kernel
    assert (tl.lsi_split_window_plain.calls, tl.lsi_window_plain.calls) == (split_calls + 2,
                                                                           window_calls)
    _assert_definition(got, pos, boxes)
    ref, valid, amb = lsi_frames(T(pos), T(boxes), 0.0, HIGH)
    assert bool(valid[0, c]) and not bool(amb[0, c])
    assert abs(float(got[0][0, c]) - float(ref[0, c])) <= TOL
    assert abs(float(k24[0][0, c]) - float(ref[0, c])) > 1e-3


def _frames_overfull(n_frames=3):
    """n_frames frames of 1024 waters, each with its own jitter (0.1 A) of
    one configuration that holds three overfull shells (8, 9 and 10 more
    atoms packed around three atoms), so that the frame-0 windows stay
    covered. Returns (pos, boxes, the three centers)."""
    n = 1024
    rs = np.random.RandomState(5)
    box_len = _box_len(n)
    base = water_oxygen_lattice(n, box_len, seed=5)
    centers = [int(c) for c in rs.choice(n, size=3, replace=False)]
    for c, k in zip(centers, (8, 9, 10)):
        _pack(base, c, k, box_len, rs)
    pos = np.stack([np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len)
                    for _ in range(n_frames)])
    return pos.astype(np.float32), np.tile(np.float32([box_len] * 3), (n_frames, 1)), centers


def test_overfull_rows_in_several_frames(monkeypatch):
    """Overfull rows in every frame are redone in one escalation launch;
    every row of every frame equals the bench's float64 reference where
    float32 cannot fairly decide otherwise."""
    pos, boxes, centers = _frames_overfull()
    got, (rows, last) = _forced(monkeypatch, pos, boxes)
    ref, valid, amb = lsi_frames(T(pos), T(boxes), 0.0, HIGH)
    for f, c in enumerate(centers):
        x = pos[f].astype(np.float64)
        in_shell = int((np.linalg.norm(_mi(x - x[c], boxes[f, 0]), axis=1) <= HIGH).sum()) - 1
        assert in_shell > tl.K_IN and bool(valid[f, c])
    assert rows >= len(centers) and last == 0
    keep = ~amb
    assert torch.equal(got[1][keep], valid[keep])
    gap = (got[0].double() - ref)[keep & valid].abs()
    assert float(gap.max()) <= TOL
    _assert_definition(got, pos, boxes)


def test_row_beyond_the_largest_rung(monkeypatch):
    """40 atoms packed within 3.6 A of one atom: it, and its packed
    neighbors, overfill even the first rung's 32 slots and take the last
    rung, whose slots are as many as the fullest of them holds; every row
    equals refimpl's float64 LSI (the bench reference refuses 24 or more)."""
    n = 1024
    rs = np.random.RandomState(13)
    p, box_len = _lattice(n, 13, rs)
    c = int(np.argmin(np.linalg.norm(p - box_len / 2, axis=1)))
    _pack(p, c, 40, box_len, rs, r_lo=1.0, r_hi=3.6)
    pos, boxes = p[None].astype(np.float32), np.float32([[box_len] * 3])
    got, (rows, last) = _forced(monkeypatch, pos, boxes)
    assert rows >= 1 and last >= 1
    assert int(got[2][0, c]) > tl.K_ESC
    _assert_definition(got, pos, boxes)


def test_escalation_form_equals_a_split_launch_with_as_many_slots():
    """The escalation form at k_in slots gives, on its listed pairs, what
    the plain split pass with k_in slots gives on the whole launch; a pair
    over k_in reads NaN, not valid, 0 and its full in-shell count."""
    pos, boxes, _ = _frames_overfull(2)
    pos, boxes = T(pos), T(boxes)
    n = pos.shape[1]
    w_wide, pad = slab.plan(n, float(boxes[0, 2]), OUTER, tl.ROW_TILE)
    w_narrow = slab.suggest_window(n, float(boxes[0, 2]), margin=HIGH, row_tile=tl.ROW_TILE)
    prep = slab.slab_prep_traj(pos, boxes, ((HIGH, w_narrow), (OUTER, w_wide)), tl.ROW_TILE, pad)
    raw = slab.raw_ext_t(pos, prep.order0, pad)
    args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes, prep.ws[0],
            tl.ROW_TILE, raw[:, :, pad : pad + n], raw, prep.starts[1], prep.ws[1], 0.0, HIGH,
            HIGH * HIGH, OUTER * OUTER)
    split = tl.lsi_split_window(*args)
    redo = torch.nonzero(split[3].reshape(-1)).squeeze(1)
    assert redo.numel() >= 2
    for k_in in (tl.K_ESC, 13):
        whole = tl.lsi_split_window_plain(*args, k_in=k_in)
        got = tl.lsi_split_window(*args, redo=redo, k_in=k_in)
        shell = got[3]
        assert bool((shell > tl.K_IN).all())
        fits = shell <= k_in
        for g, w in zip(got[:3], whole[:3]):
            w = w.reshape(-1)[redo]
            assert torch.equal(g[fits], w[fits])
        assert bool(torch.isnan(got[0][~fits]).all()) and not bool(got[1][~fits].any())
    # the split launch's own result where no slot overflows
    ok = ~split[3]
    whole = tl.lsi_split_window_plain(*args, k_in=tl.K_ESC)
    for g, w in zip(split[:3], whole[:3]):
        assert torch.equal(g[ok], w[ok])
    with pytest.raises(ValueError):
        tl.lsi_split_window(*args, k_in=tl.K_ESC)  # more slots only in the escalation form
    with pytest.raises(ValueError):
        tl.lsi_split_window(*args, redo=redo.to(torch.int32))


def _lsi_system(n_waters=1000, n_frames=4, seed=2**31 + 77):
    """The benchmark's generated box (bench_torch/core/waterbox.py) at 1000
    waters and its population (waters within 12 A of the centre), with an
    overfull shell planted around a population member: 9 waters from more
    than 12 A away moved, whole, to fixed offsets of 2.6-3.5 A from its
    oxygen in every frame."""
    from bench_torch.core import spec

    cfg = dict(spec.config("spc16384"), n_waters=n_waters)
    pos, box = waterbox.make_frames(cfg, n_frames, seed, "cpu")
    sub_inds = waterbox.shell_population(pos, box, 12.0)
    pos = pos.numpy().astype(np.float64)
    rs = np.random.RandomState(seed % 2**32)
    ox = pos[:, 0::3]
    c = int(sub_inds[0][0][rs.randint(len(sub_inds[0][0]))]) // 3
    dist = np.linalg.norm(_mi(ox[0] - ox[0, c], box), axis=1)
    far = rs.choice(np.flatnonzero(dist > 12.0), size=9, replace=False)
    dirs = rs.normal(size=(9, 3))
    off = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * rs.uniform(2.6, 3.5, size=(9, 1))
    for j, o in zip(far, off):
        pos[:, 3 * j : 3 * j + 3] += (ox[:, c] + o - ox[:, j])[:, None, :]
    boxes = np.full((n_frames, 3), box, dtype=np.float32)
    return pos.astype(np.float32), boxes, sub_inds, cfg


def test_lsi_calc_on_the_split_tier_passes_the_cells_check(monkeypatch, tmp_path):
    """lsi_calc through the driver, the tier forced to the split tier, on
    the benchmark's generated box at 1000 waters with planted overfull
    shells, passes the `spc16384.lsi` cell's own check (bench_torch/checks/
    lsi.py against the float64 reference, at the cell's limits): per-center
    LSI, the printed histograms and the population means."""
    from bench_torch.core import spec

    pos, boxes, sub_inds, cfg = _lsi_system()
    top = Topology(**waterbox.topology_arrays(cfg["n_waters"]))
    monkeypatch.setattr(tl, "split_tier", lambda *a: True)
    captured = []
    orig = tl.lsi_certified

    def capture(*a, **k):
        out = orig(*a, **k)
        captured.append(lsi_check.capture(out))
        return out

    monkeypatch.setattr(orderparams.lsi_kernel, "lsi_certified", capture)
    rows0 = clock.total("lsi:escalation:rows")
    result = orderparams.lsi_calc(top, Trajectory(pos, boxes), sub_inds=sub_inds, n_pops=1,
                                  output_dir=str(tmp_path), device="cpu")
    assert tl.last_tier == "slab-split"
    assert clock.total("lsi:escalation:rows") - rows0 >= pos.shape[0]
    call = types.SimpleNamespace(
        captured=captured, out_dir=str(tmp_path), result=result, kwargs={}, sub_inds=sub_inds,
        inputs=lambda: (T(pos), T(boxes)))
    got = lsi_check.compare(lsi_check.program_answers(call),
                            lsi_check.reference_answers(call, "float64"))
    limits = spec.cell("spc16384.lsi")["limits"]
    assert all(got[k] <= limits[k] for k in limits), (got, limits)
    assert got["lsi_gap"] <= TOL


@pytest.mark.chip
def test_escalation_kernel_equals_its_plain_version_on_the_card():
    """On the card: the escalation form (both rungs: shared slots and the
    scratch slots of the last rung) equals its plain version bit for bit on
    4 frames of a 16,384-water box with six overfull shells planted, two of
    them beyond 32, and
    `lsi_certified` on the card equals it on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the escalation kernel runs only on the card")
    n, n_frames = 16_384, 4
    box_len = _box_len(n)
    rs = np.random.RandomState(17)
    base = water_oxygen_lattice(n, box_len, seed=17)
    for c, k in zip(rs.choice(n, size=6, replace=False), (8, 10, 12, 14, 40, 48)):
        _pack(base, int(c), k, box_len, rs, r_lo=1.0, r_hi=3.6)
    frames = []
    for f in range(n_frames):
        p = np.mod(base + rs.normal(scale=0.1, size=base.shape), box_len)
        some = rs.uniform(size=n) < 1.0 / 3.0  # stored shifted by +/-L
        frames.append(p + rs.randint(-1, 2, size=(n, 3)) * some[:, None] * box_len)
    pos = torch.from_numpy(np.stack(frames).astype(np.float32))
    boxes = torch.from_numpy(np.tile(np.float32([box_len] * 3), (n_frames, 1)))
    assert tl.split_tier(n, box_len, HIGH)
    dev = torch.device("cuda")
    w_wide, pad = slab.plan(n, box_len, OUTER, tl.ROW_TILE)
    w_narrow = slab.suggest_window(n, box_len, margin=HIGH, row_tile=tl.ROW_TILE)
    prep = slab.slab_prep_traj(pos.to(dev), boxes.to(dev), ((HIGH, w_narrow), (OUTER, w_wide)),
                               tl.ROW_TILE, pad)
    assert all(bool(c.all()) for c in prep.covered)
    raw = slab.raw_ext_t(pos.to(dev), prep.order0, pad)
    args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes.to(dev),
            prep.ws[0], tl.ROW_TILE, raw[:, :, pad : pad + n], raw, prep.starts[1], prep.ws[1],
            0.0, HIGH, HIGH * HIGH, OUTER * OUTER)
    cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    incomplete = tl.lsi_split_window(*args)[3]
    redo = torch.nonzero(incomplete.reshape(-1)).squeeze(1)
    shell = tl.lsi_split_window(*args, redo=redo, k_in=tl.K_ESC)[3]
    assert bool((shell > tl.K_ESC).any()) and bool((shell <= tl.K_ESC).any())
    for k_in in (tl.K_IN, tl.K_ESC, int(shell.max())):
        got = tl.lsi_split_window(*args, redo=redo, k_in=k_in)
        want = tl.lsi_split_window_plain(*cpu_args, redo=redo.cpu(), k_in=k_in)
        bits = [g.cpu().view(torch.int32) if g.is_floating_point() else g.cpu() for g in got]
        wbits = [w.view(torch.int32) if w.is_floating_point() else w for w in want]
        for g, w in zip(bits, wbits):
            assert torch.equal(g, w), k_in
    on_card = tl.lsi_certified(pos.to(dev), boxes.to(dev))
    on_cpu = tl.lsi_certified(pos, boxes)
    assert tl.last_tier == "slab-split"
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)
