"""The port's `get_hb_cluster_stats` over every water of a box against the
benchmark's plain reference of the H-bond network's clusters
(`bench_torch/reference/hb_clusters.py`: float64, the angle by arccos,
components by union-find, not the program's label propagation), on the
CPU, at hbCalc's criterion (3.5 A, 120 degrees: a network spanning most
of the box) and at getHBClusterStats' own (3.0 A, 150 degrees: small
clusters); the reference's components on hand-made graphs; the dispatch's
spans and counters on a traced call; and the `spc4096_hbnet.clusters`
cell's check failing on a planted fault.

The box is the benchmark's generated one (`bench_torch/core/waterbox.py`)
at 343 waters, 4 frames.
"""

import types

import numpy as np
import pytest
import torch

from bench_torch.checks import hb_clusters as hbc_check
from bench_torch.core import faults, spec, waterbox
from bench_torch.entries.hb_network import water_hb_clusters
from bench_torch.reference.hb_clusters import bonded_pairs, clusters_frames, component_sizes
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.hbonds import clusters
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

N_WATERS, N_FRAMES, SEED = 343, 4, 2**31 + 24
CRITERIA = {"hbcalc": (3.5, 120.0), "own_defaults": (3.0, 150.0)}


def _box():
    cfg = dict(spec.config("spc4096_hbnet"), n_waters=N_WATERS)
    pos, box = waterbox.make_frames(cfg, N_FRAMES, SEED, "cpu")
    return pos.numpy(), np.full((N_FRAMES, 3), box, dtype=np.float32)


def _call(tmp_path, dist_cut, ang_cut):
    """get_hb_cluster_stats on the CPU through the cell's entry: (the
    check's call record, the dispatch's outputs)."""
    pos, boxes = _box()
    top = Topology(**waterbox.topology_arrays(N_WATERS))
    captured = []
    orig = clusters.hb_cluster_block

    def capture(*a, **k):
        out = orig(*a, **k)
        captured.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clusters, "hb_cluster_block", capture)
        result = water_hb_clusters(top, Trajectory(pos, boxes), dist_cut=dist_cut,
                                   ang_cut=ang_cut, output_dir=str(tmp_path), device="cpu")
    call = types.SimpleNamespace(
        captured=[hbc_check.capture(out) for out in captured], out_dir=str(tmp_path),
        result=result, kwargs={"dist_cut": dist_cut, "ang_cut": ang_cut},
        inputs=lambda: (torch.from_numpy(pos), torch.from_numpy(boxes)))
    return call, captured


@pytest.mark.parametrize("criterion", list(CRITERIA))
def test_clusters_equal_the_reference(tmp_path, criterion):
    call, captured = _call(tmp_path, *CRITERIA[criterion])
    prog = hbc_check.program_answers(call)
    ref = hbc_check.reference_answers(call, "float64")
    assert not ref["ambiguous"].any()  # no frame that float32 may fairly decide otherwise
    assert len(prog["sizes"]) == N_FRAMES
    for p, r in zip(prog["sizes"], ref["sizes"]):
        np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(prog["hist_printed"], ref["hist"])
    # the program's mean is a float32 quotient of whole numbers a frame
    # (n / clusters), averaged in float64: a relative 2**-24 at most
    assert prog["mean"] == pytest.approx(ref["mean"], rel=1e-7, abs=0)
    if criterion == "hbcalc":  # most waters in one cluster, many sweeps
        assert max(r[-1] for r in ref["sizes"]) > N_WATERS // 2
    else:
        assert max(r[-1] for r in ref["sizes"]) < 10
    limits = spec.cell("spc4096_hbnet.clusters")["limits"]
    got = hbc_check.compare(prog, ref)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


@pytest.mark.parametrize("pairs,sizes", [
    ([(0, 1), (1, 2), (2, 3)], [1, 1, 1, 1, 1, 1, 4]),          # a chain
    ([(0, 1), (1, 2), (2, 3), (3, 0)], [1, 1, 1, 1, 1, 1, 4]),  # a ring: the same set
    ([(4, 5), (5, 6), (6, 4), (1, 2), (2, 3), (3, 1)], [1, 1, 1, 1, 3, 3]),
    ([], [1] * 10),                                             # isolated
    ([(9, 0), (8, 9), (0, 8), (7, 7)], [1] * 6 + [1, 3]),       # unordered, a self pair
])
def test_reference_components_of_hand_made_graphs(pairs, sizes):
    got = component_sizes(10, np.array(pairs, dtype=np.int64).reshape(-1, 2))
    np.testing.assert_array_equal(got, sorted(sizes))


def _two_waters(d_oo):
    """Water 1's H1 points straight at water 0's O from `d_oo` A away:
    (pos (1, 6, 3) float64, box (1, 3))."""
    pos = torch.tensor([[[10.0, 10, 10], [10.6, 10.8, 10], [9.4, 10.8, 10],
                         [10.0 + d_oo, 10, 10], [9.0 + d_oo, 10, 10], [10.0 + d_oo, 11, 10]]],
                       dtype=torch.float64)
    return pos, torch.tensor([[30.0, 30.0, 30.0]], dtype=torch.float64)


@pytest.mark.parametrize("d_oo,sure,maybe", [(2.8, 1, 0), (3.5, 0, 1), (3.6, 0, 0)])
def test_reference_bonds_and_ambiguous_pairs(d_oo, sure, maybe):
    """A linear bond bonds surely inside the cut, is ambiguous at it, and
    is gone beyond it."""
    [(s, m)] = bonded_pairs(*_two_waters(d_oo), 3.5, 120.0)
    assert len(s) == sure and len(m) == maybe
    if sure:
        assert s.tolist() == [[0, 1]]  # acceptor water 0, donor water 1


def test_traced_call_records_the_dispatch(tmp_path):
    pos, boxes = _box()
    top = Topology(**waterbox.topology_arrays(N_WATERS))
    clock.recorded_calls()
    with clock.stage_times() as stages:
        water_hb_clusters(top, Trajectory(pos, boxes), dist_cut=3.5, ang_cut=120.0,
                          output_dir=str(tmp_path), device="cpu")
    [call] = clock.recorded_calls()
    assert call.root.name == "call:get_hb_cluster_stats"
    for name in ("hb_clusters:matrix", "hb_clusters:components", "dispatch:hb_cluster_block"):
        assert call.named(name), name
    assert {"kernel stage", "stats (device)", "D2H"} <= set(stages)
    assert call.counts["hb_clusters:frames"] == N_FRAMES
    assert call.counts["hb_clusters:sweeps"] >= 1
    sure = bonded_pairs(torch.from_numpy(pos), torch.from_numpy(boxes), 3.5, 120.0)
    want = sum(len({tuple(sorted(p)) for p in s.tolist()}) for s, _ in sure)
    assert call.counts["hb_clusters:edges"] == want > N_WATERS // 2


def test_sweeps_are_the_propagation_steps():
    """A chain of n vertices numbered from its far end takes n - 1 sweeps to
    carry label 0 along it, and one more that changes nothing."""
    n = 6
    adj = torch.zeros((1, n, n), dtype=torch.bool)
    for i in range(n - 1):
        adj[0, i, i + 1] = adj[0, i + 1, i] = True
    labels, sweeps = clusters._propagate(adj)
    assert labels.tolist() == [[0] * n] and sweeps == n


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
def test_planted_fault_fails_the_check(tmp_path, monkeypatch, fault):
    faults.plant(fault, hbc_check.FAULT_AT, monkeypatch.setattr)
    call, _ = _call(tmp_path, *CRITERIA["hbcalc"])
    got = hbc_check.compare(hbc_check.program_answers(call),
                            hbc_check.reference_answers(call, "float64"))
    limits = spec.cell("spc4096_hbnet.clusters")["limits"]
    assert got["sizes_out"] > 0 and any(got[k] > limits[k] for k in limits), got


def test_control_fails_the_check(tmp_path):
    """The reference on TF32-rounded coordinates, the precision below the
    configuration's float32, is not correct by the cell's limits."""
    call, _ = _call(tmp_path, *CRITERIA["hbcalc"])
    ref = hbc_check.reference_answers(call, "float64")
    got = hbc_check.compare(hbc_check.reference_answers(call, "tf32"), ref)
    limits = spec.cell("spc4096_hbnet.clusters")["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_reference_clusters_lie_between_lo_and_hi():
    """Each frame's clusters without and with its ambiguous pairs: the
    same waters, hi no finer than lo."""
    pos, boxes = _box()
    lo, hi = clusters_frames(torch.from_numpy(pos), torch.from_numpy(boxes), 3.5, 120.0)
    assert len(lo) == len(hi) == N_FRAMES
    assert all(int(a.sum()) == int(b.sum()) == N_WATERS and len(b) <= len(a)
               for a, b in zip(lo, hi))
