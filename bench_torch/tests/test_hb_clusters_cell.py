"""The `spc4096_hbnet.clusters` cell's own pieces: its entry selects the
driver's indices from the topology it is given, its configuration states
the criterion its traffic passes, and its readers of the program's
recorded calls give each metric, or None where the program records no
such span or counter."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_torch.core import spec, waterbox
from bench_torch.entries import hb_network
from bench_torch.tests.test_program_trace import _call, _read, _span
from waterorderlib_tpu_torch.io.topology import Topology

CELL = "spc4096_hbnet.clusters"


@pytest.mark.parametrize("n_waters", [216, 343])
def test_entry_selects_every_water_of_the_topology(monkeypatch, n_waters):
    got = {}
    monkeypatch.setattr(hb_network, "get_hb_cluster_stats",
                        lambda top, traj, *inds, **kw: got.update(inds=inds, kw=kw))
    hb_network.water_hb_clusters(Topology(**waterbox.topology_arrays(n_waters)), None,
                                 dist_cut=3.5, device="cpu")
    acc, don, donh = got["inds"]
    oxy = 3 * np.arange(n_waters)
    np.testing.assert_array_equal(acc, oxy)
    np.testing.assert_array_equal(don, np.repeat(oxy, 2))
    np.testing.assert_array_equal(donh, np.stack([oxy + 1, oxy + 2], 1).reshape(-1))
    assert got["kw"] == {"dist_cut": 3.5, "device": "cpu"}


def test_configuration_states_the_traffics_criterion():
    cell = spec.cell(CELL)
    crit, kw = cell["config_spec"]["criterion"], cell["traffic_spec"]["kwargs"]
    assert (crit["dist_cut_A"], crit["ang_cut_deg"]) == (kw["dist_cut"], kw["ang_cut"])


def _cluster_call(frames, sweeps, matrix_ms, components_ms):
    def build(root):
        block = _span("dispatch:hb_cluster_block", root, 10.0, 90.0)
        return [block, _span("hb_clusters:matrix", block, 10.0, 60.0, device_ms=matrix_ms),
                _span("hb_clusters:components", block, 60.0, 90.0, device_ms=components_ms),
                _span("hb_clusters:matrix", block, 10.0, 11.0)]  # no events: left out

    return _call("call:get_hb_cluster_stats", build,
                 {"hb_clusters:frames": frames, "hb_clusters:sweeps": sweeps})


# metric -> value on the two calls below
EXPECTED = {
    "hb_matrix_ms": (40.0 + 20.0) / 2,
    "components_ms": (10.0 + 6.0) / 2,
    "cluster_sweeps": (100 + 150) / (2 + 3),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_recorded_calls(name):
    run = SimpleNamespace(program_calls=[_cluster_call(2, 100, 40.0, 10.0),
                                         _cluster_call(3, 150, 20.0, 6.0)])
    assert _read(name, run) == pytest.approx(EXPECTED[name])
    bare = SimpleNamespace(program_calls=[_call("call:hb_calc", lambda root: [])])
    assert _read(name, bare) is None


@pytest.mark.parametrize("name", sorted(EXPECTED) + ["roofline.hb_clusters"])
def test_new_metrics_are_read_in_the_new_cell_alone(name):
    m = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    assert m["workloads"] == [CELL] and m["layer"] == "hbonds" and m["moves"] == "frames_per_s"
