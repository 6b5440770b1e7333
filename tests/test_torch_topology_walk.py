"""The port's `Topology.get_hb_inds` (array operations over the sorted bond
edges) against the JAX package's per-atom walk over `bond_partners()`: the
(acceptor, donor, donor-H) triplets of both the O and the N targets are
held equal in values, order and dtype."""

import numpy as np
import pytest

from bench_torch.core.waterbox import topology_arrays
from waterorderlib_tpu.io.topology import Topology as JTopology
from waterorderlib_tpu_torch.io.topology import Topology

NONE = np.array([], int)


def _top(names, bonds, res_names=None):
    n = len(names)
    return dict(names=np.array(names, dtype=object),
                elements=np.array([s[0] for s in names], dtype=object),
                res_names=np.array(res_names or ["MOL"] * n, dtype=object),
                res_ids=np.zeros(n, int), bonds=np.array(bonds, int).reshape(-1, 2))


def _water():
    arrays = topology_arrays(64)
    return arrays, NONE, np.arange(0, 192, 3)


def _cosolvent():
    # two waters, then a molecule with an O donor (O1-HO) and an N donor
    # with two hydrogens (N1-HN1, N1-HN2), a C-H and a bare N acceptor
    names = ["O", "H1", "H2", "O", "H1", "H2",
             "C1", "O1", "HO", "N1", "HN1", "HN2", "H3", "N2", "C2"]
    bonds = [[0, 1], [0, 2], [3, 4], [3, 5],
             [6, 7], [7, 8], [6, 9], [9, 10], [9, 11], [6, 12], [13, 14], [6, 14]]
    return _top(names, bonds), [9, 13], [0, 3, 7]


def _heavy_named_h():
    # the hydroxyl oxygen is named OH: "H" is in its name, so an N bonded
    # to it counts it as a donor hydrogen, as the reference's walk does;
    # its self-bond makes it its own donor hydrogen twice
    names = ["CA", "OH", "HH", "N", "H", "CB"]
    bonds = [[0, 1], [1, 2], [1, 3], [3, 4], [3, 5], [1, 1]]
    return _top(names, bonds), [3], [1]


def _messy_bonds():
    # bonds listed as (H, heavy), shuffled, one listed twice and one self-bond
    names = ["O", "H1", "H2", "N", "HN", "O", "H1", "H2", "C"]
    bonds = [[2, 0], [4, 3], [7, 5], [1, 0], [8, 3], [6, 5], [4, 3], [3, 3], [5, 8]]
    return _top(names, bonds), [3], [0, 5]


def _tip4p():
    # four-site waters: O, H1, H2 and a massless EP site bonded to the O
    names = ["O", "H1", "H2", "EPW"] * 3
    bonds = [[4 * i + k for k in (0, j)] for i in range(3) for j in (1, 2, 3)]
    return _top(names, bonds, ["WAT"] * 12), NONE, [0, 4, 8]


def _odd_targets():
    arrays, _, _ = _water()
    n = 192
    return arrays, [3, 3, -1, n, n + 7, -n], [9, 0, 9, 0, 6, 1000, -3]


def _empty_targets():
    arrays, _, _ = _water()
    return arrays, NONE, NONE


def _no_bonds():
    names = ["O", "H1", "H2", "N", "H"]
    return _top(names, np.zeros((0, 2), int)), [3], [0]


CASES = {
    "water64": _water,
    "cosolvent": _cosolvent,
    "heavy_named_h": _heavy_named_h,
    "messy_bonds": _messy_bonds,
    "tip4p_ep": _tip4p,
    "odd_targets": _odd_targets,
    "empty_targets": _empty_targets,
    "no_bonds": _no_bonds,
}


@pytest.mark.parametrize("case", list(CASES))
def test_get_hb_inds_matches_reference_walk(case):
    arrays, n_inds, o_inds = CASES[case]()
    got = Topology(**arrays).get_hb_inds(np.asarray(n_inds, int), np.asarray(o_inds, int))
    want = JTopology(**arrays).get_hb_inds(np.asarray(n_inds, int), np.asarray(o_inds, int))
    for g_set, w_set in zip(got, want):  # the O result, then the N result
        assert len(g_set) == len(w_set) == 3
        for g, w in zip(g_set, w_set):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if case == "heavy_named_h":
        np.testing.assert_array_equal(got[1][2], [1, 4])  # OH and H are the N's donor-Hs
