"""Driver entries of the cells whose analysis a user's script sets up
around a public driver: the entry selects what the driver is given from
the topology, as such a script does, calls the driver, and adds no other
work.

`water_hb_clusters` is `getHBClusterStats` (orderParam_lib.py:158-237)
over the H-bond network of every water of the box, each water one
residue."""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu_torch.drivers.hbonds_driver import get_hb_cluster_stats


def water_hb_clusters(top, traj, **kw):
    """`get_hb_cluster_stats` over every water of `top`: each water's O an
    acceptor, and each O twice as a donor, once with each of its two H's
    (`Topology.get_hb_inds` on the water heavy atoms). `kw` goes to the
    driver (dist_cut, ang_cut, output_dir, device, ...)."""
    wat = top.get_wat_inds()[0]
    acc, don, donh = top.get_hb_inds(np.array([], int), wat)[0]
    return get_hb_cluster_stats(top, traj, acc, don, donh, **kw)
