"""The H-bond cluster roofline's work count against a brute-force count,
pair by pair, on a 216-water box."""

import numpy as np

from bench_torch.core import spec
from bench_torch.core.roofline import DSQ_FLOPS
from bench_torch.tests.test_workcounts import _box, _dsq


def test_hb_clusters_count():
    mod = spec.metric_reader("roofline.hb_clusters")
    pos, boxes, box = _box()
    n = pos.shape[1] // 3
    flops, nbytes = mod.count(pos, boxes, 3.5)
    within = 0
    cut2 = np.float32(3.5 * 3.5)
    for f in range(2):
        dsq = _dsq(pos[f, 0::3].numpy(), box)
        within += sum(1 for i in range(n) for j in range(n) if 1e-2 < dsq[i, j] <= cut2)
    assert within > 2 * n  # several bonded neighbours a water at this density
    assert flops == (within * DSQ_FLOPS + 2 * within * mod.ANGLE_FLOPS
                     + 2 * 2 * n * mod.UNIT_FLOPS)
    # the atoms read once, the adjacency written and read once, the sizes written once
    assert nbytes == 2 * (3 * n * 12 + 2 * n * n + 4 * n + 12)
