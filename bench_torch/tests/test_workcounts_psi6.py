"""The psi6 roofline's work count against a brute-force count, pair by
pair, on the chain ends of a 216-water box."""

import numpy as np

from bench_torch.core import spec
from bench_torch.core.roofline import DSQ_FLOPS
from bench_torch.reference.hex import ends
from bench_torch.tests.test_workcounts import _box, _dsq


def test_psi6_count():
    mod = spec.metric_reader("roofline.psi6")
    pos, boxes, box = _box()
    centers = ends(pos)
    n = centers.shape[1]
    flops, nbytes = mod.count(centers, boxes, 0.0, 7.0)
    want = pairs = 0
    hi2 = np.float32(7.0 * 7.0)
    for f in range(2):
        dsq = _dsq(centers[f].numpy(), box)
        for i in range(n):
            shell = sorted(dsq[i, j] for j in range(n) if 0.0 < dsq[i, j] <= hi2)
            kept = shell[:24]
            row_pairs = sum(1 for a in range(len(kept)) for b in range(a + 1, len(kept)))
            want += len(shell) * DSQ_FLOPS + len(kept) * mod.NORM_EPILOGUE
            want += row_pairs * mod.PAIR_EPILOGUE
            want += mod.ROW_EPILOGUE if len(shell) > 1 else 0
            pairs += row_pairs
    assert pairs > 100 * n  # most rows keep 24 neighbors at this density
    assert flops == want
    assert nbytes == 2 * (n * 20 + 12)
