"""Each roofline's work count against a brute-force count, pair by pair,
on a 216-water box."""

import math

import numpy as np
import torch

from bench_torch.core import spec, waterbox
from bench_torch.core.roofline import DSQ_FLOPS


def _box(frames=2, n=216, seed=5):
    cfg = dict(spec.config("spc4096"))
    cfg["n_waters"] = n
    pos, box = waterbox.make_frames(cfg, frames, seed, "cpu")
    boxes = torch.full((frames, 3), box, dtype=torch.float32)
    return pos, boxes, box


def _dsq(x, box):
    """All pairs' squared minimum-image distances, pair by pair, float32 as
    the counts take them."""
    n = len(x)
    out = np.zeros((n, n), dtype=np.float32)
    b = np.float32(box)
    for i in range(n):
        for j in range(n):
            d = x[j] - x[i]
            d = d - b * np.round(d / b)
            out[i, j] = np.float32(np.sum(d * d, dtype=np.float32))
    return out


def test_q_count():
    mod = spec.metric_reader("roofline.q")
    pos, boxes, box = _box()
    flops, nbytes = mod.count(pos[:, 0::3], boxes, 0.0, 10.0)
    want = 0
    for f in range(2):
        dsq = _dsq(pos[f, 0::3].numpy(), box)
        for i in range(216):
            c = sum(1 for j in range(216) if j != i and 0.0 < dsq[i, j] <= 100.0)
            want += min(4, c) * DSQ_FLOPS + (mod.Q_EPILOGUE if c else 0)
    assert flops == want
    assert nbytes == 2 * (216 * 16 + 12)


def test_lsi_count():
    mod = spec.metric_reader("roofline.lsi_split")
    pos, boxes, box = _box()
    flops, nbytes = mod.count(pos[:, 0::3], boxes, 0.0, 3.7)
    want = 0
    hi2, out2 = np.float32(3.7 * 3.7), np.float32(7.4 * 7.4)
    for f in range(2):
        dsq = _dsq(pos[f, 0::3].numpy(), box)
        for i in range(216):
            near = sum(1 for j in range(216) if 0.0 < dsq[i, j] <= hi2)
            nxt = sum(1 for j in range(216) if hi2 < dsq[i, j] <= out2)
            want += (near + 2 * nxt) * DSQ_FLOPS
            if near > 1 and nxt > 0:
                want += near * mod.LSI_EPILOGUE
    assert flops == want
    assert nbytes == 2 * (216 * 21 + 12)


def test_angles_count():
    mod = spec.metric_reader("roofline.angles")
    pos, boxes, box = _box()
    flops, nbytes = mod.count(pos[:, 0::3], boxes, 0.0, 3.413)
    want = pairs = 0
    hi2 = np.float32(3.413 * 3.413)
    for f in range(2):
        dsq = _dsq(pos[f, 0::3].numpy(), box)
        for i in range(216):
            shell = sorted(dsq[i, j] for j in range(216) if 0.0 < dsq[i, j] <= hi2)
            kept = shell[:16]
            row_pairs = sum(1 for a in range(len(kept)) for b in range(a + 1, len(kept)))
            want += len(shell) * DSQ_FLOPS + len(kept) * mod.NORM_EPILOGUE
            want += row_pairs * mod.PAIR_EPILOGUE
            pairs += row_pairs
    assert pairs > 216  # a few angles a water
    assert flops == want
    assert nbytes == 2 * (216 * 16 + 12) + 4 * pairs


def test_hbond_count():
    mod = spec.metric_reader("roofline.hbond")
    pos, boxes, box = _box()
    flops, nbytes = mod.count(pos, boxes, 3.5)
    within = 0
    for f in range(2):
        dsq = _dsq(pos[f, 0::3].numpy(), box)
        within += sum(1 for i in range(216) for j in range(216)
                      if 1e-2 < dsq[i, j] <= np.float32(3.5 * 3.5))
    assert within > 216  # a few bonds a water
    assert flops == within * DSQ_FLOPS + 2 * within * mod.ANGLE_FLOPS + 2 * 2 * 216 * mod.UNIT_FLOPS
    assert nbytes == 2 * (3 * 216 * 12 + 3 * 216 * 4 + 12)


def test_least_time_names_its_bound():
    from bench_torch.core.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS_F32, least_time

    assert least_time(PEAK_FLOPS_F32, 1.0) == (1.0, "operations")
    t, bound = least_time(1.0, PEAK_BYTES_PER_S * 2)
    assert math.isclose(t, 2.0) and bound == "bytes"
