"""The port's `three_body_calc` against the benchmark's plain reference of
the 3-body angles (`bench_torch/reference/three_body.py`: float64, the
definition's arccos, not the kernel's polynomial), on the CPU.

The box is the benchmark's generated one (`bench_torch/core/waterbox.py`)
at 512 waters, with one population, the waters within 8 A of the box
centre. The comparison is the `spc4096.three_body` cell's own check
(`bench_torch/checks/three_body.py`) at the cell's limits: each row's
angles as a sorted set over the rows float32 cannot fairly decide
otherwise, equal shell counts, the printed `3bDistribution_0.txt` and
`3bDistribution_1.txt`, and the five returned means. Streamed in chunks of
frames the driver gives the same.
"""

import types

import numpy as np
import pytest
import torch

from bench_torch.checks import three_body as tb_check
from bench_torch.core import spec, waterbox
from waterorderlib_tpu_torch.drivers import orderparams
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory
from waterorderlib_tpu_torch.ops.cuda import angles as angles_kernel

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

N_WATERS, N_FRAMES, SEED = 512, 4, 2**31 + 33


@pytest.mark.parametrize("chunk_frames", [None, 2], ids=["whole", "chunked"])
def test_three_body_calc_passes_the_cells_check(chunk_frames, monkeypatch, tmp_path):
    cfg = dict(spec.config("spc4096"), n_waters=N_WATERS)
    pos, box = waterbox.make_frames(cfg, N_FRAMES, SEED, "cpu")
    sub_inds = waterbox.shell_population(pos, box, 8.0)
    pos = pos.numpy()
    boxes = np.full((N_FRAMES, 3), box, dtype=np.float32)
    top = Topology(**waterbox.topology_arrays(N_WATERS))
    captured = []
    orig = angles_kernel.neighbor_pair_angles_certified

    def capture(*a, **k):
        out = orig(*a, **k)
        captured.append(tb_check.capture(out))
        return out

    monkeypatch.setattr(orderparams.angles_kernel, "neighbor_pair_angles_certified", capture)
    result = orderparams.three_body_calc(top, Trajectory(pos, boxes), sub_inds=sub_inds, n_pops=1,
                                         output_dir=str(tmp_path), chunk_frames=chunk_frames,
                                         device="cpu")
    call = types.SimpleNamespace(
        captured=captured, out_dir=str(tmp_path), result=result, kwargs={}, sub_inds=sub_inds,
        inputs=lambda: (torch.from_numpy(pos), torch.from_numpy(boxes)))
    prog = tb_check.program_answers(call)
    ref = tb_check.reference_answers(call, "float64")
    keep = ~ref["ambiguous"]
    assert int(keep.sum()) >= 0.99 * keep.numel()
    assert torch.equal(prog["count"][keep], ref["count"][keep])
    assert all(len(p) > 0 for p in sub_inds[0])  # the population is not empty
    got = tb_check.compare(prog, ref)
    limits = spec.cell("spc4096.three_body")["limits"]
    assert all(got[k] <= limits[k] for k in limits), (got, limits)
