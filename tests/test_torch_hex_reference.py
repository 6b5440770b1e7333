"""The port's `hex_order_calc` against the benchmark's plain reference of
psi6 (`bench_torch/reference/hex.py`: float64, arccos and torch.cos/sin of
6 theta, not the kernel's T6/U5 polynomials), on the CPU; the reference on
planar triangular lattices, where psi6 is known; and the counters
`psi6:rows` and `psi6:rows_over_k` against the dispatch's own counts.

The box is the benchmark's generated one (`bench_torch/core/waterbox.py`)
at 512 waters: 256 chain ends at 0.0167 A^-3, ~24 of them within 7 A of
each, so about half the rows keep 24 of a larger shell. The comparison is
the `spc4096.hex` cell's own check (`bench_torch/checks/hex.py`) at the
cell's limits: psi6 per row over the rows float32 cannot fairly decide
otherwise, equal shell counts, the printed `psiDistribution_0.txt`, the
returned means.
"""

import math
import types

import numpy as np
import pytest
import torch

from bench_torch.checks import hex as hex_check
from bench_torch.core import spec, waterbox
from bench_torch.reference.hex import ends, psi6_frames
from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.drivers import orderparams
from waterorderlib_tpu_torch.io.topology import Topology
from waterorderlib_tpu_torch.io.trajectory import Trajectory
from waterorderlib_tpu_torch.ops.cuda import psi6 as psi6_kernel

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pools stall when they outnumber the cores
torch.set_num_threads(1)

N_WATERS, N_FRAMES, SEED = 512, 4, 2**31 + 21
MODES = {"whole": None, "chunked": 2}  # chunk_frames


@pytest.fixture(scope="module", params=list(MODES))
def hex_run(request, tmp_path_factory):
    """hex_order_calc on the CPU over the generated box, whole or streamed
    in chunks of 2 frames: (the check's call record, each dispatch's
    (psi, count), the counters' increments)."""
    cfg = dict(spec.config("spc4096_ends"), n_waters=N_WATERS)
    pos, box = waterbox.make_frames(cfg, N_FRAMES, SEED, "cpu")
    pos = pos.numpy()
    boxes = np.full((N_FRAMES, 3), box, dtype=np.float32)
    top = Topology(**waterbox.topology_arrays(N_WATERS))
    out_dir = tmp_path_factory.mktemp(f"hex_{request.param}")
    captured = []
    orig = psi6_kernel.psi6_certified

    def capture(*a, **k):
        out = orig(*a, **k)
        captured.append(hex_check.capture(out))
        return out

    names = ("psi6:rows", "psi6:rows_over_k")
    before = {n: clock.total(n) for n in names}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orderparams.psi6_kernel, "psi6_certified", capture)
        result = orderparams.hex_order_calc(top, Trajectory(pos, boxes), output_dir=str(out_dir),
                                            chunk_frames=MODES[request.param], device="cpu")
    counted = {n: clock.total(n) - before[n] for n in names}
    call = types.SimpleNamespace(
        captured=captured, out_dir=str(out_dir), result=result, kwargs={},
        inputs=lambda: (torch.from_numpy(pos), torch.from_numpy(boxes)))
    return call, captured, counted, MODES[request.param]


def test_hex_order_calc_passes_the_cells_check(hex_run):
    call, captured, _, _ = hex_run
    prog = hex_check.program_answers(call)
    ref = hex_check.reference_answers(call, "float64")
    keep = ~ref["ambiguous"]
    assert int(keep.sum()) >= 0.99 * keep.numel()
    assert torch.equal(prog["count"][keep], ref["count"][keep])
    assert int((ref["count"] > psi6_kernel.K).sum()) > keep.numel() // 4  # the top-24 decides
    got = hex_check.compare(prog, ref)
    limits = spec.cell("spc4096.hex")["limits"]
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


def test_psi6_counters_equal_the_count_tensor(hex_run):
    _, captured, counted, chunk = hex_run
    assert len(captured) == (1 if chunk is None else N_FRAMES // chunk)  # a dispatch a chunk
    assert counted["psi6:rows"] == sum(c.numel() for _, c in captured)
    assert counted["psi6:rows_over_k"] == sum(int((c > psi6_kernel.K).sum()) for _, c in captured)
    assert 0 < counted["psi6:rows_over_k"] < counted["psi6:rows"]


def _triangular(spacing, nx=6, ny=4, height=20.0):
    """A planar triangular lattice of 2 nx ny sites at `spacing` in the
    z = 0 plane of its periodic rectangular cell (nx spacing by
    ny sqrt(3) spacing by `height`): (1, N, 3) sites, (1, 3) box, float64."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    row = np.stack([i * spacing, j * spacing * math.sqrt(3.0), 0 * i], -1).reshape(-1, 3)
    sites = np.concatenate([row, row + [spacing / 2, spacing * math.sqrt(3.0) / 2, 0]])
    box = [nx * spacing, ny * spacing * math.sqrt(3.0), height]
    return torch.tensor(sites[None]), torch.tensor([box])


@pytest.mark.parametrize("spacing,shell,psi", [
    # only the first shell lies within 7 A: every pair angle a multiple of
    # 60 degrees, psi6 = 1
    (5.0, 6, 1.0),
    # the second shell (4 sqrt 3 = 6.93 A) too, at 30 degrees from the
    # first: 30 pairs within a shell give +1, 36 across give -1, so
    # psi6 = |30 - 36| / 66 = 1/11
    (4.0, 12, 1.0 / 11.0),
])
def test_reference_psi6_on_a_triangular_lattice(spacing, shell, psi):
    sites, box = _triangular(spacing)
    got, count, amb = psi6_frames(sites, box, 0.0, 7.0)
    assert torch.all(count == shell) and not bool(amb.any())
    assert torch.allclose(got, torch.full_like(got, psi), rtol=0, atol=1e-12)
    prog, prog_count = psi6_kernel.psi6_certified(sites.float(), box.float(), 0.0, 7.0)
    assert torch.equal(prog_count.to(torch.int64), count)
    assert torch.allclose(prog.double(), got, rtol=0, atol=1e-5)


def test_reference_takes_the_drivers_ends():
    """The reference's centers of a water box are the driver's: every other
    water heavy atom, from the second (endInds = watInds[1::2])."""
    top = Topology(**waterbox.topology_arrays(6))
    pos = torch.arange(18 * 3, dtype=torch.float32).reshape(1, 18, 3)
    driver_ends = top.get_wat_inds("WAT")[0][1::2]
    assert list(driver_ends) == [3, 9, 15]
    assert torch.equal(ends(pos)[0], pos[0, driver_ends])
