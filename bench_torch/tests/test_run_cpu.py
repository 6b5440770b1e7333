"""The harness driven on the CPU at a tiny size: it exits non-zero without
a CUDA device; a sound run is correct; the control (the reference in
TF32) and the planted faults come out not correct."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_torch import run as run_mod
from bench_torch.control import control_readings
from bench_torch.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_exits_nonzero_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("mods,found", [
    ({"torch", "waterorderlib_tpu_torch.ops"}, []),
    ({"jax.numpy", "numpy"}, ["jax"]),
    ({"waterorderlib_tpu.ops.pallas", "waterorderlib_tpu_torch"}, ["waterorderlib_tpu"]),
    ({"jaxlib", "flax.linen", "jaxtyping"}, ["flax", "jaxlib"]),
])
def test_foreign_modules_by_whole_top_level_name(mods, found):
    assert run_mod.foreign_modules(mods) == found


def _run(cell, seed=2**31 + 5):
    return run_mod.Run(cell, seed, 0.5, False, "cpu").execute()


# a histogram of a few thousand values departs from the reference's by
# whole counts that the cell's limit, set from 262,144 values a call, does
# not allow for; at this size the Voronoi cell's histogram is not held to it
SIZE_BOUND = {"spc4096.voronoi": ("hist_excess",)}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res = _run(tiny(name))
    skip = SIZE_BOUND.get(name, ())
    bad = {k: c for k, c in res["checks"].items()
           if k not in skip and k != "checked_calls" and not c["value"] <= c["limit"]}
    assert not bad and res["checks"]["checked_calls"]["value"] >= 1, res["checks"]
    assert res["correct"] or skip
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"frames_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tiny, name):
    cell = tiny(name, n_waters=343)
    got = control_readings(cell, 2**32 + 3, "cpu")
    assert any(v > cell["limits"][k] for k, v in got.items()), got


def _altered(out):
    """An answer altered where it is produced: the first value of the first
    frame that is an answer moved by a tenth of its size or more. -1 is no
    answer: the angle kernel marks its empty slots so, and -1 * 1.1 + 0.1
    would leave one unchanged."""
    first = out[0]
    if isinstance(first, torch.Tensor):
        first = first.clone()
        flat = first.view(-1)
        i = int(torch.nonzero(flat != -1)[0])
        flat[i] = flat[i] * 1.1 + (0.1 if first.is_floating_point() else 1)
    else:
        first = first.copy()
        i = int(np.flatnonzero(first.reshape(-1) != -1)[0])
        first.flat[i] = first.flat[i] * 1.1 + 0.1
    return (first, *out[1:])


def _half(out):
    """Half of the batch left out: the second half of the frames a copy of
    the first, so the statistics are taken over the rest."""
    def fold(t):
        t = t.clone() if isinstance(t, torch.Tensor) else t.copy()
        if t.ndim == 0 or t.shape[0] < 2:
            return t
        h = t.shape[0] // 2
        t[h:2 * h] = t[:h]
        return t
    return tuple(fold(t) for t in out[:2]) + tuple(out[2:])


@pytest.mark.parametrize("fault", [_altered, _half], ids=["answer_altered", "half_the_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(tiny, monkeypatch, name, fault):
    import importlib

    cell = tiny(name, frames=4)
    mod_name, attr = spec.check_module(cell["check"]).FAULT_AT
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)

    def broken(*args, **kwargs):
        return fault(orig(*args, **kwargs))

    for k in ("launches", "calls"):
        if hasattr(orig, k):
            setattr(broken, k, getattr(orig, k))
    monkeypatch.setattr(mod, attr, broken)
    res = _run(cell)
    assert not res["correct"], res["checks"]
