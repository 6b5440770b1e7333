"""The harness driven on the CPU at a tiny size: it exits non-zero without
a CUDA device; a sound run is correct; the control (the reference in
TF32) and the planted faults come out not correct."""

import os
import subprocess
import sys

import pytest

from bench_torch import run as run_mod
from bench_torch.control import control_readings
from bench_torch.core import faults, spec

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


# end-to-end metrics that only a card can read
CARD_ONLY = {"memory_peak_mib"}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res = _run(tiny(name))
    skip = SIZE_BOUND.get(name, ())
    bad = {k: c for k, c in res["checks"].items()
           if k not in skip and k != "checked_calls" and not c["value"] <= c["limit"]}
    assert not bad and res["checks"]["checked_calls"]["value"] >= 1, res["checks"]
    assert res["correct"] or skip
    assert list(res)[-1] == "checks"
    e2e, _ = spec.metrics_of(spec.benchmark(), name)
    assert set(res["metrics"]) == {m["name"] for m in e2e} - CARD_ONLY
    assert "setup_s" in res["metrics"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tiny, name):
    cell = tiny(name, n_waters=343)
    got = control_readings(cell, 2**32 + 3, "cpu")
    assert any(v > cell["limits"][k] for k, v in got.items()), got


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(tiny, monkeypatch, name, fault):
    cell = tiny(name, frames=4)
    faults.plant(fault, spec.check_module(cell["check"]).FAULT_AT, monkeypatch.setattr)
    res = _run(cell)
    assert not res["correct"], res["checks"]


# the tiny size at which the split LSI tier's windows cover every row, so
# that lsi_certified takes it when `split_tier` is held true
TIER_WATERS = 512
TIERS = [(name, tier) for name in CELLS
         for tier in faults.points(spec.check_module(spec.cell(name)["check"])) if tier]


def _tier_cell(tiny, monkeypatch, name, tier):
    cell = tiny(name, n_waters=TIER_WATERS, frames=4)
    point = faults.points(spec.check_module(cell["check"]))[tier]
    faults.force_tier(point, monkeypatch.setattr)
    return cell, point


@pytest.mark.parametrize("name,tier", TIERS, ids=lambda v: v)
def test_forced_tier_is_served_and_correct(tiny, monkeypatch, name, tier):
    cell, _ = _tier_cell(tiny, monkeypatch, name, tier)
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert spec.attr(cell["report"][0])[2] == tier


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
@pytest.mark.parametrize("name,tier", TIERS, ids=lambda v: v)
def test_planted_fault_at_each_tier_is_not_correct(tiny, monkeypatch, name, tier, fault):
    """A fault at the launch of a tier that the cell takes on the card and
    the tiny CPU cell does not (`TIER_FAULTS`), with the tier forced."""
    cell, point = _tier_cell(tiny, monkeypatch, name, tier)
    faults.plant(fault, point["at"], monkeypatch.setattr)
    res = _run(cell)
    assert not res["correct"], res["checks"]
