"""Helpers of the benchmark's CPU tests: the cells cut to a size the CPU
runs in seconds (the widths stay, the molecule count and frames shrink)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def tiny_cell(name: str, n_waters: int = 216, frames: int = 2):
    from bench_torch.core import spec

    cell = spec.cell(name)
    cell["config_spec"]["n_waters"] = n_waters
    tr = cell["traffic_spec"]
    tr.update(frames_per_call=frames, pool_frames=2 * frames, min_calls=2, check_calls=1)
    if "engine" in tr["kwargs"]:
        tr["kwargs"]["engine"] = "device"  # the device engine's plain versions on the CPU
    if tr.get("population"):
        tr["population"]["radius_A"] = 5.0
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
