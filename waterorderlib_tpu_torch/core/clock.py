"""The device check and the stage clock shared by the drivers and the
surface layer.

`resolve_device` turns a `device=` argument into a torch.device and raises
where CUDA is asked for but absent (the port never falls back to the CPU on
its own). `stage_times()` times the named steps of the calls made inside it;
each step ends with `stage_end(name)`.
"""

from __future__ import annotations

import contextlib
from time import perf_counter

import torch


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch finds no CUDA device; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    return dev


# stage name -> ms, while a `stage_times` block is open; None otherwise
_stage_ms: dict | None = None
_stage_t0 = 0.0


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_times():
    """Time the named steps (host gather, H2D, masks, kernel stage, stats,
    D2H, savetxt, bootstrap; for `density_grid` grid setup, H2D, prep,
    kernel, D2H, marching tetrahedra) of the calls made inside the block.
    Yields a dict to which each step adds its wall time in ms at its end,
    the CUDA device synchronised there. Outside a block a step's end costs
    one comparison."""
    global _stage_ms, _stage_t0
    _sync()
    _stage_ms, _stage_t0 = {}, perf_counter()
    try:
        yield _stage_ms
    finally:
        _stage_ms = None


def stage_end(name: str) -> None:
    """End the step `name` on the open `stage_times` block, if any."""
    global _stage_t0
    if _stage_ms is None:
        return
    _sync()
    now = perf_counter()
    _stage_ms[name] = _stage_ms.get(name, 0.0) + (now - _stage_t0) * 1e3
    _stage_t0 = now
