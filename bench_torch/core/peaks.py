"""Published peaks of the card and the least time a stage's work needs.

NVIDIA's data sheet for the H100 SXM5 80 GB: 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM3 bandwidth, both at the full 700 W
power limit. A card set below that limit runs slower under load, so every
run prints the card's `power.limit` beside these numbers."""

from __future__ import annotations

import subprocess

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, which bound) for work of `flops` float32 operations and
    `nbytes` bytes moved: the larger of the two times at the peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_power() -> str:
    """The card's name and power limit as nvidia-smi reports them, or why
    not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e!r}"
    return out.stdout.strip() or out.stderr.strip()
