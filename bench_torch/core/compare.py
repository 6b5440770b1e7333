"""Arithmetic shared by the output checks (checks/*.py): the control's
precision, the drivers' text histograms, and the population statistics the
drivers return, all computed here from the reference's values."""

from __future__ import annotations

import numpy as np
import torch

# precisions a reference is computed in: the reference itself, and the
# control, the nearest precision below the configurations' float32 (TF32:
# float32's range with a 10-bit mantissa)
PRECISIONS = ("float64", "tf32")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), returned as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def at_precision(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Coordinates as a reference in `precision` computes with them:
    float64, or rounded to TF32 and held in float32."""
    if precision == "float64":
        return x.to(torch.float64)
    if precision == "tf32":
        return tf32(x)
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An intermediate result, rounded as `precision` stores it."""
    return tf32(x) if precision == "tf32" else x


def as_printed(counts) -> np.ndarray:
    """Histogram counts as the drivers' files hold them (`%.3e`)."""
    return np.array([float(f"{c:.3e}") for c in np.asarray(counts, dtype=np.float64)])


def read_hist(path) -> np.ndarray:
    """The counts column of a driver's histogram file."""
    return np.loadtxt(path, ndmin=2)[:, 1]


def hist_excess(printed: np.ndarray, ref_counts: np.ndarray) -> float:
    """Share of the reference's counts by which a printed histogram departs
    from them beyond what `%.3e` rounding explains: the sum over bins of
    max(0, |printed - ref| - half a unit of the fourth significant digit),
    over the reference's total."""
    printed = np.asarray(printed, dtype=np.float64)
    ref = np.asarray(ref_counts, dtype=np.float64)
    big = np.maximum(np.abs(printed), np.abs(ref))
    slack = np.where(big > 0, 0.5 * 10.0 ** (np.floor(np.log10(np.maximum(big, 1.0))) - 3), 0.0)
    excess = np.maximum(0.0, np.abs(printed - ref) - slack)
    return float(excess.sum() / max(ref.sum(), 1.0))


def histogram(values: np.ndarray, n_bins: int, lo: float, hi: float) -> np.ndarray:
    """np.histogram's counts over [lo, hi] (the drivers' bin rule)."""
    return np.histogram(values, bins=n_bins, range=(lo, hi))[0]


def pop_mean_var(values: torch.Tensor, masks: torch.Tensor):
    """Per-frame mean and population variance of values (F, N) under masks
    (F, P, N), NaN where a mask is empty, then their means over frames
    ignoring NaN: (mean of means (P,), mean of variances (P,)) float64."""
    v = values.to(torch.float64)[:, None, :]
    m = masks.to(torch.float64)
    n = m.sum(-1)
    mean = (v * m).sum(-1) / n.clamp(min=1)
    var = (m * (v - mean[..., None]) ** 2).sum(-1) / n.clamp(min=1)
    nan = torch.full_like(mean, float("nan"))
    mean, var = torch.where(n > 0, mean, nan), torch.where(n > 0, var, nan)
    return torch.nanmean(mean, 0).cpu().numpy(), torch.nanmean(var, 0).cpu().numpy()


def masks_of(sub_inds, n_frames: int, n_rows: int, device) -> torch.Tensor:
    """(F, 2, n_rows) bool: every water, then the shell population, from
    the ragged per-frame oxygen indices (row = atom index // 3)."""
    m = torch.zeros((n_frames, 2, n_rows), dtype=torch.bool)
    m[:, 0] = True
    for f, pops in enumerate(sub_inds):
        m[f, 1, torch.as_tensor(np.asarray(pops[0]) // 3)] = True
    return m.to(device)


def max_gap(a, b) -> float:
    """Largest absolute difference of two equal-shaped arrays, NaN-aware:
    NaN against a number is an infinite gap, NaN against NaN none."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    both = np.isnan(a) & np.isnan(b)
    one = np.isnan(a) ^ np.isnan(b)
    if one.any():
        return float("inf")
    d = np.where(both, 0.0, np.abs(a - b))
    return float(d.max()) if d.size else 0.0


def rel_gap(a, b) -> float:
    """Largest |a - b| / |b| over the finite values of `b`; where `a` and
    `b` are not finite in the same places, an infinite gap."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    finite = np.isfinite(b)
    if not np.array_equal(finite, np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a[finite] - b[finite]) / np.abs(b[finite]))) if finite.any() else 0.0
