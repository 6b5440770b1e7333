"""Masked histograms with np.histogram bin semantics (port of
waterorderlib_tpu.ops.histograms).

Values come with validity masks instead of ragged shapes. The bin rule is
the JAX package's, exactly: float32 thresholds `lo + k*width`; a value's bin
is `searchsorted(thresholds, v, right=True) - 1`; values below lo or above
the last threshold are dropped, and a value equal to hi is added to the last
bin. `floor((v - lo) / width)` is not used: it moves edge values to the
neighboring bin.
"""

from __future__ import annotations

import numpy as np
import torch


def masked_histogram(
    values: torch.Tensor,
    mask: torch.Tensor,
    n_bins: int,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """Histogram of `values[mask]` over [lo, hi]: n_bins equal bins,
    left-inclusive, the final bin right-inclusive. Returns int64 counts."""
    return masked_histogram_frames(values.reshape(1, -1), mask.reshape(1, -1), n_bins, lo, hi)[0]


def masked_histogram_frames(
    values: torch.Tensor,
    mask: torch.Tensor,
    n_bins: int,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """`masked_histogram` of each frame: values and mask (F, ...) give
    (F, n_bins) int64 counts, from one bincount over frame * n_bins + bin."""
    n_frames = values.shape[0]
    dt, dev = values.dtype, values.device
    width = torch.tensor((hi - lo) / n_bins, dtype=dt, device=dev)
    thresholds = torch.tensor(lo, dtype=dt, device=dev) + torch.arange(
        n_bins + 1, dtype=dt, device=dev
    ) * width
    flat = values.reshape(n_frames, -1)
    m = mask.reshape(n_frames, -1)
    b = torch.searchsorted(thresholds, flat, right=True, out_int32=True) - 1
    keep = m & (b >= 0) & (b < n_bins)
    b += (torch.arange(n_frames, dtype=torch.int32, device=dev) * n_bins)[:, None]
    hist = torch.bincount(b[keep], minlength=n_frames * n_bins).reshape(n_frames, n_bins)
    hist[:, n_bins - 1] += ((flat == hi) & m).sum(dim=1)
    return hist


def bin_centers(n_bins: int, lo: float, hi: float) -> np.ndarray:
    """Midpoints 0.5*(edges[:-1]+edges[1:]) as the drivers print them."""
    edges = np.linspace(lo, hi, n_bins + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def masked_mean_var(values: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """(mean, population variance) over masked entries; NaN when empty,
    matching np.mean/np.var on an empty selection."""
    m = mask.to(values.dtype)
    n = m.sum(dim=dim)
    safe_n = torch.clamp(n, min=1.0)
    mean = (values * m).sum(dim=dim) / safe_n
    var = (m * (values - mean.unsqueeze(dim)) ** 2).sum(dim=dim) / safe_n
    nan = torch.full_like(mean, float("nan"))
    return torch.where(n > 0, mean, nan), torch.where(n > 0, var, nan)
