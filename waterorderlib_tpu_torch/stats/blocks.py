"""Block-averaged bootstrap confidence intervals.

Replaces the reference's error-bar engine `blockAverage`/`getCI`
(the reference structureLibs/orderParam_lib.py:387-417), used by every
driver: split the frame series into nBlocks blocks, bootstrap-resample block
means (10,000 resamples), and report the 95% confidence half-width.

The resampling itself is vectorized (one (nResamp, nBlocks) draw instead of
a Python loop) and runs on host numpy: it is microscopic next to the device
work.
"""

from __future__ import annotations

import numpy as np


def get_ci(sorted_means: np.ndarray) -> float:
    """95% CI half-width from sorted bootstrap means (orderParam_lib.py:387-391)."""
    n = len(sorted_means)
    mean_ci = sorted_means[int(0.5 * n)]
    upper = sorted_means[int(0.975 * n)] - mean_ci
    lower = mean_ci - sorted_means[int(0.025 * n)]
    return float(max(upper, lower))


def block_average(
    vals: np.ndarray,
    n_blocks: int = 20,
    n_resamp: int = 10000,
    seed: int | None = None,
) -> float:
    """95% bootstrap CI of the mean of a frame series
    (orderParam_lib.py:394-417). Deterministic when `seed` is given."""
    vals = np.asarray(vals, dtype=np.float64)
    # short series: fewer blocks than the default, else empty blocks -> NaN
    n_blocks = max(1, min(n_blocks, len(vals)))
    len_block = len(vals) / n_blocks
    blocks = np.array(
        [np.mean(vals[int(i * len_block) : int((i + 1) * len_block)]) for i in range(n_blocks)]
    )
    rs = np.random.RandomState(seed) if seed is not None else np.random
    picks = rs.randint(0, n_blocks, size=(n_resamp, n_blocks))
    means = np.sort(np.mean(blocks[picks], axis=1))
    return get_ci(means)


def mean_and_ci(vals: np.ndarray, n_blocks: int = 20, seed: int | None = None):
    """[mean, CI] pair in the reference drivers' return convention."""
    vals = np.asarray(vals, dtype=np.float64)
    return [float(np.mean(vals)), block_average(vals, n_blocks=n_blocks, seed=seed)]


def chunk_se(samples: np.ndarray, axis: int = 0) -> np.ndarray:
    """Standard error over trajectory chunks as used by rdfCalc
    (orderParam_lib.py:695-709): std(ddof=1)/sqrt(nChunks-1)."""
    samples = np.asarray(samples, dtype=np.float64)
    n = samples.shape[axis]
    return np.std(samples, axis=axis, ddof=1) / np.sqrt(n - 1)
