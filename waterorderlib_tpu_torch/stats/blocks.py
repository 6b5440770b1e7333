"""Block-averaged bootstrap confidence intervals.

Replaces the reference's error-bar engine `blockAverage`/`getCI`
(the reference structureLibs/orderParam_lib.py:387-417), used by every
driver: split the frame series into nBlocks blocks, bootstrap-resample block
means (10,000 resamples), and report the 95% confidence half-width.

The resampling itself is vectorized (one (nResamp, nBlocks) draw instead of
a Python loop) and runs on host numpy. Drawing the picks costs more than using
them, so a call's series share one draw where a seed makes them equal.
"""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu_torch.core import clock


def get_ci(sorted_means: np.ndarray) -> float:
    """95% CI half-width from sorted bootstrap means (orderParam_lib.py:387-391)."""
    n = len(sorted_means)
    mean_ci = sorted_means[int(0.5 * n)]
    upper = sorted_means[int(0.975 * n)] - mean_ci
    lower = mean_ci - sorted_means[int(0.025 * n)]
    return float(max(upper, lower))


def block_average_columns(
    series,
    n_blocks: int = 20,
    n_resamp: int = 10000,
    seed: int | None = None,
) -> list[float]:
    """95% bootstrap CI of the mean of each frame series, in order
    (orderParam_lib.py:394-417, one series at a time).

    With `seed`, every series of one length resamples its blocks by the same
    picks, those of `RandomState(seed)`, so the (n_resamp, n_blocks) matrix is
    drawn once for them and shared: the CIs are those of one `block_average`
    per series. The draw lives in this call only. With `seed` None each series
    draws its own picks from `np.random`'s global state, in order, as
    `block_average` does series by series. Counts `bootstrap:draws` (matrices
    drawn) and `bootstrap:columns` (series)."""
    draws: dict[int, np.ndarray] = {}  # n_blocks -> picks, with a seed
    cis = []
    for vals in series:
        vals = np.asarray(vals, dtype=np.float64)
        # short series: fewer blocks than the default, else empty blocks -> NaN
        nb = max(1, min(n_blocks, len(vals)))
        len_block = len(vals) / nb
        blocks = np.array(
            [np.mean(vals[int(i * len_block) : int((i + 1) * len_block)]) for i in range(nb)]
        )
        picks = draws.get(nb)
        if picks is None:
            rs = np.random.RandomState(seed) if seed is not None else np.random
            picks = rs.randint(0, nb, size=(n_resamp, nb))
            clock.count("bootstrap:draws")
            if seed is not None:
                draws[nb] = picks
        cis.append(get_ci(np.sort(np.mean(blocks[picks], axis=1))))
    clock.count("bootstrap:columns", len(cis))
    return cis


def block_average(
    vals: np.ndarray,
    n_blocks: int = 20,
    n_resamp: int = 10000,
    seed: int | None = None,
) -> float:
    """95% bootstrap CI of the mean of a frame series
    (orderParam_lib.py:394-417). Deterministic when `seed` is given."""
    return block_average_columns([vals], n_blocks, n_resamp, seed)[0]


def mean_and_ci_columns(series, n_blocks: int = 20, seed: int | None = None) -> list:
    """[mean, CI] pair of each series, in the reference drivers' return
    convention; one resample draw for all of them (`block_average_columns`)."""
    series = [np.asarray(v, dtype=np.float64) for v in series]
    cis = block_average_columns(series, n_blocks=n_blocks, seed=seed)
    return [[float(np.mean(v)), ci] for v, ci in zip(series, cis)]


def mean_and_ci(vals: np.ndarray, n_blocks: int = 20, seed: int | None = None):
    """[mean, CI] pair in the reference drivers' return convention."""
    return mean_and_ci_columns([vals], n_blocks=n_blocks, seed=seed)[0]


def chunk_se(samples: np.ndarray, axis: int = 0) -> np.ndarray:
    """Standard error over trajectory chunks as used by rdfCalc
    (orderParam_lib.py:695-709): std(ddof=1)/sqrt(nChunks-1)."""
    samples = np.asarray(samples, dtype=np.float64)
    n = samples.shape[axis]
    return np.std(samples, axis=axis, ddof=1) / np.sqrt(n - 1)
