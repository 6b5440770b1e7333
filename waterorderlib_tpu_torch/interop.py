"""Carry state from the JAX package into the port.

This system has no weights: its state is the trajectory and the slab prep.
The port's `io` is a copy of the JAX package's, so a system built or loaded
by either holds the same arrays (pass them as numpy); `slab_prep_from_jax`
turns the JAX package's `SlabPrep` arrays into the port's, so the port's
kernel contracts can be fed the JAX prep and kernel parity checked apart
from prep parity.
"""

from __future__ import annotations

import numpy as np
import torch

from waterorderlib_tpu_torch.ops.cuda.slab import SlabPrep


def slab_prep_from_jax(ext_t, starts_div128, covered, order0, w, n_tiles, device) -> SlabPrep:
    """The port's SlabPrep from the JAX package's, given as numpy arrays.

    The JAX prep stores window starts divided by 128 (the TPU's lane
    alignment); the port stores them in columns.
    """
    # torch.tensor copies: arrays handed over from jax are read-only
    starts = np.asarray(starts_div128, dtype=np.int64) * 128
    return SlabPrep(
        ext_t=torch.tensor(np.asarray(ext_t, np.float32), device=device),
        starts=torch.tensor(starts.astype(np.int32), device=device),
        covered=torch.tensor(np.asarray(covered, bool), device=device),
        order0=torch.tensor(np.asarray(order0, np.int64), device=device),
        w=int(w),
        n_tiles=int(n_tiles),
    )
