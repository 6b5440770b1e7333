"""Per-frame population caching (checkpoint/resume); the port's copy of
waterorderlib_tpu.drivers.cache, calling the port's get_bound_wrap.

Replaces the reference's `boundFile.npy` idiom
(orderParam_lib.py:2017-2036): expensive per-frame bound/wrap/shell masks
are cached to an npz keyed by (trajectory fingerprint, stride, cutoffs) and
invalidated automatically when any of those change — the reference only
checked array shapes.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _fingerprint(traj, stride, **params) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(traj.positions[0]).tobytes())
    h.update(np.ascontiguousarray(traj.boxes).tobytes())
    h.update(str(traj.n_frames).encode())
    h.update(str(stride).encode())
    for k in sorted(params):
        h.update(f"{k}={params[k]!r}".encode())
    return h.hexdigest()[:32]


def cached_bound_wrap(cache_path: str, top, traj, stride: int = 1, device="cuda", **kwargs):
    """get_bound_wrap with npz caching. Returns the per-frame list of
    (bound, wrap, shell, nonshell) global-index tuples, recomputing only
    when the fingerprint does not match the cache. `device` is where a
    recomputation runs; the result does not depend on it, so it is not
    part of the fingerprint."""
    from waterorderlib_tpu_torch.drivers.hbonds_driver import get_bound_wrap

    fp = _fingerprint(traj, stride, **kwargs)
    if os.path.exists(cache_path):
        try:
            with np.load(cache_path, allow_pickle=False) as d:
                if str(d["fingerprint"]) == fp:
                    n = int(d["n_frames"])
                    return [
                        tuple(d[f"frame{t}_{k}"] for k in ("bound", "wrap", "shell", "nonshell"))
                        for t in range(n)
                    ]
        except Exception:
            pass  # unreadable/stale cache: recompute

    result = get_bound_wrap(top, traj if stride == 1 else traj.strided(stride), device=device,
                            **kwargs)
    payload = {
        "fingerprint": np.array(fp),
        "n_frames": np.array(len(result)),
    }
    for t, frame in enumerate(result):
        for k, v in zip(("bound", "wrap", "shell", "nonshell"), frame):
            payload[f"frame{t}_{k}"] = np.asarray(v)
    np.savez_compressed(cache_path, **payload)
    return result
