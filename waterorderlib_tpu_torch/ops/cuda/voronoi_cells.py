"""Fused Voronoi cell moments: the CUDA kernel's wrapper and its plain
PyTorch version (port of waterorderlib_tpu.ops.pallas.voronoi_cells). In
waterorderlib_tpu_torch.surface.voronoi_device it builds the clip builder's
cells on the card (`dedup_mode="always"`) at every tier it holds, and serves
`cell_impl="pallas"` (`dedup_mode="auto"`).

For each row (a cell): the clip builder's cell (surface/voronoi_device.py
`_cell_moments_clip`) from the row's parked candidates, except that the
endpoint dedup runs only on the rows that can hold duplicate edges: the
boundary rows (`is_boundary`, a mirror among the build planes) and the
rows where a plane is tangent to the cell along an edge (a face of >= 2
edges and signed area <= eps * s_scale in the sums taken without dedup).
`dedup_mode="always"` dedups every row: that is the clip builder itself.

`voronoi_cells_fused` launches the kernel (csrc/voronoi_cells.cu) on CUDA
tensors, which must be float32, and calls the plain version on CPU tensors
(float32 or float64); any other device raises. There is no fallback from
the kernel to the plain version. The plain version is the clip builder
with the per-row dedup (`_faces_from_edges`); it is the kernel's arithmetic
in PyTorch, so the two agree bit for bit.

`fits_voronoi_cells` is the JAX package's fit predicate, kept as the tier
rule of `cell_impl="pallas"`: which dedup rule serves a tier decides which
rows certify there (the "auto" rule skips dedup on rows that need none), so
that builder takes the fused rule at the tiers the JAX package gives its
kernel and the clip builder's elsewhere.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.ops.cuda import build, window

MAX_K = 64  # kMaxK in csrc/voronoi_cells.cu: a face's k - 1 slots are bits of one 64-bit mask
MAX_KS = 128  # kMaxKS: the row's candidates in shared memory
DEDUP_MODES = ("auto", "always")
SMEM_MAX = build.SMEM_MAX
_SM_SMEM = 233_472  # an SM's shared memory; each block takes 1 KB more than it asks
_ROWS_PER_BLOCK = (1, 2, 4)  # kMaxRowsPerBlock in csrc/voronoi_cells.cu: 4

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_OUT_KEYS = ("vol", "area", "face_area", "face_nverts", "r_cell", "ok_shape", "closure_err",
             "extra_cut", "neg_face")


def fits_voronoi_cells(k: int, ks: int) -> bool:
    """The JAX package's fit predicate for its fused kernel: its static
    tables and working set within 12 MB of scoped VMEM. True at (32, 64)
    and (40, 96), false from k = 48 on and beyond ks = 128."""
    if ks < k or ks > 128:
        return False
    pp = -(-(k * (k - 1) // 2) // 128) * 128
    f = k * k
    tables = (2 * ks * pp + pp * f + f + f * k) * 4
    work = (4 * ks * pp + 30 * pp + 12 * f) * 4
    return tables + work <= 12_000_000


def row_bytes(k: int, ks: int) -> int:
    """Shared memory of one row of the kernel (`row_bytes` in the source):
    its candidates (24 bytes each), its P = C(k, 2) pairs' endpoints (24
    bytes each) and feasibility bits (P / 32 words), rounded up to 16."""
    P = k * (k - 1) // 2
    return -(-(ks * 24 + P * 24 + -(-P // 32) * 4) // 16) * 16


def rows_per_block(k: int, ks: int) -> int:
    """Rows (one warp each) a block takes: the count that puts the most
    rows on an SM, the smaller on a tie (1 at (32, 64): 16 rows an SM; 1
    at (40, 96): 10; 1 at (64, 128): 4)."""
    def rows_on_sm(r):
        return r * (_SM_SMEM // (r * row_bytes(k, ks) + 1024))

    return max(_ROWS_PER_BLOCK, key=lambda r: (rows_on_sm(r), -r))


def pair_table(k: int) -> np.ndarray:
    """(C(k, 2),) int32: pair p's planes i | j << 8, in the order of
    `surface.voronoi_device._pair_tables(k)` (i < j, by i, then j)."""
    i, j = np.triu_indices(k, 1)
    return (i | j << 8).astype(np.int32)


_PAIRS: dict = {}


def _pairs_on(k: int, dev):
    t = _PAIRS.get((k, dev))
    if t is None:
        t = _PAIRS[(k, dev)] = torch.as_tensor(pair_table(k), device=dev)
    return t


def _check(kernel: bool, rel_parked, valid, is_boundary, k, dedup_mode):
    allowed = (torch.float32,) if kernel else (torch.float32, torch.float64)
    if rel_parked.dtype not in allowed:
        raise TypeError(f"rel_parked must be {' or '.join(map(str, allowed))}, got "
                        f"{rel_parked.dtype}")
    if rel_parked.dim() != 3 or rel_parked.shape[2] != 3:
        raise ValueError(f"rel_parked must be (R, ks, 3), got {tuple(rel_parked.shape)}")
    R, ks, _ = rel_parked.shape
    if not rel_parked.is_contiguous():
        raise ValueError("rel_parked must be contiguous")
    for name, t, shape in (("valid", valid, (R, ks)), ("is_boundary", is_boundary, (R,))):
        if t.dtype != torch.bool or tuple(t.shape) != shape or t.device != rel_parked.device:
            raise ValueError(f"{name} must be bool {shape} on {rel_parked.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 2 <= k <= min(MAX_K, ks) or ks > MAX_KS:
        raise ValueError(f"k={k}, ks={ks}: the kernel takes 2 <= k <= min({MAX_K}, ks) and "
                         f"ks <= {MAX_KS}")
    if dedup_mode not in DEDUP_MODES:
        raise ValueError(f"dedup_mode must be one of {DEDUP_MODES}, got {dedup_mode!r}")


@clock.kernel
def voronoi_cells_fused(rel_parked, valid, is_boundary, k: int, eps: float,
                        dedup_mode: str = "auto") -> dict:
    """Cell moments of R rows: rel_parked (R, ks, 3) the candidates relative
    to each center, nearest first, with the park directions of
    `_park_directions(ks)` * 1e6 at invalid slots; valid (R, ks) bool (only
    the scale's median reads it); is_boundary (R,) bool. Returns the clip
    builder's dict: vol, area, r_cell, closure_err (R,), ok_shape,
    extra_cut, neg_face (R,) bool, face_area (R, k), face_nverts (R, k)
    int32."""
    _check(rel_parked.device.type == "cuda", rel_parked, valid, is_boundary, k, dedup_mode)
    if window.runs_plain(rel_parked, "voronoi_cells_fused"):
        return voronoi_cells_fused_plain(rel_parked, valid, is_boundary, k, eps, dedup_mode)
    R, ks, _ = rel_parked.shape
    dev = rel_parked.device
    out = {key: torch.empty(R, dtype=torch.float32, device=dev)
           for key in ("vol", "area", "r_cell", "closure_err")}
    out.update({key: torch.empty(R, dtype=torch.bool, device=dev)
                for key in ("ok_shape", "extra_cut", "neg_face")})
    out["face_area"] = torch.empty((R, k), dtype=torch.float32, device=dev)
    out["face_nverts"] = torch.empty((R, k), dtype=torch.int32, device=dev)
    closure_tol = float(max(np.float32(20.0 * eps), np.float32(1e-6)))
    boundary, valid = is_boundary.contiguous(), valid.contiguous()
    fn = build.load("voronoi_cells").voronoi_cells_launch
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_float,
                       _c_float, _c_int, *([_c_ptr] * 9), _c_ptr]
        fn.restype = _c_int
    outs = [out[key] for key in ("vol", "area", "r_cell", "closure_err", "ok_shape", "extra_cut",
                                 "neg_face", "face_area", "face_nverts")]
    with torch.cuda.device(dev):
        err = fn(rel_parked.data_ptr(), valid.data_ptr(), boundary.data_ptr(),
                 _pairs_on(k, dev).data_ptr(), R, ks, k, rows_per_block(k, ks), float(eps),
                 closure_tol, int(dedup_mode == "always"), *(t.data_ptr() for t in outs),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"voronoi_cells_launch failed: CUDA error {err}")
    clock.count("launches:voronoi_cells_fused")
    return {key: out[key] for key in _OUT_KEYS}


@clock.plain
def voronoi_cells_fused_plain(rel_parked, valid, is_boundary, k: int, eps: float,
                              dedup_mode: str = "auto") -> dict:
    """Plain PyTorch version of `voronoi_cells_fused`: the clip builder,
    block by block, with the per-row dedup rule (every row under
    "always")."""
    from waterorderlib_tpu_torch.surface import voronoi_device as vd

    _check(False, rel_parked, valid, is_boundary, k, dedup_mode)
    return vd._clip_cells(rel_parked, valid, k, eps,
                          is_boundary=None if dedup_mode == "always" else is_boundary)
