"""Device Voronoi cells (port of waterorderlib_tpu.surface.voronoi_device):
mirrored candidates, the K-nearest search on the hand-written kernel
(ops/cuda/voronoi_topk.py, z-window and cell-grid forms), three cell
builders (the clip builder, the default, on the cell kernel
ops/cuda/voronoi_cells.py in dedup mode "always" where the rows fit it and
in PyTorch elsewhere; the fused dedup rule under cell_impl="pallas"; the
legacy triple builder in PyTorch), the exactness certificates, the
escalation ladder, the host close, and the contact matrices built from the
cells' faces.

The design is the JAX package's (see its module docstring): the candidate
set is the points plus their single-axis reflections across the nearer box
face; a cell is the intersection of the bisector half-spaces of its k
nearest candidates, built by clipping each plane pair's line against all
k planes (`_cell_moments_clip`); planes k..k_search only check the cell,
and d_{k_search} >= 2 R_cell certifies it exact. Uncertified rows climb
the (k, k_search) tiers and what is left is closed on the host with scipy.

What the port keeps verbatim, because it decides which tier certifies a
row: the sizing helpers (`_suggest_win`, `_suggest_win_subset`,
`_quantize_win`, `_suggest_mirror_budget`, `_suggest_cellgrid`), the
depth-pruned mirror set, the escalation subsets' bucket padding, the stable
sorts (x and y mirrors share their source's z exactly, so the z-order of
the window search has ties on most lanes) and the fused kernel's tiers
(`fits_voronoi_cells`: its dedup rule certifies other rows than the clip
builder's). What it drops: the TPU's attempt ladders and `_dispatch_cells`
(a kernel that fails to build or launch raises; `_cells_blocked` routes the
search and the builder), the scoped-VMEM fit models of the search, and the
128-lane rounding of window starts.

Frames are a batch dimension, and there is one tier ladder, the frame
batch's: tier 1 of a frame batch is one search launch and one batched cell
build (`_tier1_frames_local`), each escalation tier one more
(`_escalate_frames_batched`), then the host close per frame
(`_host_close`), for volumes and contacts alike. The per-frame entry points
(`voronoi_cells_device`, `voronoi_volumes_hybrid`,
`voronoi_contacts_hybrid`, the JAX package's API) are batches of one
frame. The clip builder works on blocks of rows; its sums over
edges and faces are taken in a fixed order, so a row's moments do not
depend on the block it lies in, the frame batch, or the device. Its
products over xyz are written as sums (no matmul, so no TF32). float32 runs
everywhere (eps 1e-4); float64 runs on CPU tensors only (eps 1e-10), where
the kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import itertools
from collections.abc import Mapping
from functools import lru_cache

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.clock import resolve_device, stage_end
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import voronoi_cells as vcells
from waterorderlib_tpu_torch.ops.cuda import voronoi_topk as vtopk
from waterorderlib_tpu_torch.utils.logging import log_once

# Far parking distance for unused candidate slots (mirror set is always
# >= 3 points, so slots only go unused for tiny inputs).
_FAR = 1.0e6
# the clip interval's "no bound" sentinel
_BIG = 3.0e37
# "clip" (the default, as in the JAX package), "pallas" (the fused dedup
# rule of ops/cuda/voronoi_cells.py, at the tiers it fits) or "triple"
DEFAULT_CELL_IMPL = "clip"
CELL_IMPLS = ("clip", "pallas", "triple")
# escalation ladder and the wide tier-1 alternative, as in the JAX package
DEFAULT_TIERS = ((32, 64), (48, 96), (64, 128), (96, 192), (128, 256))
WIDE_TIERS = ((40, 96), (48, 96), (64, 128), (96, 192), (128, 256))
# bytes of clip-builder intermediates per block of rows
CLIP_BLOCK_BYTES = {"cuda": 1 << 32, "cpu": 1 << 27}



class _TierStats(Mapping):
    """`tier_stats`: per (k, k_search) tier since the last `clear()`, the
    search form and the builder that served it, launches of its search,
    rows searched (bucket padding included), rows certified there; and
    "host": rows closed on the host, of them by a full host search. The
    numbers read the registry's counters `voronoi:<k>x<k_search>:<name>`
    and `voronoi:host:<name>` (core/clock.py) from the last clear on."""

    def __init__(self):
        self._entries: dict = {}  # key -> {name: label string or counter name}
        self._base: dict = {}  # counter totals at the last clear

    def add(self, key, **add):
        """Add counts (numbers) to, or set labels (strings) in, self[key]."""
        entry = self._entries.setdefault(key, {})
        tag = "host" if key == "host" else f"{key[0]}x{key[1]}"
        for name, v in add.items():
            if isinstance(v, str):
                entry[name] = v
            else:
                entry.setdefault(name, f"voronoi:{tag}:{name}")
                clock.count(entry[name], v)

    def clear(self) -> None:
        self._entries.clear()
        self._base = clock.totals()

    def __getitem__(self, key):
        return {name: v if name in ("form", "cells") else clock.total(v) - self._base.get(v, 0)
                for name, v in self._entries[key].items()}

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return repr(dict(self.items()))


tier_stats = _TierStats()
_count = tier_stats.add


def _not_ported(mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: torch.distributed scale-out is ROADMAP queue 1 item 15")


def _check_cell_impl(cell_impl: str) -> None:
    """Raise on an unknown builder; warn once if it is the triple builder."""
    if cell_impl not in CELL_IMPLS:
        raise ValueError(f"cell_impl must be one of {CELL_IMPLS}, got {cell_impl!r}")
    _warn_triple_once(cell_impl)


def _tier_impl(cell_impl: str, k: int, k_search: int) -> str:
    """The builder that serves a (k, k_search) tier: the fused rule where
    the JAX package's fit predicate holds for it, the clip builder
    elsewhere under "pallas". Where its rows run (the cell kernel or
    PyTorch) is `_cell_kernel_mode`'s to say."""
    if cell_impl == "pallas" and not vcells.fits_voronoi_cells(k, k_search):
        return "clip"
    return cell_impl


def _tiers_for(cell_impl: str, tiers):
    """The triple builder is O(C(k,3) k): the (96, 192) and (128, 256) rescue
    tiers are the clip builder's alone, as in the JAX package."""
    return tuple(t for t in tiers if t[0] <= 64) if cell_impl == "triple" else tuple(tiers)


@lru_cache(maxsize=8)
def _pair_tables(k: int):
    """Static pair-level index tables for K planes: pairs, pairs-per-face,
    and the opposing face of each pair."""
    prs = np.array(list(itertools.combinations(range(k), 2)), np.int32)
    face_pairs = np.zeros((k, k - 1), np.int32)
    face_other = np.zeros((k, k - 1), np.int32)
    cnt = np.zeros(k, np.int64)
    for p, (i, j) in enumerate(prs):
        face_pairs[i, cnt[i]] = p
        face_other[i, cnt[i]] = j
        cnt[i] += 1
        face_pairs[j, cnt[j]] = p
        face_other[j, cnt[j]] = i
        cnt[j] += 1
    return prs, face_pairs, face_other


@lru_cache(maxsize=8)
def _park_directions(k: int) -> np.ndarray:
    """Distinct unit directions (golden spiral) to park unused slots on, so
    parked planes are never near-parallel."""
    i = np.arange(k) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / k)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1
    )


def _park(rel_all):
    """The parked positions of (..., K_search, 3) slots: K_search distinct
    directions at _FAR."""
    dtype, dev = rel_all.dtype, rel_all.device
    return torch.as_tensor(_park_directions(rel_all.shape[-2]), dtype=dtype, device=dev) * \
        torch.tensor(_FAR, dtype=dtype, device=dev)


def _box(box_l, points):
    """box_l as a tensor of the points' dtype that broadcasts against
    (..., P, 3): a number, or one edge per frame of the batch."""
    b = torch.as_tensor(box_l, dtype=points.dtype, device=points.device)
    return b.reshape(b.shape + (1, 1)) if b.dim() else b


def _as_points(points, device) -> torch.Tensor:
    """Coordinates as a tensor on `device`: float64 stays float64 (CPU
    only: the kernel takes float32), everything else is float32."""
    src = points if torch.is_tensor(points) else np.asarray(points)
    dtype = torch.float64 if torch.as_tensor(src).dtype == torch.float64 else torch.float32
    return clock.to_device(src, dtype, device).contiguous()


def mirror_points_device(points, box_l):
    """points (..., P, 3) followed by their nearer-face reflections per axis
    (..., 4P, 3) — the reference's boundary treatment
    (orderParam_lib.py:926-950) with no margin pruning. box_l: a number, or
    (...,) per frame."""
    box = _box(box_l, points)
    hi = points >= 0.5 * box
    near = torch.where(hi, 2.0 * box - points, -points)
    out = [points]
    for ax in range(3):
        m = points.clone()
        m[..., ax] = near[..., ax]
        out.append(m)
    return torch.cat(out, dim=-2)


def _suggest_win_subset(
    n_real: int, box_l: float, k_search: int, n_rows: int
) -> int:
    """Window size for an escalation subset's top-K search (full 4P mirror
    set): each z-sorted 128-row block spans ~128/n_rows of the z range,
    plus the 2*1.6*d_K reach on each side. 0 (full scan) when the window
    would not shrink the scan."""
    if n_real <= 0 or box_l <= 0:
        return 0
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    span = min(1.0, 128.0 / max(n_rows, 128))
    frac = min(1.0, span + 2.0 * 1.6 * d_k / box_l)
    p4 = 4 * n_real
    slab = n_real + (2.0 / 3.0) * (p4 - n_real)
    win = int(-(-(1.07 * slab * frac) // 128) * 128)
    if win >= 0.75 * p4:
        return 0
    return win


def _quantize_win(win: int, p4: int) -> int:
    """Round an escalation-window suggestion up to a coarse p4/16 grid
    (512-aligned) and veto it when it no longer shrinks the scan. The JAX
    package quantizes to bound its recompiles; the port keeps it because
    the quantized window, with the bucket-padded rows, decides which rows
    a tier covers (at most ~6% overscan)."""
    if win <= 0:
        return 0
    step = max(512, -(-(p4 // 16) // 512) * 512)
    q = -(-win // step) * step
    if q >= 0.75 * p4:
        return 0
    return q


def _suggest_mirror_budget(n_real: int, box_l: float, k_search: int) -> int:
    """Mirror-slot budget for `mirror_points_pruned`, or 0 to keep the full
    4P set: the effective margin lands around 1.35x the expected
    k_search-th neighbor distance."""
    if n_real <= 0 or box_l <= 0:
        return 0
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    frac = min(1.0, 2.0 * 1.35 * d_k / box_l)
    m = int(-(-(3.0 * n_real * frac) // 128) * 128)
    # pruning must buy a real reduction to be worth the certificate risk
    if m >= 0.7 * 3 * n_real:
        return 0
    return m


def mirror_points_pruned(points, box_l, budget: int):
    """Points (..., P, 3) followed by the `budget` shallowest of the 3P
    single-axis reflections (depth = the source point's distance from the
    reflecting face): the first `budget` of a stable ascending sort of
    depth, which is what `lax.top_k(-depth)` selects.

    Returns (ext (..., P+budget, 3), ext_map (..., P+budget) int32 — each
    slot's index in the full 4P `mirror_points_device` layout — and
    margin_eff (...,), the depth of the deepest selected mirror: every
    excluded mirror lies at >= margin_eff from every in-box point)."""
    box = _box(box_l, points)
    p_real = points.shape[-2]
    lead = points.shape[:-2]
    hi = points >= 0.5 * box
    near = torch.where(hi, 2.0 * box - points, -points)
    depth = torch.minimum(points, box - points)  # (..., P, 3) per-axis face depth
    mirrors = []
    for ax in range(3):
        m = points.clone()
        m[..., ax] = near[..., ax]
        mirrors.append(m)
    mir = torch.cat(mirrors, dim=-2)  # (..., 3P, 3) — index ax*P + i
    dep = depth.transpose(-1, -2).reshape(*lead, 3 * p_real)  # matching ax*P + i
    dsort, order = torch.sort(dep, dim=-1, stable=True)
    sel = order[..., :budget]
    margin_eff = dsort[..., budget - 1]
    picked = torch.gather(mir, -2, sel[..., None].expand(*sel.shape, 3))
    ext = torch.cat([points, picked], dim=-2)
    ids = torch.arange(p_real, device=points.device).expand(*lead, p_real)
    ext_map = torch.cat([ids, p_real + sel], dim=-1).to(torch.int32)
    return ext, ext_map, margin_eff


def _suggest_win(n_real: int, p4: int, box_l: float, k_search: int) -> int:
    """Window size covering ~2.7x the expected K_search-th neighbor distance
    in z on each side (x/y mirrors of in-slab points share their z, hence
    the 3x multiplier on the in-slab count)."""
    if n_real <= 0 or box_l <= 0:
        return p4
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    frac = min(1.0, 2.0 * 1.6 * d_k / box_l)
    slab_density = n_real + (2.0 / 3.0) * max(p4 - n_real, 0)
    win = int(-(-(1.07 * slab_density * frac) // 128) * 128)
    win = max(win, min(p4, 1024))
    # a window covering most of the set saves nothing: scan everything
    if win >= 0.75 * p4:
        return p4
    return win


def _suggest_cellgrid(
    n_real: int, box_l: float, k_search: int, s_factor: float = 1.12
):
    """(n_side, cap) for the 3-D cell-grid candidate search, or None when a
    grid would not beat the z-window scan it replaces. The grid edge is
    ~s_factor x the expected k_search-th neighbor distance; cap carries ~6
    Poisson sigmas of occupancy headroom."""
    if n_real < 3072 or box_l <= 0:
        return None
    rho = n_real / box_l**3
    d_k = (3.0 * k_search / (4.0 * np.pi * max(rho, 1e-12))) ** (1.0 / 3.0)
    n_side = int(box_l / (s_factor * d_k)) + 2
    if n_side < 5:
        return None  # grid coarser than ~3 cells across: no pruning to win
    s = box_l / (n_side - 2)
    occ = rho * s**3
    cap = int(-(-(occ + 6.0 * occ**0.5 + 4.0) // 8) * 8)
    win = _suggest_win(n_real, 4 * n_real, box_l, k_search)
    if 27 * cap >= 0.7 * win:
        return None
    return n_side, cap


# --- arithmetic of the clip builder ---------------------------------------


def _sqrt(x):
    return sqrt_f32(x) if x.dtype == torch.float32 else torch.sqrt(x)


def _dot3_planes(a, b):
    """Sum over xyz of a * b, the operands given as their three coordinate
    planes a[c], b[c]: (a0*b0 + a1*b1) + a2*b2."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _dot3(a, b):
    return _dot3_planes(a.unbind(-1), b.unbind(-1))


def _nrm(v):
    return _sqrt(_dot3(v, v))


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _fsum(x, dim):
    """Sum over `dim` left to right: the same order on every device and for
    every shape of the other axes."""
    parts = x.unbind(dim)
    if not parts:
        return x.sum(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _nanmedian(x):
    """numpy's nanmedian over the last axis (jnp.nanmedian: the midpoint of
    the two middle order statistics), NaN where a row has no number."""
    n = (~torch.isnan(x)).sum(-1)
    srt = torch.sort(x, dim=-1).values  # NaNs sort last
    last = x.shape[-1] - 1
    lo = srt.gather(-1, ((n - 1) // 2).clamp(0, last)[..., None])[..., 0]
    hi = srt.gather(-1, (n // 2).clamp(0, last)[..., None])[..., 0]
    med = (lo + hi) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _rows_prep(rel_all, slot_ok, k: int, eps: float):
    """What both cell builders take from a block of rows: rel_all (B,
    K_search, 3) with its padding slots parked, s_all = |r|^2 / 2, the
    representative scale s_scale (the median candidate's s, not the min: a
    boundary atom's nearest candidate is its own mirror, arbitrarily near),
    tol = eps * s_scale and r_len_all = |r|."""
    rel_all = torch.where(slot_ok[..., None], rel_all, _park(rel_all))
    s_all = 0.5 * _dot3(rel_all, rel_all)
    s_med = _nanmedian(torch.where(slot_ok, s_all, torch.full_like(s_all, float("nan"))))
    s_scale = torch.where(torch.isfinite(s_med), s_med, torch.ones_like(s_med))
    return rel_all, s_all, s_scale, eps * s_scale, _nrm(rel_all)


def _cell_moments_clip(rel_all, slot_ok, k: int, eps: float, is_boundary=None):
    """Moments of a block of Voronoi cells by 1-D line clipping.

    rel_all: (B, K_search, 3) relative candidate positions (nearest first);
    slot_ok: (B, K_search) False for padding slots. Each of the C(k,2)
    plane pairs' intersection lines is clipped against the k build planes;
    the feasible interval is the cell edge and its endpoints are the cell's
    vertices. Planes k..K_search only check: `extra_cut` is set if one cuts
    a feasible endpoint. is_boundary (B,) bool: dedup edges only on these
    rows and the tangent ones (the fused kernel's rule, see
    `_faces_from_edges`); None dedups every row. Returns a dict of per-cell
    quantities: vol, area, face_area (B, k), face_nverts (B, k), r_cell and
    the flags."""
    prs, face_pairs, face_other = _pair_tables(k)
    dtype, dev = rel_all.dtype, rel_all.device
    rel_all, s_all, s_scale, tol, r_len_all = _rows_prep(rel_all, slot_ok, k, eps)
    rel, s, r_len = rel_all[:, :k], s_all[:, :k], r_len_all[:, :k]

    pi = torch.as_tensor(prs[:, 0], dtype=torch.long, device=dev)
    pj = torch.as_tensor(prs[:, 1], dtype=torch.long, device=dev)
    ri, rj = rel[:, pi], rel[:, pj]  # (B, P, 3)
    si, sj = s[:, pi], s[:, pj]
    t = _cross(ri, rj)
    tsq = _dot3(t, t)
    pair_ok = _sqrt(tsq) > eps * _nrm(ri) * _nrm(rj)
    tsq_safe = torch.where(pair_ok, tsq, torch.ones_like(tsq))
    # q: the point of the line in span(r_i, r_j) — q.r_i = s_i, q.r_j = s_j
    q = (si[..., None] * _cross(rj, t) + sj[..., None] * _cross(t, ri)) / tsq_safe[..., None]
    that = t / _sqrt(tsq_safe)[..., None]  # unit direction: u in length units

    # line-vs-plane coefficients for all K_search planes: build planes clip,
    # extra planes only check; true float32 products (no matmul)
    r_c = rel_all.movedim(-1, 0).contiguous()[:, :, None, :]  # (3, B, 1, K_search)
    A = _dot3_planes(that.movedim(-1, 0)[..., None], r_c)  # (B, P, K_search)
    Bm = s_all[:, None, :] - _dot3_planes(q.movedim(-1, 0)[..., None], r_c)
    qn = _nrm(q)
    athr = eps * r_len_all[:, None, :]  # |t_hat| = 1
    tol_b = eps * (s_all[:, None, :] + qn[..., None] * r_len_all[:, None, :])

    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    Ab, Bb = A[..., :k], Bm[..., :k]
    denom_ok = Ab.abs() > athr[..., :k]
    ratio = Bb / torch.where(denom_ok, Ab, torch.ones_like(Ab))
    ub = torch.where(denom_ok & (Ab > 0), ratio, big)
    lb = torch.where(denom_ok & (Ab < 0), ratio, -big)
    # a plane (near-)parallel to the line either misses it or excludes it
    par_bad = ~denom_ok & (Bb < -tol_b[..., :k])
    u_hi = ub.amin(-1)
    u_lo = lb.amax(-1)
    feas = (
        pair_ok
        & ~par_bad.any(-1)
        & (u_hi < 0.5 * big)
        & (u_lo > -0.5 * big)
        & (u_hi >= u_lo)
    )
    v1 = q + u_lo[..., None] * that  # (B, P, 3)
    v2 = q + u_hi[..., None] * that
    vmax = torch.maximum(_nrm(v1), _nrm(v2))
    r_cell = torch.where(feas, vmax, torch.zeros_like(vmax)).amax(-1)

    # beyond-build planes vs every feasible endpoint (== every vertex)
    s1 = Bm[..., k:] - u_lo[..., None] * A[..., k:]
    s2 = Bm[..., k:] - u_hi[..., None] * A[..., k:]
    tol_e = eps * (s_all[:, None, k:] + vmax[..., None] * r_len_all[:, None, k:])
    extra_cut = (feas[..., None] & ((s1 < -tol_e) | (s2 < -tol_e))).flatten(1).any(-1)

    return _faces_from_edges(
        rel, r_len, v1, v2, feas, r_cell, extra_cut, tol, s_scale, eps, face_pairs, face_other,
        is_boundary,
    )


@lru_cache(maxsize=4)
def _triple_tables(k: int):
    """The triple builder's static tables for K planes: the C(k,3) plane
    triples, and for each plane pair the k-2 triples that hold it."""
    prs = _pair_tables(k)[0]
    tri = np.array(list(itertools.combinations(range(k), 3)), np.int32)
    pair_id = {(int(i), int(j)): p for p, (i, j) in enumerate(prs)}
    pair_tri = np.zeros((len(prs), k - 2), np.int32)
    fill = np.zeros(len(prs), np.int64)
    for t, (a, b, c) in enumerate(tri):
        for ij in ((a, b), (a, c), (b, c)):
            p = pair_id[(int(ij[0]), int(ij[1]))]
            pair_tri[p, fill[p]] = t
            fill[p] += 1
    return tri, pair_tri


def _cell_moments_triple(rel_all, slot_ok, k: int, eps: float):
    """The legacy triple builder (the JAX package's `_cell_moments`), on a
    block of rows: every plane triple's vertex by Cramer's rule, kept if it
    lies inside all k build planes; each pair's edge runs between its
    extreme kept vertices along r_i x r_j. Same contract as
    `_cell_moments_clip` (dedup on every row); O(C(k,3) k) work."""
    prs, face_pairs, face_other = _pair_tables(k)
    tri, pair_tri = _triple_tables(k)
    dtype, dev = rel_all.dtype, rel_all.device
    rel_all, s_all, s_scale, tol, r_len_all = _rows_prep(rel_all, slot_ok, k, eps)
    rel, s, r_len = rel_all[:, :k], s_all[:, :k], r_len_all[:, :k]

    ta, tb, tc = (torch.as_tensor(tri[:, c], dtype=torch.long, device=dev) for c in range(3))
    ra, rb, rc = rel[:, ta], rel[:, tb], rel[:, tc]  # (B, C, 3)
    cbc, cca, cab = _cross(rb, rc), _cross(rc, ra), _cross(ra, rb)
    det = _dot3(ra, cbc)
    ok_det = det.abs() > eps * (r_len[:, ta] * r_len[:, tb] * r_len[:, tc])
    num = s[:, ta, None] * cbc + s[:, tb, None] * cca + s[:, tc, None] * cab
    X = num / torch.where(ok_det, det, torch.ones_like(det))[..., None]  # (B, C, 3)

    Xc = X.movedim(-1, 0)[..., None]  # (3, B, C, 1)
    r_c = rel_all.movedim(-1, 0).contiguous()[:, :, None, :]  # (3, B, 1, K_search)
    vnorm = _nrm(X)
    # slack >= 0 inside, with a tolerance scaled by the operands' magnitudes
    slack_build = s[:, None, :] - _dot3_planes(Xc, r_c[..., :k])  # (B, C, k)
    tol_build = eps * (s[:, None, :] + vnorm[..., None] * r_len[:, None, :])
    vert_ok = ok_det & (slack_build >= -tol_build).all(-1)
    r_cell = torch.where(vert_ok, vnorm, torch.zeros_like(vnorm)).amax(-1)
    slack_extra = s_all[:, None, k:] - _dot3_planes(Xc, r_c[..., k:])
    tol_extra = eps * (s_all[:, None, k:] + vnorm[..., None] * r_len_all[:, None, k:])
    extra_cut = (vert_ok[..., None] & (slack_extra < -tol_extra)).flatten(1).any(-1)

    # each pair's k-2 candidate vertices: the static triples that hold it
    pt = torch.as_tensor(pair_tri, dtype=torch.long, device=dev)
    Xp, vp = X[:, pt], vert_ok[:, pt]  # (B, P, k-2, 3), (B, P, k-2)
    pi = torch.as_tensor(prs[:, 0], dtype=torch.long, device=dev)
    pj = torch.as_tensor(prs[:, 1], dtype=torch.long, device=dev)
    tdir = _cross(rel[:, pi], rel[:, pj])  # (B, P, 3)
    u = _dot3(Xp, tdir[:, :, None, :])
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    j_lo = torch.where(vp, u, big).argmin(-1)
    j_hi = torch.where(vp, u, -big).argmax(-1)
    v1 = torch.gather(Xp, 2, j_lo[..., None, None].expand(*j_lo.shape, 1, 3))[:, :, 0]
    v2 = torch.gather(Xp, 2, j_hi[..., None, None].expand(*j_hi.shape, 1, 3))[:, :, 0]
    edge_ok = vp.sum(-1) >= 2
    return _faces_from_edges(
        rel, r_len, v1, v2, edge_ok, r_cell, extra_cut, tol, s_scale, eps, face_pairs, face_other,
    )


def _warn_triple_once(cell_impl: str) -> None:
    """The triple builder's certificate is softer than the clip builder's
    (worst certified float32 relative volume error 3.7e-3 against 9.8e-4 in
    the JAX package's multi-seed measurement): say so once per process."""
    if cell_impl == "triple":
        log_once(
            ("voronoi_triple_bound",),
            "cell_impl='triple' carries a ~4x looser certified f32 error "
            "bound than the default 'clip' builder (worst certified relative "
            "volume error 3.7e-3 vs 9.8e-4 across seeds); 'triple' is kept "
            "as a cross-check oracle — use the default for production "
            "accuracy",
            level="warning",
        )


def _gather_last(v, order):
    """v (B, K, E, 3) at the edges `order` (B, K, M) of each face."""
    return torch.gather(v, 2, order[..., None].expand(*order.shape, 3))


def _dedup_edges(V1, V2, eok, htol):
    """eok (B, K, E) without the edges whose endpoints (V1, V2 (B, K, E, 3))
    match, within htol (B,) in each coordinate and in either direction, an
    earlier edge j' < j of the same face. Only edges take part, so each
    face's edges are first packed to the front in order (M of them at
    most) and compared (B, K, M, M) instead of (B, K, E, E), in steps of
    rows that bound the comparison's memory."""
    dev = eok.device
    m_edges = int(eok.sum(-1).max()) if eok.numel() else 0
    order = torch.argsort((~eok).to(torch.int8), dim=-1, stable=True)[..., :m_edges]
    V1c, V2c = _gather_last(V1, order), _gather_last(V2, order)
    eokc = torch.gather(eok, -1, order)
    earlier = torch.tril(torch.ones(m_edges, m_edges, dtype=torch.bool, device=dev), -1)  # j' < j
    B, K = eok.shape[:2]
    budget = CLIP_BLOCK_BYTES["cuda" if dev.type == "cuda" else "cpu"] // 8
    step = max(1, budget // max(1, 4 * 4 * K * m_edges * m_edges))

    def close(P, Q, tol):  # (b, K, M, M): edge j's endpoint vs edge j''s endpoint
        m = None
        for c in range(3):
            d = (P[:, :, :, None, c] - Q[:, :, None, :, c]).abs()
            m = d if m is None else torch.maximum(m, d)
        return m <= tol[:, None, None, None]

    keep = []
    for s in range(0, B, step):
        a, b, t = V1c[s : s + step], V2c[s : s + step], htol[s : s + step]
        dup = (close(a, a, t) & close(b, b, t)) | (close(a, b, t) & close(b, a, t))
        taken = dup & earlier & eokc[s : s + step, :, None, :]
        keep.append(eokc[s : s + step] & ~taken.any(-1))
    kept = torch.cat(keep) if keep else eokc
    return torch.zeros_like(eok).scatter(-1, order, kept)


def _face_sums(civ, tvec, sign, nhat, eok):
    """Per-face sums over the edges eok (B, K, E) in slot order: vector
    area (B, K, 3), polygon gap (B, K), signed area (B, K), edge count."""
    w = torch.where(eok, sign, torch.zeros_like(sign))
    vec_area = _fsum(civ * w[..., None], 2)  # (B, K, 3)
    # per-face polygon closure: a lost or mis-extreme endpoint breaks the sum
    face_gap = _nrm(_fsum(tvec * w[..., None], 2))  # (B, K)
    return vec_area, face_gap, _dot3(vec_area, nhat), eok.sum(-1)


def _faces_from_edges(
    rel, r_len, v1, v2, edge_ok, r_cell, extra_cut, tol, s_scale, eps, face_pairs, face_other,
    is_boundary=None,
):
    """Face areas, closure certificates and cell moments from a block of
    cells' per-pair edge segments. v1/v2: (B, P, 3) edge endpoints per
    plane pair; edge_ok: (B, P) which pairs carry a real segment.

    Endpoint dedup: with is_boundary None, on every row (the clip
    builder). Otherwise the fused kernel's rule: the face sums are taken
    without dedup, and only rows that are boundary (is_boundary) or tangent
    (a face of >= 2 edges and signed area <= tol: a plane touching the cell
    along an edge) take the dedup and new sums. Duplicate edges need such a
    plane, and the tangency test is what keeps a perfect lattice's uniform
    duplication (closure stays 0, the volume scales) from certifying."""
    dtype, dev = rel.dtype, rel.device
    fp = torch.as_tensor(face_pairs, dtype=torch.long, device=dev)
    fo = torch.as_tensor(face_other, dtype=torch.long, device=dev)
    # per-face vector areas from locally oriented edge triangles
    V1 = v1[:, fp]  # (B, K, K-1, 3)
    V2 = v2[:, fp]
    eok = edge_ok[:, fp]  # (B, K, K-1)
    rj = rel[:, fo]  # (B, K, K-1, 3)
    tvec = V2 - V1

    # Deduplicate each face's edges by endpoint identity: mirror candidates
    # make face-plane vertices exactly degenerate, so several plane pairs
    # can carry the same geometric edge (see the JAX package's comments).
    len_scale = _sqrt(2.0 * s_scale)
    htol = 20.0 * torch.tensor(eps, dtype=dtype, device=dev) * len_scale  # (B,)
    tlen = _nrm(tvec)
    eok = eok & (tlen > htol[:, None, None])  # zero-length point-touch "edges"

    orient = _dot3(_cross(rel[:, :, None, :], tvec), rj)  # >0: v1->v2 runs the wrong way
    sign = torch.where(orient > 0, -1.0, 1.0).to(dtype)
    q = 0.5 * rel  # a point on each face's plane
    civ = 0.5 * _cross(V1 - q[:, :, None, :], V2 - q[:, :, None, :])
    nhat = rel / r_len[..., None]
    if is_boundary is None:
        eok = _dedup_edges(V1, V2, eok, htol)
        vec_area, face_gap, raw_area, nedges_raw = _face_sums(civ, tvec, sign, nhat, eok)
    else:
        sums = _face_sums(civ, tvec, sign, nhat, eok)
        tangent = ((sums[3] >= 2) & (sums[2] <= tol[:, None])).any(-1)
        need = torch.nonzero(is_boundary | tangent)[:, 0]
        if len(need):
            eok_n = _dedup_edges(V1[need], V2[need], eok[need], htol[need])
            part = _face_sums(civ[need], tvec[need], sign[need], nhat[need], eok_n)
            sums = tuple(x.index_put((need,), y) for x, y in zip(sums, part))
        vec_area, face_gap, raw_area, nedges_raw = sums
    # a real face has a closed polygon: >= 3 edges
    face_real = (nedges_raw >= 3) & (raw_area > tol[:, None])
    face_area = torch.where(face_real, raw_area, torch.zeros_like(raw_area))
    face_nverts = torch.where(face_real, nedges_raw, torch.zeros_like(nedges_raw))

    area = _fsum(face_area, 1)
    # sum A_f * (|r_f|/2) / 3, a true division on every device (CUDA turns a
    # division by a Python number into a product with its reciprocal)
    vsum = _fsum(face_area * r_len, 1)
    vol = vsum / torch.full_like(vsum, 6.0)
    real_area = torch.where(face_real[..., None], vec_area, torch.zeros_like(vec_area))
    closure = _nrm(_fsum(real_area, 1))
    # closure <= 20*eps*area keeps certified f32 cells within ~0.2% of exact
    closure_tol = torch.maximum(torch.tensor(20.0 * eps, dtype=dtype, device=dev),
                                torch.tensor(1e-6, dtype=dtype, device=dev))
    closed = closure <= closure_tol * torch.clamp(area, min=1e-6)
    # phantom faces (< 3 edges) carry junk signed areas: only >= 3-edge
    # faces veto via negativity
    any_negative = (
        (nedges_raw >= 3) & (raw_area < -_sqrt(tol)[:, None] * torch.clamp(area, min=1.0)[:, None])
    ).any(-1)
    # a genuine polygon's gap is a few htol at most; larger is a broken face
    face_open = (face_real & (face_gap > 8.0 * htol[:, None])).any(-1)
    ok_shape = closed & ~any_negative & (vol > 0) & ~extra_cut & ~face_open
    return {
        "vol": vol,
        "area": area,
        "face_area": face_area,
        "face_nverts": face_nverts.to(torch.int32),
        "r_cell": r_cell,
        "ok_shape": ok_shape,
        "closure_err": closure,
        "extra_cut": extra_cut,
        "neg_face": any_negative,
    }


def _cell_block_rows(k: int, k_search: int, device, triple: bool = False) -> int:
    """Rows per block of a cell builder. The clip builder's largest
    intermediates are the (P, K_search) line-plane tables, some 12 alive at
    once, and the (k, k-1, 3) edge tables (the endpoint comparisons go in
    steps of their own, `_dedup_edges`); the triple builder's are its
    (C(k,3), K_search) slack tables and the (P, k-2, 3) vertex gathers."""
    p = k * (k - 1) // 2
    per_row = 4 * (12 * p * k_search + 40 * k * (k - 1))
    if triple:
        per_row += 4 * (8 * (k * (k - 1) * (k - 2) // 6) * k_search + 8 * p * (k - 2))
    budget = CLIP_BLOCK_BYTES["cuda" if torch.device(device).type == "cuda" else "cpu"]
    return max(1, budget // per_row)


def _clip_cells(rel_all, slot_ok, k: int, eps: float, is_boundary=None,
                builder=_cell_moments_clip) -> dict:
    """A cell builder (`_cell_moments_clip`, with `is_boundary` when given,
    or `_cell_moments_triple`) over any number of rows, block by block."""
    n = rel_all.shape[0]
    step = _cell_block_rows(k, rel_all.shape[1], rel_all.device,
                            triple=builder is _cell_moments_triple)

    def block(s):
        args = (rel_all[s : s + step], slot_ok[s : s + step], k, eps)
        if is_boundary is not None:
            args += (is_boundary[s : s + step],)
        return builder(*args)

    parts = [block(s) for s in range(0, n, step)] or [block(0)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


# --- the K-nearest search -------------------------------------------------


def _gather_rows(x, idx):
    """x (F, N, ...) gathered along N by idx (F, ...) of any shape."""
    F = x.shape[0]
    flat = idx.reshape(F, -1).long()
    out = torch.gather(x, 1, flat.reshape(F, -1, *([1] * (x.dim() - 2))).expand(
        F, flat.shape[1], *x.shape[2:]))
    return out.reshape(*idx.shape, *x.shape[2:])


def _window_prep(centers, ext, row_block, win):
    """The z-window search's sorts and block starts for a frame batch:
    (orde (F, p4) the stable z-argsort of ext, exts (F, p4, 3) ext in that
    order, ordc (F, num) the stable z-argsort of the centers, cs (F, R, 3)
    the sorted centers padded with copies of the last to R, a multiple of
    row_block, start (F, R / row_block) int64: searchsorted of each block's
    middle row's z, minus win // 2, clipped to [0, p4 - win])."""
    F, p4 = ext.shape[0], ext.shape[1]
    orde = torch.argsort(ext[..., 2], dim=-1, stable=True)  # (F, p4)
    exts = _gather_rows(ext, orde).contiguous()
    num = centers.shape[1]
    ordc = torch.argsort(centers[..., 2], dim=-1, stable=True)
    cs = _gather_rows(centers, ordc)
    pad = (-num) % row_block
    if pad:
        cs = torch.cat([cs, cs[:, -1:].expand(F, pad, 3)], dim=1)
    cs = cs.contiguous()
    z_mid = cs[:, row_block // 2 :: row_block, 2].contiguous()  # (F, n_blocks)
    start = torch.clamp(torch.searchsorted(exts[..., 2].contiguous(), z_mid) - win // 2, 0,
                        p4 - win)
    return orde, exts, ordc, cs, start


def _windowed_topk(centers, ext, k_search, row_block, win):
    """K-nearest mirrored candidates via a z-sorted sliding window, for a
    frame batch: centers (F, num, 3), ext (F, p4, 3).

    Centers are processed in z-sorted blocks of `row_block`; each block
    scans one contiguous `win`-candidate slice of the z-sorted mirror set,
    started as the JAX package's `_windowed_topk` starts it (searchsorted
    of the block's middle row, minus win//2, clipped). Per-row coverage:
    the window's z extent reaches d_K beyond the center on each side (or
    the array end), and every slot filled. win >= p4 (or None) is the full scan: the JAX
    package's `topk_neighbors` branch, every row covered, empty slots' ids 0.

    Returns (dist (F, num, K), idx (F, num, K) int32 into ext, valid,
    covered (F, num))."""
    F, p4 = ext.shape[0], ext.shape[1]
    full = win is None or win >= p4
    win = p4 if full else int(win)
    orde, exts, ordc, cs, start = _window_prep(centers, ext, row_block, win)
    ez = exts[..., 2]
    num = centers.shape[1]
    dist, pos = vtopk.voronoi_window_topk(cs, exts, start.to(torch.int32), k_search, row_block,
                                          win)
    slot_ok = torch.isfinite(dist)
    st = start.repeat_interleave(row_block, dim=1)  # (F, R) each row's start
    at = torch.where(slot_ok, pos.long(), st[..., None])
    gidx = torch.gather(orde, 1, at.reshape(F, -1)).reshape(at.shape).to(torch.int32)
    if full:
        gidx = torch.where(slot_ok, gidx, torch.zeros_like(gidx))
        covered = torch.ones(slot_ok.shape[:2], dtype=torch.bool, device=ext.device)
    else:
        d_far = dist[..., -1]
        d_far = torch.where(torch.isfinite(d_far), d_far, torch.zeros_like(d_far))
        zr = cs[..., 2]
        z_lo = torch.gather(ez, 1, st)
        z_hi = torch.gather(ez, 1, st + win - 1)
        covered = (
            ((zr - z_lo >= d_far) | (st == 0))
            & ((z_hi - zr >= d_far) | (st + win == p4))
            # a partially-filled slot list means candidates beyond the
            # window's z extent were never seen — not coverable
            & slot_ok.all(-1)
        )
    # back to the original center order
    inv = torch.argsort(ordc, dim=-1)
    return tuple(_gather_rows(x[:, :num], inv) for x in (dist, gidx, slot_ok, covered))


def _cellgrid_build(ext, box_l, n_side: int, cap: int):
    """Bucket the mirrored candidate set of each frame into a per-cell
    table. The grid covers [-s, box_l + s] with n_side cells per axis (s =
    box_l / (n_side - 2)); candidates outside it are dropped (each is > s
    from every in-box center, so coverage caps at s where any was). After a
    stable sort by cell id each cell's members are one run.

    ext (F, p4, 3), box_l (F,). Returns (pos (F, n_cells, 3, cap) — per
    cell the planes x, y, z of its slots, +inf where empty; idx (F,
    n_cells, cap) int32 candidate ids, -1 where empty; overflow (F,
    n_cells) — cells with more than cap members; dropped (F,); s (F,))."""
    F, p4 = ext.shape[0], ext.shape[1]
    dtype, dev = ext.dtype, ext.device
    n_cells = n_side**3
    s = torch.as_tensor(box_l, dtype=dtype, device=dev).reshape(F) / (n_side - 2)
    g = torch.floor(ext / s[:, None, None]).to(torch.int32) + 1  # grid origin is -s
    ing = ((g >= 0) & (g < n_side)).all(-1)
    cid = (g[..., 2] * n_side + g[..., 1]) * n_side + g[..., 0]
    cid = torch.where(ing, cid, torch.full_like(cid, n_cells))  # sentinel: sorts to the tail
    order = torch.argsort(cid, dim=-1, stable=True)
    sc = torch.gather(cid, 1, order).contiguous()
    es = _gather_rows(ext, order)
    cells = torch.arange(n_cells, dtype=sc.dtype, device=dev).expand(F, n_cells).contiguous()
    start = torch.searchsorted(sc, cells)
    count = torch.searchsorted(sc, cells, right=True) - start
    overflow = count > cap
    slots = torch.arange(cap, device=dev)
    src = torch.clamp(start[..., None] + slots, 0, p4 - 1)  # (F, n_cells, cap)
    okslot = slots < count[..., None]
    pos = torch.where(okslot[..., None], _gather_rows(es, src),
                      torch.tensor(float("inf"), dtype=dtype, device=dev))
    idx = torch.where(okslot, _gather_rows(order, src), torch.full_like(src, -1))
    dropped = (sc >= n_cells).any(-1)
    return (pos.permute(0, 1, 3, 2).contiguous(), idx.to(torch.int32).contiguous(), overflow,
            dropped, s)


def _cellgrid_rows(centers, s, n_side: int):
    """Each center's grid cell (F, num, 3), clamped to [1, n_side - 2] so
    its 27 neighbors exist (the clamp only re-centers the neighborhood:
    `reach` is computed from the clamped cell), and its flat id (F, num)
    int32."""
    g = torch.clamp(torch.floor(centers / s[:, None, None]).to(torch.int32) + 1, 1, n_side - 2)
    return g, ((g[..., 2] * n_side + g[..., 1]) * n_side + g[..., 0]).contiguous()


def _cellgrid_topk(centers, grid, k_search, n_side: int):
    """K-nearest candidates of centers (F, num, 3) from the bucketed table
    of `_cellgrid_build`, each row over the 27 cells around its clamped
    cell, and the per-row coverage certificate: the 27-neighborhood covers
    the L-inf ball of radius `reach` around the center; the K-th distance
    must beat min(reach, s if any candidate was dropped), every slot fill,
    and no touched cell overflow. Returns (dist, idx, valid, covered)."""
    pos, tbl_idx, overflow, dropped, s = grid
    F, num = centers.shape[0], centers.shape[1]
    dtype = centers.dtype
    g, cid = _cellgrid_rows(centers, s, n_side)
    dist, gi = vtopk.voronoi_cellgrid_topk(centers.contiguous(), cid, pos, tbl_idx, n_side,
                                           k_search)
    valid = torch.isfinite(dist)
    gidx = torch.where(valid, gi, torch.zeros_like(gi))
    d_far = dist[..., -1]
    d_far = torch.where(torch.isfinite(d_far), d_far, torch.zeros_like(d_far))
    # gathered region per axis: [(g-2)s, (g+1)s) (cell g spans [-s + g*s, -s + (g+1)*s))
    gf = g.to(dtype)
    lo = (gf - 2.0) * s[:, None, None]
    hi = (gf + 1.0) * s[:, None, None]
    reach = torch.minimum((centers - lo).amin(-1), (hi - centers).amin(-1))
    bound = torch.where(dropped[:, None], torch.minimum(reach, s[:, None]), reach)
    off27 = torch.tensor(vtopk._offsets(n_side), dtype=torch.long, device=centers.device)
    cell27 = cid.long()[..., None] + off27  # (F, num, 27)
    ovf27 = torch.gather(overflow, 1, cell27.reshape(F, -1)).reshape(F, num, 27).any(-1)
    covered = (d_far < bound) & valid.all(-1) & ~ovf27
    return dist, gidx, valid, covered


# --- cells ------------------------------------------------------------------


def _search_rows(centers, ext, k_search, row_block, win=None, cg=None, box_l=None, stage=None):
    """Candidate search for a frame batch: centers (F, nc, 3), ext (F, p4,
    3). The cell-grid form when cg = (n_side, cap) is given (box_l (F,) the
    real box edges), else the z-window form (win >= p4 or None: the full
    scan). Returns the search's (dist, idx, valid, win_covered), its form,
    and each row's candidates relative to its center (F * nc, K_search, 3)."""
    if cg is not None:
        grid = _cellgrid_build(ext, box_l, cg[0], cg[1])
        if stage:
            stage_end("mirrors and grid")
        found = _cellgrid_topk(centers, grid, k_search, cg[0])
        form = "cellgrid"
    else:
        if stage:
            stage_end("mirrors and grid")
        found = _windowed_topk(centers, ext, k_search, row_block, win)
        form = "full" if win is None or win >= ext.shape[1] else "window"
    if stage:
        stage_end(f"{stage} search")
    rel_all = _gather_rows(ext, found[1]) - centers[:, :, None, :]  # (F, nc, K_search, 3)
    return found, form, rel_all.reshape(-1, k_search, 3)


def _fused_inputs(rel_all, ok, nbr_idx, k, p4, n_real=None):
    """The fused kernel's inputs for rows (R, K_search) of a search over
    ext (F, p4, 3): the candidates, parked where invalid, the valid mask,
    and each row's boundary flag, a mirror among its k build planes
    (nbr_idx, the search's ids, >= n_real on the pruned mirror set, else
    >= p4 // 4)."""
    mirror_start = p4 // 4 if n_real is None else n_real
    rel_parked = torch.where(ok[..., None], rel_all, _park(rel_all)).contiguous()
    return rel_parked, ok, (nbr_idx[:, :k] >= mirror_start).any(-1)


def _clip_on_kernel(device_type: str, dtype, k: int, k_search: int) -> bool:
    """Whether the clip builder's cells of a (k, k_search) tier come from
    the cell kernel in dedup mode "always", the clip builder's arithmetic
    to the bit: CUDA float32 rows at a shape the kernel holds ((32, 64),
    (40, 96), (48, 96) and (64, 128) of the ladders; (96, 192) and (128,
    256) stay in PyTorch, as do CPU and float64 rows)."""
    return (device_type == "cuda" and dtype == torch.float32 and k <= vcells.MAX_K
            and k_search <= vcells.MAX_KS)


def _cell_kernel_mode(impl: str, rel_all, k: int):
    """The dedup mode in which `voronoi_cells_fused` builds rows rel_all
    (R, K_search, 3) of builder `impl`, or None where the PyTorch builder
    does: "auto" under "pallas" (its plain version on CPU tensors),
    "always" for the clip builder's rows `_clip_on_kernel` admits."""
    if impl == "pallas":
        return "auto"
    if impl == "clip" and _clip_on_kernel(rel_all.device.type, rel_all.dtype, k,
                                          rel_all.shape[1]):
        return "always"
    return None


def _build_cells(rel_all, ok, nbr_idx, k, eps, impl, mode, p4, n_real):
    """Cells of rows (R, K_search) by builder `impl`: on `voronoi_cells_fused`
    in one launch on `_fused_inputs` in dedup mode `mode` (from
    `_cell_kernel_mode`), or where it is None the clip or triple builder
    block by block."""
    if mode is not None:
        return vcells.voronoi_cells_fused(*_fused_inputs(rel_all, ok, nbr_idx, k, p4, n_real), k,
                                          eps, dedup_mode=mode)
    return _clip_cells(rel_all, ok, k, eps,
                       builder=_cell_moments_triple if impl == "triple" else _cell_moments_clip)


def _cells_blocked(centers, ext, k, k_search, row_block, eps, win=None, cg=None, box_l=None,
                   stage=None, real=None, cell_impl=DEFAULT_CELL_IMPL, n_real=None):
    """Candidate search (`_search_rows`) and cells for a frame batch:
    centers (F, nc, 3), ext (F, p4, 3). `real` (F, nc) bool: the rows whose
    cells are wanted; the others (an escalation subset's bucket padding)
    take part in the search, where they shape the window blocks, and get
    zero cells. The cells come from `_tier_impl(cell_impl, ...)`'s
    builder; n_real: the points leading ext, below the mirrors (None: the
    full 4P layout, p4 // 4). `stage`: the stage-clock prefix of the search
    and cells steps, if any. Returns a dict of (F, nc, ...) tensors;
    `tier_stats` records the search form, the builder and the rows the
    CUDA cell kernel built (`kernel_rows`: the real rows, 0 where PyTorch
    built them)."""
    F, nc, p4 = centers.shape[0], centers.shape[1], ext.shape[1]
    (dist, idx, valid, win_cov), form, rel_all = _search_rows(centers, ext, k_search, row_block,
                                                               win, cg, box_l, stage)
    ok, ids = valid.reshape(F * nc, k_search), idx.reshape(F * nc, k_search)
    impl = _tier_impl(cell_impl, k, k_search)
    mode = _cell_kernel_mode(impl, rel_all, k)
    if real is None:
        out = _build_cells(rel_all, ok, ids, k, eps, impl, mode, p4, n_real)
        n_built = F * nc
    else:
        rows = torch.nonzero(real.reshape(-1))[:, 0]
        part = _build_cells(rel_all[rows], ok[rows], ids[rows], k, eps, impl, mode, p4, n_real)
        out = {}
        for key, v in part.items():
            out[key] = torch.zeros((F * nc, *v.shape[1:]), dtype=v.dtype, device=v.device)
            out[key][rows] = v
        n_built = len(rows)
    out = {key: v.reshape(F, nc, *v.shape[1:]) for key, v in out.items()}
    _count((k, k_search), form=form, cells=impl, launches=1, rows=F * nc,
           kernel_rows=n_built if rel_all.is_cuda and mode is not None else 0)
    if stage:
        stage_end(f"{stage} cells")
    out["nbr_dist"] = dist
    out["nbr_idx"] = idx
    out["nbr_valid"] = valid
    out["win_covered"] = win_cov
    return out


def _bucket(n: int) -> int:
    """The padded size of a subset of n rows: a power of two, at least 64."""
    return max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _bucket_pad(idx):
    """Row ids padded to `_bucket` with copies of the first, as the JAX
    package pads its subsets: the padded rows sit in the z-sorted row blocks
    and decide, with the window, their coverage. Returns (padded ids, count
    of real ones)."""
    idx = np.asarray(idx)
    n_want = len(idx)
    bucket = _bucket(n_want)
    fill = np.full(bucket - n_want, idx[0] if n_want else 0, idx.dtype if n_want else np.int64)
    return np.concatenate([idx, fill]), n_want


def _certify(out, margin_eff=None):
    """ok_shape & win_covered & d_far >= 2 r_cell, and 2 r_cell <=
    margin_eff under mirror pruning (margin_eff (F,))."""
    d_far = out["nbr_dist"][..., -1]  # +inf when fewer than K candidates exist
    cert = out["ok_shape"] & out["win_covered"] & (d_far >= 2.0 * out["r_cell"])
    if margin_eff is not None:
        # excluded mirrors are all at >= margin_eff: same cut argument as d_K
        cert = cert & (2.0 * out["r_cell"] <= margin_eff[:, None])
    return cert


def voronoi_cells_device(
    points,
    box_l: float,
    num: int,
    k: int = 32,
    k_search: int = 64,
    row_block: int = 256,
    eps: float | None = None,
    centers_idx=None,
    win: int | None = None,
    cell_impl: str = DEFAULT_CELL_IMPL,
    prune_mirrors: bool | None = None,
    cg="auto",
    device="cuda",
):
    """Per-cell Voronoi moments for the first `num` points (or the rows
    `centers_idx`) of one frame.

    The cell is built from the `k` nearest candidates' bisector planes; the
    certificate draws on `k_search >= k` candidates. prune_mirrors (None =
    auto for full-frame calls on >= 2048 points without a grid) searches
    the depth-pruned mirror set and adds 2 R_cell <= margin_eff to the
    certificate. cg: "auto" sizes a cell grid (`_suggest_cellgrid`; a
    wider edge for escalation subsets), (n_side, cap) forces one, None
    takes the z-window (win: None sizes it, <= 0 forces the full scan).

    Returns a dict of tensors on `device`: vol (num,), area (num,),
    face_area (num, k), face_nverts (num, k), nbr_idx (num, k_search)
    indices into the full mirrored candidate set, r_cell, certified (num,)
    and the search's payload (nbr_dist, nbr_valid, win_covered; under
    pruning prune_margin). cell_impl: the builder ("clip", "pallas": the
    fused dedup rule where `fits_voronoi_cells(k, k_search)` holds,
    "triple")."""
    _check_cell_impl(cell_impl)
    pb = _as_points(points, resolve_device(device))[None]
    if eps is None:
        eps = 1e-10 if pb.dtype == torch.float64 else 1e-4
    if k_search < k:
        raise ValueError(f"k_search={k_search} must be >= k={k}")
    p_real = int(pb.shape[1])
    if isinstance(cg, str) and cg == "auto":
        cg = _suggest_cellgrid(
            p_real, float(box_l), k_search,
            s_factor=1.12 if centers_idx is None else 1.4,
        )
    use_prune = (
        prune_mirrors
        if prune_mirrors is not None
        else (cg is None and centers_idx is None and p_real >= 2048)
    )
    mb = _suggest_mirror_budget(p_real, float(box_l), k_search) if use_prune else 0
    p4 = p_real + mb if mb > 0 else 4 * p_real
    if win is None:
        win = _suggest_win(p_real, p4, float(box_l), k_search)
    elif win <= 0:
        win = p4  # force the full scan
    bl = torch.tensor([float(box_l)], dtype=pb.dtype, device=pb.device)
    out = _tier1_frames_local(pb, bl, num, k, k_search, row_block, float(eps), int(win), mb, cg,
                              cell_impl, sel=centers_idx)
    if mb == 0:
        del out["prune_margin"]
    return {key: v[0] for key, v in out.items()}


# --- host close -----------------------------------------------------------


def _host_cell(rel: np.ndarray):
    """Host fallback for one cell: half-space intersection of the bisector
    planes of `rel` (K2, 3) relative candidates around the origin.

    Returns (vol, area, face_areas (K2,), face_nverts (K2,), r_cell).
    """
    from scipy.spatial import ConvexHull, HalfspaceIntersection

    n = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    d = 0.5 * np.linalg.norm(rel, axis=-1)
    halfspaces = np.hstack([n, -d[:, None]])  # n.x - d <= 0
    hs = HalfspaceIntersection(halfspaces, np.zeros(3))
    verts = hs.intersections
    hull = ConvexHull(verts)
    r_cell = float(np.max(np.linalg.norm(verts, axis=-1)))
    # per-face areas: group hull facets by the generating half-space
    face_area = np.zeros(len(rel))
    face_verts: list[set] = [set() for _ in range(len(rel))]
    centroids = verts[hull.simplices].mean(axis=1)
    plane_off = centroids @ n.T - d[None, :]  # (S, K2)
    owner = np.argmax(plane_off, axis=1)  # nearest plane contains the facet
    for s, simplex in enumerate(hull.simplices):
        a, b, c = verts[simplex]
        face_area[owner[s]] += 0.5 * np.linalg.norm(np.cross(b - a, c - a))
        face_verts[owner[s]].update(int(v) for v in simplex)
    nverts = np.array([len(fv) for fv in face_verts])
    return float(hull.volume), float(hull.area), face_area, nverts, r_cell


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# a tier's payload that `_device_candidates` reads
_CANDIDATE_KEYS = ("nbr_idx", "nbr_dist", "nbr_valid", "win_covered", "prune_margin")


def _device_candidates(cand, bad, ext, points):
    """Yield (rel, d_far, sel) per uncertified row bad[j] from row j of
    `cand`, the latest tier's search of it (`_left_candidates`): the device
    already found each row's k_search nearest candidates, so the host close
    needs no search of its own."""
    pm = cand.get("prune_margin", np.full(len(bad), np.inf))
    for j, i in enumerate(bad):
        valid = cand["nbr_valid"][j]
        if not cand["win_covered"][j] or not valid.any():
            # the window search may have missed nearer candidates: force
            # the full host search by failing the d_far certificate
            yield np.zeros((0, 3)), -np.inf, np.zeros(0, int)
            continue
        sel = cand["nbr_idx"][j][valid]
        rel = ext[sel] - np.asarray(points[i], ext.dtype)[None, :]
        # under mirror pruning, unseen excluded mirrors are only known to
        # lie beyond the pruning margin — the far-candidate bound caps there
        yield rel, float(min(cand["nbr_dist"][j][valid][-1], pm[j])), sel


def _host_cell_best(ext: np.ndarray, center: np.ndarray, k2: int):
    """Host cell of `center` against its k2 nearest mirrored candidates,
    doubling k2 until the far-candidate certificate holds."""
    # match ext's dtype so the self-point subtracts to exactly zero
    center = np.asarray(center, ext.dtype)
    d = np.linalg.norm(ext - center[None, :], axis=-1)
    while True:
        kk = min(4 * k2, len(d))  # partial selection: O(n), not a full sort
        cand = np.argpartition(d, kk - 1)[:kk]
        order = cand[np.argsort(d[cand])]
        order = order[d[order] > 1e-12]  # drop self
        sel = order[: min(k2, len(order))]
        rel = ext[sel] - center[None, :]
        vol, area, fa, nv, r_cell = _host_cell(rel)
        if len(sel) >= len(d) - 1 or d[sel[-1]] >= 2 * r_cell:
            return vol, area, fa, nv, sel
        k2 *= 2


def _host_close(points, box_l, num, rows, cert, vol, area, cand, fallback_k, dtype,
                block=None):
    """Close the uncertified rows (cert (n,), row r being point rows[r]) on
    the host from their candidates `cand` (`_left_candidates`), or a host
    search where unseen candidates could cut; with `block` (n, num), add
    each closed row's faces to its contact row (the doubling quirk as in
    `_scatter_contact_rows`). Mutates vol, area (num,) and block."""
    bad_pos = np.where(~cert)[0]
    if not len(bad_pos):
        return
    P = len(points)
    pts = torch.as_tensor(np.asarray(points), dtype=dtype)
    ext = mirror_points_device(pts, float(box_l)).numpy()
    bad = rows[bad_pos]
    n_full = 0
    for pos, i, (rel, d_far, sel) in zip(bad_pos, bad,
                                         _device_candidates(cand, bad, ext, points)):
        ok = False
        if len(rel) >= 4 and np.isfinite(d_far):
            v_i, a_i, fa, nv, r_cell = _host_cell(rel)
            ok = d_far >= 2.0 * r_cell  # no unseen candidate (all beyond d_far) can cut
        if not ok:  # unseen candidates could cut: full host search
            v_i, a_i, fa, nv, sel = _host_cell_best(ext, points[i], fallback_k)
            n_full += 1
        vol[i], area[i] = v_i, a_i
        if block is not None:
            o = sel % P
            keep = (sel < P) & (o < num) & (fa[: len(sel)] > 1e-12)
            np.add.at(block[pos], o[keep],
                      (np.where(nv[: len(sel)] >= 4, 2.0, 1.0) * fa[: len(sel)])[keep])
    _count("host", rows=len(bad), full_search=n_full)


def _left_candidates(tier1, last, cert_b):
    """The candidates of the rows the ladder left uncertified (cert_b (F,
    n)), one gather a key for the batch, from the latest tier that searched
    them: the last escalation tier that ran (`last`, as
    `_escalate_frames_batched` returns it; it took every row left), else
    tier 1 (`tier1`, the `_tier1_frames_local` dict). Returns per frame
    {key: numpy (rows left, ...)} in row order, None where no row is left."""
    frame, pos = np.nonzero(~cert_b)
    if not len(frame):
        return [None] * len(cert_b)
    src, at = tier1, pos
    if last is not None:
        bad_pos, src = last
        at = np.concatenate([np.searchsorted(b, pos[frame == t]) for t, b in enumerate(bad_pos)])
    dev = src["nbr_idx"].device
    idx = (clock.to_device(frame, torch.long, dev), clock.to_device(at, torch.long, dev))
    cand = {key: _np(src[key][idx]) for key in _CANDIDATE_KEYS if key in src}
    return [{key: v[frame == t] for key, v in cand.items()} if (frame == t).any() else None
            for t in range(len(cert_b))]


# --- the frame batch --------------------------------------------------------


def _batch_static_config(pos_batch, box_ls, k0: int, ks0: int, dtype):
    """Tier-1 config of a frame batch, chosen once from its smallest box
    (the densest frame): (eps, win, mirror_budget, cg). mirror_budget > 0:
    every frame searches the depth-pruned mirror set; it is 0 whenever the
    cell grid is taken (the grid drops deep mirrors itself)."""
    n_pts = pos_batch.shape[1]
    box_min = float(np.min(box_ls))
    eps = 1e-10 if dtype == torch.float64 else 1e-4
    cg = _suggest_cellgrid(n_pts, box_min, ks0)
    budget = (
        _suggest_mirror_budget(n_pts, box_min, ks0)
        if (n_pts >= 2048 and cg is None)
        else 0
    )
    p4 = 4 * n_pts if budget == 0 else n_pts + budget
    win = _suggest_win(n_pts, p4, box_min, ks0)
    return eps, win, budget, cg


def _tier1_frames_local(pb, bl, num, k, ks, row_block, eps, win, mb=0, cg=None,
                        cell_impl=DEFAULT_CELL_IMPL, sel=None):
    """Tier-1 cells of a frame batch pb (F, P, 3), boxes bl (F,): mirror
    construction (pruned when mb > 0), one search launch, the cells, the
    certificate. Rows: the first `num` points, or the point ids `sel`
    (bucket-padded for the search, as the JAX package pads its escalation
    subsets; the padding gets no cells and is dropped); row blocks of at
    most `row_block` of them. Returns the `_cells_blocked` dict (F, rows,
    ...) with `certified`, nbr_idx in the full 4P layout and prune_margin
    (+inf without pruning)."""
    F, P = pb.shape[0], pb.shape[1]
    if mb > 0:
        ext, ext_map, margin_eff = mirror_points_pruned(pb, bl, mb)
    else:
        ext, ext_map, margin_eff = mirror_points_device(pb, bl), None, None
    real, n_want = None, num
    if sel is None:
        centers = pb[:, :num]
    else:
        padded, n_want = _bucket_pad(sel)
        centers = pb[:, clock.to_device(padded, torch.long, pb.device)]
        real = (torch.arange(len(padded), device=pb.device) < n_want)[None].expand(F, -1)
    row_block = min(row_block, max(1, centers.shape[1]))
    out = _cells_blocked(centers, ext, k, ks, row_block, eps, win=win,
                         cg=cg, box_l=bl, stage="tier-1", real=real, cell_impl=cell_impl,
                         n_real=P if mb > 0 else None)
    out["certified"] = _certify(out, margin_eff)
    if ext_map is not None:
        out["nbr_idx"] = torch.gather(ext_map, 1, out["nbr_idx"].reshape(F, -1).long()).reshape(
            out["nbr_idx"].shape)
    pm = torch.full((F,), float("inf"), dtype=pb.dtype, device=pb.device) if margin_eff is None \
        else margin_eff
    out["prune_margin"] = pm[:, None].expand(F, centers.shape[1])
    out = {key: v[:, :n_want] for key, v in out.items()}
    _count((k, ks), certified=int(out["certified"].sum()))
    return out


def _escalate_frames_batched(pos_batch, box_ls, vol_b, area_b, cert_b, tiers_rest, pb, bl,
                             cell_impl=DEFAULT_CELL_IMPL, rows=None, faces=None):
    """The escalation ladder of a frame batch, one search launch per tier,
    each on the full mirror set. vol_b, area_b, cert_b (F, n): per frame
    row; `rows` (n,) the point id of each row (None: row i is point i).
    Mutates/returns (vol_b, area_b, cert_b, last): last is None where no
    tier ran, else the last one's (per frame the row positions it took,
    its `_cells_blocked` dict (F, bucket, ...)). `faces`: None, or a list
    per frame to which each tier appends its certified rows' (row
    positions, face_area, face_nverts, nbr_idx): the contacts' payload."""
    F, n_pts = pos_batch.shape[0], pos_batch.shape[1]
    last = None
    eps = 1e-10 if pb.dtype == torch.float64 else 1e-4
    p4 = 4 * n_pts
    box_min = float(np.min(box_ls))
    tiers_rest = tuple(tiers_rest)
    for ti, tier in enumerate(tiers_rest):
        k2, ks2 = tier[:2]
        is_last = ti == len(tiers_rest) - 1
        bad_pos = [np.where(~cert_b[t])[0] for t in range(F)]
        bad_rows = bad_pos if rows is None else [rows[b] for b in bad_pos]
        max_bad = max(len(b) for b in bad_rows)
        if max_bad == 0:
            break
        bucket = _bucket(max_bad)
        rows_np = np.zeros((F, bucket), np.int64)
        real = np.zeros((F, bucket), bool)
        for t, b in enumerate(bad_rows):
            if len(b):
                rows_np[t, : len(b)] = b
                rows_np[t, len(b):] = b[0]
                real[t, : len(b)] = True
        # size the window for the most scattered frame (fewest bad rows:
        # the widest per-block z span)
        n_rows_w = min(len(b) for b in bad_rows if len(b))
        win_t = 0 if is_last else _quantize_win(
            _suggest_win_subset(n_pts, box_min, ks2, n_rows_w), p4
        )
        # density-tail rows escalate, so the subset grid takes a wider edge;
        # the last tier full-scans (no coverage veto there)
        cg2 = None if is_last else _suggest_cellgrid(n_pts, box_min, ks2, s_factor=1.4)
        res = _cells_blocked(
            _gather_rows(pb, clock.to_device(rows_np, device=pb.device)),
            mirror_points_device(pb, bl), k2, ks2, min(256, bucket), float(eps),
            win=win_t if win_t > 0 else None, cg=cg2, box_l=bl,
            real=clock.to_device(real, device=pb.device), cell_impl=cell_impl,
        )
        res["certified"] = _certify(res)
        vol2, area2, cert2 = (_np(res[key]) for key in ("vol", "area", "certified"))
        if faces is not None:
            fa2, fn2, ni2 = (_np(res[key]) for key in ("face_area", "face_nverts", "nbr_idx"))
        stage_end(f"escalation ({k2}, {ks2})")
        last = (bad_pos, res)
        n_cert = 0
        for t, b in enumerate(bad_pos):
            nb = len(b)
            if nb == 0:
                continue
            c2 = cert2[t, :nb].astype(bool)
            fixed = b[c2]
            vol_b[t][fixed] = vol2[t, :nb][c2].astype(np.float64)
            area_b[t][fixed] = area2[t, :nb][c2].astype(np.float64)
            cert_b[t][fixed] = True
            n_cert += int(c2.sum())
            if faces is not None:
                faces[t].append((fixed, fa2[t, :nb][c2], fn2[t, :nb][c2], ni2[t, :nb][c2]))
        _count((k2, ks2), certified=n_cert)
        # the registry's `voronoi:escalation:*`: rows the tiers after the
        # first searched (bucket padding included) and certified
        clock.count("voronoi:escalation:rows", F * bucket)
        clock.count("voronoi:escalation:certified", n_cert)
    return vol_b, area_b, cert_b, last


def _volumes_frames(pos_batch, box_ls, num, tiers, row_block, fallback_k, cell_impl, device):
    """The volumes frame batch (see `voronoi_volumes_hybrid_frames`), in no
    span of its own."""
    _check_cell_impl(cell_impl)
    tiers = _tiers_for(cell_impl, tiers)
    dev = resolve_device(device)
    pos_batch = np.asarray(pos_batch)
    box_ls = np.asarray(box_ls, np.float64).reshape(-1)
    F = pos_batch.shape[0]
    k0, ks0 = tiers[0][:2]
    pb = _as_points(pos_batch, dev)
    bl = clock.to_device(box_ls, pb.dtype, dev)
    stage_end("H2D")
    eps, win, mb, cg = _batch_static_config(pos_batch, box_ls, k0, ks0, pb.dtype)
    out = _tier1_frames_local(pb, bl, num, k0, ks0, row_block, float(eps), int(win), mb, cg,
                              cell_impl)
    log_once(("voronoi_frames", cg is not None, mb > 0),
             "voronoi tier-1 frame batch: topk=%s mirrors=%s (F=%d, n=%d)",
             "cellgrid" if cg is not None else "window", "pruned" if mb > 0 else "full", F, num)
    vol_b = _np(out["vol"]).astype(np.float64)
    area_b = _np(out["area"]).astype(np.float64)
    cert_b = _np(out["certified"]).astype(bool)
    vol_b, area_b, cert_b, last = _escalate_frames_batched(
        pos_batch, box_ls, vol_b, area_b, cert_b, tiers[1:], pb, bl, cell_impl
    )
    for t, cand in enumerate(_left_candidates(out, last, cert_b)):
        _host_close(pos_batch[t], float(box_ls[t]), num, np.arange(num), cert_b[t], vol_b[t],
                    area_b[t], cand, fallback_k, pb.dtype)
    stage_end("host close")
    return vol_b, area_b, int(cert_b.sum())


@clock.traced("dispatch:voronoi_volumes_hybrid", device=True)
def voronoi_volumes_hybrid(
    points: np.ndarray,
    box_l: float,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
    device="cuda",
):
    """Drop-in for `surface.voronoi.voronoi_volumes`: device cells where
    certified (escalating through the (k, k_search) tiers), per-atom host
    half-space cells otherwise. Returns (vol (num,), area (num,),
    n_certified) as float64 numpy. A frame batch of one frame."""
    vol, area, n_cert = _volumes_frames(np.asarray(points)[None], [box_l], num, tiers, row_block,
                                        fallback_k, cell_impl, device)
    return vol[0], area[0], n_cert


@clock.traced("dispatch:voronoi_volumes_hybrid_frames", device=True)
def voronoi_volumes_hybrid_frames(
    pos_batch: np.ndarray,
    box_ls: np.ndarray,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
    mesh=None,
    device="cuda",
):
    """Frame-batched `voronoi_volumes_hybrid`: tier-1 cells for all frames
    in one search launch and one batched cell build, then one launch per
    escalation tier for the whole batch, then a host close per frame from
    each row's latest tier's candidates.

    pos_batch: (F, P, 3) (float64 stays float64: CPU only); box_ls: (F,)
    cubic box edges (may vary, NPT). Returns (vol (F, num), area (F, num),
    n_certified_total) as float64 numpy."""
    _not_ported(mesh)
    return _volumes_frames(pos_batch, box_ls, num, tiers, row_block, fallback_k, cell_impl,
                           device)


# --- contacts ---------------------------------------------------------------

# the tier-1 payload of a contacts frame batch that `_scatter_contact_rows` reads
_CONTACTS_TIER1_KEYS = ("vol", "area", "certified", "face_area", "face_nverts", "nbr_idx")


def _scatter_contact_rows(block, out, row_pos, keep_mask, P, num):
    """Add one device tier's face areas to contact rows: block (n_rows,
    num) the rows, row_pos the block row of each device row, keep_mask the
    device rows to add (the certified ones). A face counts against its
    candidate's source point if that is a real point below num; faces with
    >= 4 vertices count twice (the reference's doubled-area quirk,
    surface_library.py:295-303)."""
    face_area = np.asarray(out["face_area"], np.float64)[keep_mask]
    face_nverts = np.asarray(out["face_nverts"])[keep_mask]
    nbr_idx = np.asarray(out["nbr_idx"])[keep_mask, : face_area.shape[1]]
    rows = np.asarray(row_pos)[keep_mask][:, None].repeat(face_area.shape[1], 1)
    orig = nbr_idx % P  # mirror image -> source point
    is_real = (nbr_idx < P) & (orig < num) & (face_area > 0)
    quirk = np.where(face_nverts >= 4, 2.0, 1.0)
    np.add.at(block, (rows[is_real], orig[is_real]), (quirk * face_area)[is_real])


def _contacts_result(block, sel_rows, vol, area, num, dense: bool):
    """One frame's contacts from its rows. dense: the JAX return contract,
    (contacts (num, num) symmetrized as np.maximum(C, C.T), atom_area,
    wat_area, atom_vol (1, num)), built from the rows without reading the
    whole matrix twice. Else the rows alone, symmetrized where they meet
    each other's columns (which is all the symmetrization changes in
    them): (rows (n_rows, num), atom_area, wat_area of the rows (n_rows,),
    atom_vol)."""
    atom_area = area[None, :num].copy()
    atom_vol = vol[None, :num].copy()
    if dense:
        contacts = np.zeros((num, num))
        contacts[sel_rows] = block
        # every entry off the rows' columns has a zero partner: max(x, 0) = x
        contacts[:, sel_rows] = np.maximum(contacts[:, sel_rows], block.T)
        wat_area = (2.0 * atom_area - contacts[:num].sum(axis=1)[None, :]).copy()
        return contacts, atom_area, wat_area, atom_vol
    rows = block.copy()
    sub = block[:, sel_rows]
    rows[:, sel_rows] = np.maximum(sub, sub.T)
    return rows, atom_area, 2.0 * atom_area[0, sel_rows] - rows.sum(axis=1), atom_vol


@clock.traced("dispatch:voronoi_contacts_hybrid", device=True)
def voronoi_contacts_hybrid(
    points: np.ndarray,
    box_l: float,
    num: int,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    rows=None,
    cell_impl: str = DEFAULT_CELL_IMPL,
    device="cuda",
):
    """Drop-in for `surface.voronoi.voronoi_contacts`: (contacts (num, num),
    atom_area (1, num), wat_area (1, num), atom_vol (1, num), n_certified).

    Reproduces the reference's doubled-area quirk: faces with >= 4 vertices
    contribute 2x their polygon area to the contact matrix, 3-vertex faces
    1x (surface_library.py:295-303). `rows` (distinct point ids) restricts
    which cells are computed; other rows of the returned arrays are zero.
    A frame batch of one frame."""
    return next(_contacts_frames(np.asarray(points)[None], [box_l], num, rows, tiers, row_block,
                                 fallback_k, cell_impl, device, dense=True))


def _contacts_frames(pos_batch, box_ls, num, rows, tiers, row_block, fallback_k, cell_impl,
                     device, dense):
    """The frame batch's contacts, frame by frame (see
    `voronoi_contacts_hybrid_frames`; dense=False yields the rows form of
    `_contacts_result`)."""
    _check_cell_impl(cell_impl)
    tiers = _tiers_for(cell_impl, tiers)
    dev = resolve_device(device)
    pos_batch = np.asarray(pos_batch)
    box_ls = np.asarray(box_ls, np.float64).reshape(-1)
    F, P = pos_batch.shape[0], pos_batch.shape[1]
    sel_rows = np.arange(num) if rows is None else np.asarray(rows, int)
    k0, ks0 = tiers[0][:2]
    pb = _as_points(pos_batch, dev)
    bl = clock.to_device(box_ls, pb.dtype, dev)
    stage_end("H2D")
    eps, win, mb, cg = _batch_static_config(pos_batch, box_ls, k0, ks0, pb.dtype)
    out = _tier1_frames_local(pb, bl, num, k0, ks0, row_block, float(eps), int(win), mb, cg,
                              cell_impl, sel=None if rows is None else sel_rows)
    tier1 = {key: _np(out[key]) for key in _CONTACTS_TIER1_KEYS}
    log_once(("voronoi_contacts_frames", cg is not None, mb > 0),
             "voronoi contacts tier-1 frame batch: topk=%s mirrors=%s (F=%d, rows=%d)",
             "cellgrid" if cg is not None else "window", "pruned" if mb > 0 else "full", F,
             len(sel_rows))
    cert1 = tier1["certified"].astype(bool)
    vol_b = tier1["vol"].astype(np.float64)
    area_b = tier1["area"].astype(np.float64)
    faces = [[] for _ in range(F)]
    vol_b, area_b, cert_b, last = _escalate_frames_batched(
        pos_batch, box_ls, vol_b, area_b, cert1.copy(), tiers[1:], pb, bl, cell_impl,
        rows=sel_rows, faces=faces)
    for t, cand in enumerate(_left_candidates(out, last, cert_b)):
        tier1_t = {key: v[t] for key, v in tier1.items()}
        vol, area = np.zeros(num), np.zeros(num)
        vol[sel_rows], area[sel_rows] = vol_b[t], area_b[t]
        block = np.zeros((len(sel_rows), num))
        _scatter_contact_rows(block, tier1_t, np.arange(len(sel_rows)), cert1[t], P, num)
        for pos, fa, fn, ni in faces[t]:
            _scatter_contact_rows(block, {"face_area": fa, "face_nverts": fn, "nbr_idx": ni},
                                  pos, np.ones(len(pos), bool), P, num)
        _host_close(pos_batch[t], float(box_ls[t]), num, sel_rows, cert_b[t], vol, area, cand,
                    fallback_k, pb.dtype, block)
        stage_end("host close")
        res = _contacts_result(block, sel_rows, vol, area, num, dense)
        stage_end("contact assembly")
        yield (*res, int(cert_b[t].sum()))


def voronoi_contacts_hybrid_frames(
    pos_batch: np.ndarray,
    box_ls: np.ndarray,
    num: int,
    rows=None,
    tiers=DEFAULT_TIERS,
    row_block: int = 256,
    fallback_k: int = 96,
    cell_impl: str = DEFAULT_CELL_IMPL,
    mesh=None,
    device="cuda",
):
    """Frame-batched `voronoi_contacts_hybrid`: tier-1 cells (with their
    faces) for all frames in one search launch and one cell build, the
    escalation ladder once per tier for the whole batch (each tier's
    certified rows keep their faces), then per frame the host close on
    each row's latest tier's candidates and the contact assembly.

    Generator: yields per frame (contacts (num, num), atom_area (1, num),
    wat_area (1, num), atom_vol (1, num), n_certified), so callers never
    hold F contact matrices at once. `rows` (distinct point ids) restricts
    which cells are computed; n_certified counts them."""
    _not_ported(mesh)
    yield from _contacts_frames(pos_batch, box_ls, num, rows, tiers, row_block, fallback_k,
                                cell_impl, device, dense=True)
