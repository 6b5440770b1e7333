"""H-bond counts per acceptor and per donor: the two CUDA kernels' wrappers,
their plain PyTorch versions, the two-set slab prep and the certified host
dispatch (port of waterorderlib_tpu.ops.pallas.hbond_kernel and hbond_slab,
and of the water-water tier rule of the JAX package's `hb_calc`).

A pair (acceptor A; donor D with its hydrogen H) bonds when the minimum-
image heavy-heavy squared distance dsq lies in (1e-2, dist_cut^2] and the
D-H...A angle at the hydrogen is at least ang_cut, tested without arccos as
u . vhat <= cos(ang_cut) * |u| with u = mi(A - H) and vhat the unit vector of
mi(D - H). Every consumer of the (Na, Nd) bond matrix needs only its row and
column sums, so the matrix is never stored.

`hbond_dense` visits every pair (hbond_kernel.py). `hbond_slab` holds each
tile of 128 z-sorted acceptors against one window of the z-sorted donors
extended by boundary copies (hbond_slab.py), with a `covered` certificate
per frame from `slab_prep_two_set`. Both sets are sorted per frame, so
window starts are (F, n_tiles): this is not the one-set contract of
ops/cuda/window.py. The windows are chosen on copies' z shifted by +/-L, as
in the JAX prep, but every column carries its donor's wrapped coordinates
as the dense form has them (hydrogens wrapped on their own): the two-select
minimum image needs no shift for coordinates in [0, L), and each pair then
meets the same float32 operations in both kernels, so the slab kernel
equals the dense one wherever `covered` holds. The JAX slab kernel computes
shifted copies with hydrogens riding beside their donors, which rounds some
pairs across a face apart from its dense kernel (ROADMAP queue 3).

Each kernel wrapper launches its kernel (csrc/hbond.cu) on CUDA tensors and
calls its plain version on CPU tensors; any other device raises. There is no
fallback from a kernel to a plain version. Counts are int32 (the JAX
kernels return float32).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from waterorderlib_tpu_torch.core import clock, pbc
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32, xla_dot3
from waterorderlib_tpu_torch.ops.cuda import build, window

ROW_TILE = 128  # acceptors per slab tile (kRows of csrc/hbond.cu)
SLAB_MIN_WATERS = 16_384  # the JAX hb_calc's water-water slab tier starts here
PAIR_BUDGET = 1 << 22  # (frame, acceptor, donor) triples per block of the plain versions

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def cos_cut(ang_cut: float) -> float:
    """cos(ang_cut degrees) as the JAX kernels compute it,
    jnp.cos(jnp.radians(float32(ang_cut))): the float32 radians, their
    cosine in float64 rounded to float32 (equal to the float32 jnp.cos for
    every cut tried, e.g. 120 -> -0.50000006)."""
    rad = np.float32(ang_cut) * np.float32(np.pi / 180.0)
    return float(np.float32(math.cos(float(rad))))


def _vhat(don, donh, boxes):
    """Unit vectors of mi(D - H), as the JAX wrappers: the norm as XLA's
    fma chain, divided by max(norm, 1e-12)."""
    v = pbc.minimum_image(don - donh, boxes[:, None, :])
    nrm = sqrt_f32(xla_dot3(v, v))
    return v / torch.clamp(nrm, min=1e-12)[..., None]


def _t(a):
    """(F, N, 3) -> contiguous (F, 3, N) float32."""
    return a.transpose(1, 2).contiguous()


class DensePrep(NamedTuple):
    """Inputs of `hbond_dense`: (F, 3, N) float32, coordinates in [0, L)."""

    acc: torch.Tensor   # (F, 3, Na)
    don: torch.Tensor   # (F, 3, Nd)
    donh: torch.Tensor  # (F, 3, Nd) each hydrogen wrapped on its own
    vhat: torch.Tensor  # (F, 3, Nd)


def dense_prep(acc, don, donh, boxes) -> DensePrep:
    """The dense kernel's inputs (hbond_kernel.py:128-143) from stored
    positions acc (F, Na, 3), don and donh (F, Nd, 3) and boxes (F, 3)."""
    b = boxes[:, None, :]
    return DensePrep(_t(torch.remainder(acc, b)), _t(torch.remainder(don, b)),
                     _t(torch.remainder(donh, b)), _t(_vhat(don, donh, boxes)))


def _check(acc, don, donh, vhat, boxes, starts=None):
    dev = acc.device
    for name, t in (("don", don), ("donh", donh), ("vhat", vhat), ("boxes", boxes)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc on {dev}")
    for name, t in (("acc", acc), ("don", don), ("donh", donh), ("vhat", vhat), ("boxes", boxes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    F = acc.shape[0]
    if acc.dim() != 3 or acc.shape[1] != 3:
        raise ValueError(f"acc must be (F, 3, Na), got {tuple(acc.shape)}")
    if any(t.shape != don.shape for t in (donh, vhat)) or don.dim() != 3 or don.shape[:2] != (F, 3):
        raise ValueError(f"don, donh, vhat must be (F, 3, Nd), got {tuple(don.shape)}, "
                         f"{tuple(donh.shape)}, {tuple(vhat.shape)}")
    if tuple(boxes.shape) != (F, 3):
        raise ValueError(f"boxes must be ({F}, 3), got {tuple(boxes.shape)}")
    if starts is not None:
        want = (F, -(-acc.shape[2] // ROW_TILE))
        if starts.device != dev or starts.dtype != torch.int32 or tuple(starts.shape) != want:
            raise ValueError(f"starts must be int32 {want} on {dev}, got {starts.dtype} "
                             f"{tuple(starts.shape)} on {starts.device}")
        if not starts.is_contiguous():
            raise ValueError("starts must be contiguous")


def _launch(entry, acc, don, donh, vhat, boxes, dist_sq, cc, starts=None, w=0):
    """Call csrc/hbond.cu's `entry` on the current stream; returns (acc
    counts (F, Na) int32, donor counts (F, Nd) int32)."""
    F, _, na = acc.shape
    nd = don.shape[2]
    acc_cnt = torch.empty((F, na), dtype=torch.int32, device=acc.device)
    don_cnt = torch.zeros((F, nd), dtype=torch.int32, device=acc.device)
    fn = getattr(build.load("hbond"), entry)
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,
                       *([_c_ptr, _c_int] if starts is not None else []),
                       _c_ptr, _c_int, _c_float, _c_float, _c_ptr, _c_ptr, _c_ptr]
        fn.restype = _c_int
    slab_args = (starts.data_ptr(), w) if starts is not None else ()
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), na, don.data_ptr(), donh.data_ptr(), vhat.data_ptr(), nd,
                 *slab_args, boxes.data_ptr(), F, dist_sq, cc, acc_cnt.data_ptr(),
                 don_cnt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return acc_cnt, don_cnt


def _mi(d, box_l):
    """The kernels' minimum image: two compare-selects."""
    d = torch.where(d > box_l * 0.5, d - box_l, d)
    return torch.where(d < -box_l * 0.5, d + box_l, d)


def _bonds(a, d, h, v, box_l, dist_sq, cc):
    """(F, r, c) bool bond tile of acceptors a (F, 3, r, 1) against donors,
    hydrogens and unit vectors d, h, v (F, 3, 1, c), with the kernels'
    float32 operations; the angle test, as in the kernels, only for the
    pairs within the distance cut. box_l: (F, 3, 1, 1)."""
    dd = _mi(d - a, box_l)
    dsq = window.dot3(dd[:, 0], dd[:, 0], dd[:, 1], dd[:, 1], dd[:, 2], dd[:, 2], fused=True)
    bond = (dsq <= dist_sq) & (dsq > 1.0e-2)
    f, r, c = bond.nonzero(as_tuple=True)
    u = _mi(a[f, :, r, 0] - h[f, :, 0, c], box_l[f, :, 0, 0])  # (pairs, 3)
    vp = v[f, :, 0, c]
    usq = window.dot3(u[:, 0], u[:, 0], u[:, 1], u[:, 1], u[:, 2], u[:, 2], fused=True)
    t = window.dot3(u[:, 0], vp[:, 0], u[:, 1], vp[:, 1], u[:, 2], vp[:, 2], fused=True)
    bond[f, r, c] = t <= cc * sqrt_f32(usq)
    return bond


def _scalars(acc, dist_sq, cc):
    dev = acc.device
    return (torch.tensor(dist_sq, dtype=torch.float32, device=dev),
            torch.tensor(cc, dtype=torch.float32, device=dev))


@clock.kernel
def hbond_dense(acc, don, donh, vhat, boxes, dist_sq, cc):
    """Counts of the bond matrix of every acceptor against every donor.
    acc (F, 3, Na); don, donh, vhat (F, 3, Nd) (`dense_prep`); boxes (F, 3);
    dist_sq = dist_cut^2 and cc = `cos_cut(ang_cut)` as Python floats.

    Returns (acc counts (F, Na) int32, donor counts (F, Nd) int32)."""
    _check(acc, don, donh, vhat, boxes)
    if window.runs_plain(acc, "hbond_dense"):
        return hbond_dense_plain(acc, don, donh, vhat, boxes, dist_sq, cc)
    if acc.numel() == 0 or don.numel() == 0:
        return (torch.zeros(acc.shape[::2], dtype=torch.int32, device=acc.device),
                torch.zeros(don.shape[::2], dtype=torch.int32, device=acc.device))
    out = _launch("hbond_dense_launch", acc, don, donh, vhat, boxes, dist_sq, cc)
    clock.count("launches:hbond_dense")
    return out


@clock.plain
def hbond_dense_plain(acc, don, donh, vhat, boxes, dist_sq, cc):
    """Plain PyTorch version of `hbond_dense`, same contract, in blocks of
    at most PAIR_BUDGET (frame, acceptor, donor) triples."""
    _check(acc, don, donh, vhat, boxes)
    F, _, na = acc.shape
    nd = don.shape[2]
    ds, c = _scalars(acc, dist_sq, cc)
    box_l = boxes[:, :, None, None]
    acc_cnt = torch.zeros((F, na), dtype=torch.int32, device=acc.device)
    don_cnt = torch.zeros((F, nd), dtype=torch.int32, device=acc.device)
    cb = max(1, min(nd, PAIR_BUDGET // max(F, 1)))
    rb = max(1, PAIR_BUDGET // (max(F, 1) * cb))
    for c0 in range(0, nd, cb):
        d, h, v = (x[:, :, None, c0 : c0 + cb] for x in (don, donh, vhat))
        for r0 in range(0, na, rb):
            b = _bonds(acc[:, :, r0 : r0 + rb, None], d, h, v, box_l, ds, c)
            acc_cnt[:, r0 : r0 + rb] += b.sum(dim=2, dtype=torch.int32)
            don_cnt[:, c0 : c0 + cb] += b.sum(dim=1, dtype=torch.int32)
    return acc_cnt, don_cnt


@clock.kernel
def hbond_slab(acc, don, donh, vhat, starts, boxes, w, dist_sq, cc):
    """Counts of each tile of ROW_TILE acceptors against its window of w
    donor columns. acc (F, 3, R); don, donh, vhat (F, 3, C); starts (F,
    ceil(R / ROW_TILE)) int32, each in [0, C - w] (`slab_prep_two_set`).

    Returns (acc counts (F, R) int32, column counts (F, C) int32). A window
    start outside the columns gives -1 for the tile's acceptors."""
    _check(acc, don, donh, vhat, boxes, starts)
    if not 0 < w <= don.shape[2]:
        raise ValueError(f"window w={w} must lie in (0, {don.shape[2]}]")
    if window.runs_plain(acc, "hbond_slab"):
        return hbond_slab_plain(acc, don, donh, vhat, starts, boxes, w, dist_sq, cc)
    out = _launch("hbond_slab_launch", acc, don, donh, vhat, boxes, dist_sq, cc, starts, w)
    clock.count("launches:hbond_slab")
    return out


@clock.plain
def hbond_slab_plain(acc, don, donh, vhat, starts, boxes, w, dist_sq, cc):
    """Plain PyTorch version of `hbond_slab`, same contract, one tile at a
    time (each frame's window gathered from its own start)."""
    _check(acc, don, donh, vhat, boxes, starts)
    if not 0 < w <= don.shape[2]:
        raise ValueError(f"window w={w} must lie in (0, {don.shape[2]}]")
    F, _, n_rows = acc.shape
    n_cols = don.shape[2]
    dev = acc.device
    ds, c = _scalars(acc, dist_sq, cc)
    box_l = boxes[:, :, None, None]
    acc_cnt = torch.zeros((F, n_rows), dtype=torch.int32, device=dev)
    don_cnt = torch.zeros((F, n_cols), dtype=torch.int32, device=dev)
    offs = torch.arange(w, device=dev)
    for t in range(starts.shape[1]):
        r0, r1 = t * ROW_TILE, min(n_rows, (t + 1) * ROW_TILE)
        s = starts[:, t].long()
        bad = (s < 0) | (s > n_cols - w)
        cols = (s.clamp(0, n_cols - w)[:, None] + offs).expand(F, w)  # (F, w)
        idx = cols[:, None, :].expand(F, 3, w)
        d, h, v = (x.gather(2, idx)[:, :, None, :] for x in (don, donh, vhat))
        b = _bonds(acc[:, :, r0:r1, None], d, h, v, box_l, ds, c) & ~bad[:, None, None]
        acc_cnt[:, r0:r1] = torch.where(bad[:, None], -1, b.sum(dim=2, dtype=torch.int32))
        don_cnt.scatter_add_(1, cols, b.sum(dim=1, dtype=torch.int32))
    return acc_cnt, don_cnt


def hbond_counts(acc_pos, don_pos, donh_pos, boxes, dist_cut=3.5, ang_cut=120.0):
    """(acc counts (F, Na) int32, donor counts (F, Nd) int32) of the bond
    matrix of stored positions acc_pos (F, Na, 3), don_pos and donh_pos
    (F, Nd, 3), boxes (F, 3), all float32: `hbond_dense` on `dense_prep`."""
    return hbond_dense(*dense_prep(acc_pos, don_pos, donh_pos, boxes), boxes,
                       dist_cut * dist_cut, cos_cut(ang_cut))


def hbond_counts_plain(acc_pos, don_pos, donh_pos, boxes, dist_cut=3.5, ang_cut=120.0):
    """`hbond_counts` through the plain version, on any device."""
    return hbond_dense_plain(*dense_prep(acc_pos, don_pos, donh_pos, boxes), boxes,
                             dist_cut * dist_cut, cos_cut(ang_cut))


def suggest_window_two_set(na: int, nd: int, box_z: float, cut: float, row_tile: int = ROW_TILE,
                           safety: float = 1.5) -> int:
    """Donor-window width (multiple of 128) expected to cover an acceptor
    tile's z-slab (hbond_slab.py:85-92); `covered` verifies at run time."""
    est = nd * (row_tile / max(na, 1) * box_z + 2.0 * cut) / box_z * safety + 256
    return int(-(-est // 128) * 128)


def suggest_pad_two_set(nd: int, box_z: float, cut: float, safety: float = 1.8) -> int:
    """Donor boundary-copy count whose z extent is expected to exceed the
    cutoff on both faces (hbond_slab.py:95-99)."""
    est = nd * cut / box_z * safety + 128
    return int(min(nd, -(-est // 128) * 128))


class TwoSetPrep(NamedTuple):
    """Inputs of `hbond_slab` for whole frames, and what undoes the sort."""

    acc: torch.Tensor      # (F, 3, Na_pad) z-sorted acceptors, sentinel rows at 1e6
    don: torch.Tensor      # (F, 3, Nd + 2 pad) z-sorted donors, the last and first
                           # `pad` repeated before and after them
    donh: torch.Tensor     # (F, 3, Nd + 2 pad) their hydrogens, wrapped on their own
    vhat: torch.Tensor     # (F, 3, Nd + 2 pad)
    starts: torch.Tensor   # (F, n_tiles) int32 window start per acceptor tile
    w: int                 # window width
    covered: torch.Tensor  # (F,) bool: every tile's window holds every donor within the cut in z
    order_a: torch.Tensor  # (F, Na) sorted position -> acceptor
    order_d: torch.Tensor  # (F, Nd) sorted position -> donor
    pad: int


def slab_prep_two_set(acc_pos, don_pos, donh_pos, boxes, dist_cut, window_w, pad) -> TwoSetPrep:
    """The slab kernel's inputs (hbond_slab.py:122-181) for F frames: both
    sets wrapped into [0, L) and z-sorted per frame, `pad` boundary copies
    of the donors on each side, sentinel acceptor rows, window starts from
    the tile's first and last real acceptor z -/+ dist_cut over the copies'
    z shifted by -/+L_f, and `covered` = every window holds its z-range and
    the pad spans the cut. The copies keep their sources' coordinates (see
    the module's docstring). Unlike the TPU prep, starts and w are not
    rounded to 128 columns; w is at most Nd, so no window holds a donor and
    its copy."""
    F, na, _ = acc_pos.shape
    nd = don_pos.shape[1]
    if not 0 < pad <= nd:
        raise ValueError(f"pad={pad} must lie in (0, {nd}]")
    dev = acc_pos.device
    b = boxes[:, None, :]
    acc_w = torch.remainder(acc_pos, b)
    don_w, donh_w = torch.remainder(don_pos, b), torch.remainder(donh_pos, b)
    vhat = _vhat(don_pos, donh_pos, boxes)

    order_a = torch.sort(acc_w[..., 2], dim=1, stable=True).indices
    order_d = torch.sort(don_w[..., 2], dim=1, stable=True).indices

    def take(x, order):
        return x.gather(1, order[..., None].expand(-1, -1, x.shape[-1]))

    acc_s = take(acc_w, order_a)
    don_s, donh_s, vhat_s = (take(x, order_d) for x in (don_w, donh_w, vhat))
    na_pad = -(-na // ROW_TILE) * ROW_TILE
    acc_sp = torch.cat([acc_s, acc_s.new_full((F, na_pad - na, 3), 1.0e6)], dim=1)

    def extend(x, shift=0.0):
        return torch.cat([x[:, nd - pad :] - shift, x, x[:, :pad] + shift], dim=1)

    nd_ext = nd + 2 * pad
    w = min(window_w, nd_ext, nd)
    ext_z = extend(don_s[..., 2], boxes[:, 2:3]).contiguous()  # monotone over the copies
    n_tiles = na_pad // ROW_TILE
    tile_first = torch.arange(n_tiles, device=dev) * ROW_TILE
    tile_last = torch.clamp(tile_first + ROW_TILE - 1, max=na - 1)
    z_lo = acc_sp[:, tile_first, 2] - dist_cut
    z_hi = acc_sp[:, tile_last, 2] + dist_cut
    starts = torch.searchsorted(ext_z, z_lo.contiguous())
    ends = torch.searchsorted(ext_z, z_hi.contiguous(), right=True)
    starts = torch.clamp(starts, 0, nd_ext - w)
    pad_ok = (ext_z[:, 0] <= z_lo.min(dim=1).values) & (ext_z[:, -1] >= z_hi.max(dim=1).values)
    covered = ((ends - starts) <= w).all(dim=1) & pad_ok
    return TwoSetPrep(_t(acc_sp), _t(extend(don_s)), _t(extend(donh_s)), _t(extend(vhat_s)),
                      starts.to(torch.int32).contiguous(), w, covered, order_a, order_d, pad)


def unsort_two_set(prep: TwoSetPrep, acc_cnt, col_cnt):
    """The slab kernel's counts in the original order: acceptors unsorted,
    each donor copy's count folded back onto its source (hbond_slab.py:
    215-221), then unsorted. Returns ((F, Na), (F, Nd)) int32."""
    na, nd, pad = prep.order_a.shape[1], prep.order_d.shape[1], prep.pad
    acc_out = torch.empty_like(acc_cnt[:, :na]).scatter_(1, prep.order_a, acc_cnt[:, :na])
    main = col_cnt[:, pad : pad + nd].clone()
    main[:, nd - pad :] += col_cnt[:, :pad]
    main[:, :pad] += col_cnt[:, pad + nd :]
    return acc_out, torch.empty_like(main).scatter_(1, prep.order_d, main)


def _counts_slab(kernel, acc_pos, don_pos, donh_pos, boxes, dist_cut, ang_cut, window_w, pad):
    prep = slab_prep_two_set(acc_pos, don_pos, donh_pos, boxes, dist_cut, window_w, pad)
    acc_cnt, col_cnt = kernel(prep.acc, prep.don, prep.donh, prep.vhat, prep.starts, boxes,
                              prep.w, dist_cut * dist_cut, cos_cut(ang_cut))
    return (*unsort_two_set(prep, acc_cnt, col_cnt), prep.covered)


def hbond_counts_slab(acc_pos, don_pos, donh_pos, boxes, dist_cut=3.5, ang_cut=120.0,
                      window_w=1536, pad=512):
    """(acc counts (F, Na), donor counts (F, Nd), covered (F,)): `hbond_slab`
    on `slab_prep_two_set`. Where `covered` holds for a frame its counts
    equal `hbond_counts`'."""
    return _counts_slab(hbond_slab, acc_pos, don_pos, donh_pos, boxes, dist_cut, ang_cut,
                        window_w, pad)


def hbond_counts_slab_plain(acc_pos, don_pos, donh_pos, boxes, dist_cut=3.5, ang_cut=120.0,
                            window_w=1536, pad=512):
    """`hbond_counts_slab` through the plain version, on any device."""
    return _counts_slab(hbond_slab_plain, acc_pos, don_pos, donh_pos, boxes, dist_cut, ang_cut,
                        window_w, pad)


# `last_tier`: which tier served the most recent hbond_counts_certified
# call, "dense" | "slab" | "slab+dense" (some frames failed `covered`)
__getattr__ = clock.tier_attr("hbond_counts_certified", __name__)


@clock.traced("dispatch:hbond_counts_certified", device=True)
def hbond_counts_certified(acc_pos, don_pos, donh_pos, boxes, dist_cut=3.5, ang_cut=120.0):
    """Water-water counts on the JAX hb_calc's tier (hbonds_driver.py:
    81-127): the dense kernel below SLAB_MIN_WATERS acceptors; at and above
    it the slab kernel with window `suggest_window_two_set(Na, Nd, L_z,
    dist_cut)` and pad `suggest_pad_two_set(Nd, L_z, dist_cut + 2)`, the
    frames whose `covered` fails recomputed by the dense kernel. Both tiers
    are exact. Returns (acc counts (F, Na), donor counts (F, Nd)) int32."""
    na, nd = acc_pos.shape[1], don_pos.shape[1]
    if na < SLAB_MIN_WATERS:
        clock.serve_tier("hbond_counts_certified", "dense")
        return hbond_counts(acc_pos, don_pos, donh_pos, boxes, dist_cut, ang_cut)
    box_z = float(boxes[0, 2])
    win = suggest_window_two_set(na, nd, box_z, dist_cut)
    pad = suggest_pad_two_set(nd, box_z, dist_cut + 2.0)
    acc_cnt, don_cnt, covered = hbond_counts_slab(acc_pos, don_pos, donh_pos, boxes, dist_cut,
                                                  ang_cut, win, pad)
    bad = torch.nonzero(~covered)[:, 0]
    if bad.numel() == 0:
        clock.serve_tier("hbond_counts_certified", "slab")
        return acc_cnt, don_cnt
    clock.serve_tier("hbond_counts_certified", "slab+dense")
    a, d = hbond_counts(acc_pos[bad], don_pos[bad], donh_pos[bad], boxes[bad], dist_cut, ang_cut)
    acc_cnt[bad], don_cnt[bad] = a, d
    return acc_cnt, don_cnt
