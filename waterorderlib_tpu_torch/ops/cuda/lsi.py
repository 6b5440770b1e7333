"""LSI over z-slab windows: the CUDA kernels' wrappers, their plain
PyTorch versions, the tier rule and the certified host dispatch (port of
waterorderlib_tpu.ops.pallas.lsi_kernel and lsi_slab2, and of the LSI tier
dispatch of the JAX package's `lsi_calc`).

`lsi_window` (K = 24) keeps the 24 nearest (low, high+3.7] candidates by
imaged distance and picks the next-shell neighbor by least raw distance
among those beyond `high` (lsi_kernel.py, and the JAX package's chunked,
HBM and XLA paths). `lsi_split_window` keeps the 12 nearest in-shell
candidates over a narrow window and picks the next-shell neighbor among ALL
candidates of a wide window (lsi_slab2.py), with an `incomplete` flag where
the shell overfills 12; its escalation form (`redo=`) redoes listed rows
with more in-shell slots. All end in the same epilogue (`_epilogue`, the
JAX package's `lsi_epilogue`): the population variance of the sorted
in-shell gaps and the final gap to the next neighbor.

The two next-shell picks differ, so the tier decides the result, not only
the speed. `split_tier` keeps the JAX package's choice of tier for each
system size. On the split tier every row gets the definition's pick (the
least raw distance among all next-shell candidates): the rows that overfill
12 are redone on the card through the escalation form, where the JAX
package falls back to its K = 24 pick for the whole call. The K = 24 tiers
take the next-shell atom from the 24 nearest.

Each wrapper launches its kernel (csrc/lsi_window.cu) on a CUDA tensor and
calls its plain version on a CPU tensor; any other device raises. There is
no fallback from a kernel to a plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from waterorderlib_tpu_torch.core import clock
from waterorderlib_tpu_torch.core.fp32 import sqrt_f32
from waterorderlib_tpu_torch.ops.cuda import slab, window

K = 24       # slots of the window kernel
K_IN = 12    # in-shell slots of the split kernel
K_ESC = 32   # in-shell slots of the escalation's first rung (kEscS in csrc/lsi_window.cu)
NEXT_SHELL = 3.7  # the next neighbor is searched in (high, high + 3.7]
ROW_TILE = 128


def _outs(rows, n):
    F, _, n_rows = rows.shape
    dev = rows.device
    kinds = (torch.float32, torch.bool, torch.int32, torch.bool)[:n]
    return tuple(torch.empty((F, n_rows), dtype=k, device=dev) for k in kinds)


@clock.kernel
def lsi_window(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols, low_sq, high,
               outer_sq):
    """LSI (K = 24) of R rows against one column window per row tile (the
    contract of ops/cuda/window.py, with the raw rows and columns). low_sq,
    outer_sq: squared bounds of the candidate shell (low, high+3.7]; high:
    the in-shell cutoff (not squared).

    Returns (lsi (F, R) f32, valid (F, R) bool, count (F, R) int32). An
    out-of-range window start gives lsi = NaN, valid False, count 0.
    """
    window.check(rows, cols, starts, boxes, w, row_tile)
    window.check_raw(rows, cols, raw_rows, raw_cols)
    if window.runs_plain(rows, "lsi_window"):
        return lsi_window_plain(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols,
                                low_sq, high, outer_sq)
    outs = _outs(rows, 3)
    window.launch("lsi_window", "lsi_window_launch", rows, cols, starts, boxes, w, row_tile,
                  (low_sq, high, outer_sq), outs, extra=window.raw_args(raw_rows, raw_cols))
    clock.count("launches:lsi_window")
    return outs


@clock.kernel
def lsi_split_window(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols, starts_wide,
                     w_wide, low_sq, high, high_sq, outer_sq, redo=None, k_in=K_IN):
    """Split-shell LSI of R rows: the contract's window (starts, w) is the
    narrow in-shell window, (starts_wide, w_wide) the wide next-shell one.

    Returns (lsi, valid, count, incomplete (F, R) bool: the in-shell count
    exceeds K_IN, or a window lies outside the columns).

    The escalation form: `redo` (M,) int64 flat indices f * R + r of the
    (frame, row) pairs to compute, over the same windows, with `k_in`
    in-shell slots. Returns (lsi, valid, count, shell), each (M,): shell is
    the pair's full in-shell count (-1 where a window lies outside the
    columns); a pair whose count exceeds k_in reads NaN, not valid, 0.
    """
    window.check(rows, cols, starts, boxes, w, row_tile)
    window.check(rows, cols, starts_wide, boxes, w_wide, row_tile)
    window.check_raw(rows, cols, raw_rows, raw_cols)
    if redo is None and k_in != K_IN:
        raise ValueError(f"the split kernel holds {K_IN} in-shell slots; k_in={k_in} needs redo=")
    if redo is not None:
        _check_redo(rows, redo, k_in)
    if window.runs_plain(rows, "lsi_split_window"):
        return lsi_split_window_plain(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols,
                                      starts_wide, w_wide, low_sq, high, high_sq, outer_sq,
                                      redo=redo, k_in=k_in)
    scalars = (low_sq, high, high_sq, outer_sq)
    extra = window.raw_args(raw_rows, raw_cols) + (
        (ctypes.c_void_p, starts_wide.data_ptr()), (ctypes.c_int, w_wide))
    if redo is None:
        outs = _outs(rows, 4)
        window.launch("lsi_window", "lsi_split_launch", rows, cols, starts, boxes, w, row_tile,
                      scalars, outs, extra=extra)
    else:
        m, dev = redo.numel(), rows.device
        outs = tuple(torch.empty(m, dtype=k, device=dev)
                     for k in (torch.float32, torch.bool, torch.int32, torch.int32))
        # the slots of a rung wider than the kernel's shared buffer
        scratch = torch.empty(2 * m * k_in if k_in > K_ESC else 0, dtype=torch.float32, device=dev)
        extra += ((ctypes.c_void_p, redo.data_ptr()), (ctypes.c_int, m), (ctypes.c_int, k_in),
                  (ctypes.c_void_p, scratch.data_ptr()))
        window.launch("lsi_window", "lsi_split_redo_launch", rows, cols, starts, boxes, w,
                      row_tile, scalars, outs, extra=extra)
    clock.count("launches:lsi_split_window")
    return outs


def _check_redo(rows, redo, k_in):
    """Raise on a `redo` list or `k_in` the escalation form does not take."""
    F, _, n_rows = rows.shape
    if redo.device != rows.device or redo.dtype != torch.int64 or redo.dim() != 1:
        raise ValueError(f"redo must be a 1-D int64 tensor on {rows.device}, got "
                         f"{redo.dtype} {tuple(redo.shape)} on {redo.device}")
    if not redo.is_contiguous() or not 0 < redo.numel() < 2**31:
        raise ValueError(f"redo must be contiguous with 1 to 2**31 - 1 entries, got {redo.numel()}")
    lo, hi = torch.aminmax(redo)
    if int(lo) < 0 or int(hi) >= F * n_rows:
        raise ValueError(f"redo indices must lie in [0, {F * n_rows})")
    if not 0 < k_in < 2**26:
        raise ValueError(f"k_in={k_in} must lie in [1, 2**26)")


def _epilogue(dist, rawsq, fin, high):
    """The JAX package's `lsi_epilogue`, operation by operation, over N
    sorted slots: dist (F, r, N) ascending imaged distances (+inf where
    empty), rawsq (F, r, N) raw squared distances (+inf where a slot cannot
    be the next neighbor), fin (F, r, N) the slot holds a candidate.
    Returns (var, ok, n_near), each (F, r)."""
    high = torch.tensor(high, dtype=torch.float32, device=dist.device)
    n = dist.shape[-1]
    n_near = (fin & (dist <= high)).sum(dim=-1).to(torch.float32)
    best_raw = torch.full_like(n_near, math.inf)
    next_dist = torch.zeros_like(n_near)
    has_next = torch.zeros_like(fin[..., 0])
    for j in range(n):
        isnext = fin[..., j] & (dist[..., j] > high)
        better = isnext & (rawsq[..., j] < best_raw)
        best_raw = torch.where(better, rawsq[..., j], best_raw)
        next_dist = torch.where(better, dist[..., j], next_dist)
        has_next = has_next | isnext
    last = torch.clamp(n_near - 1.0, min=0.0).long()
    final_gap = next_dist - dist.gather(-1, last[..., None])[..., 0]
    denom = torch.clamp(n_near, min=1.0)
    inner = [(j < n_near - 1.0) & torch.isfinite(dist[..., j + 1]) for j in range(n - 1)]
    sum_gaps = final_gap
    for j in range(n - 1):
        sum_gaps = sum_gaps + torch.where(inner[j], dist[..., j + 1] - dist[..., j], 0.0)
    mean = sum_gaps / denom
    var = (final_gap - mean) ** 2
    for j in range(n - 1):
        var = var + torch.where(inner[j], (dist[..., j + 1] - dist[..., j] - mean) ** 2, 0.0)
    return var / denom, (n_near > 1.0) & has_next, n_near


def _store(outs, r0, r1, var, ok, n_near):
    lsi, valid, count = outs[:3]
    lsi[:, r0:r1] = torch.where(ok, var, 0.0)
    valid[:, r0:r1] = ok
    count[:, r0:r1] = torch.where(ok, n_near, 0.0).to(torch.int32)


def _raw_dsq(raw_rows, raw_cols, r0, r1, col):
    """(F, r, k) raw squared distances from rows [r0, r1) to the columns
    `col` (F, r, k), column minus row, as the kernels' `dot3`."""
    F, r, k = col.shape
    idx = col.clamp(0, raw_cols.shape[2] - 1).reshape(F, 1, r * k).expand(F, 3, r * k)
    e = raw_cols.gather(2, idx).reshape(F, 3, r, k) - raw_rows[:, :, r0:r1, None]
    return window.dot3(e[:, 0], e[:, 0], e[:, 1], e[:, 1], e[:, 2], e[:, 2], fused=True)


@clock.plain
def lsi_window_plain(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols, low_sq, high,
                     outer_sq):
    """Plain PyTorch version of `lsi_window`, same contract and slot order
    (24 rounds of lowest-column minimum extraction)."""
    window.check(rows, cols, starts, boxes, w, row_tile)
    window.check_raw(rows, cols, raw_rows, raw_cols)
    outs = _outs(rows, 3)
    tiles = window.topk_tiles(rows, cols, starts, boxes, w, row_tile, low_sq, outer_sq, K,
                              fused=True)
    for r0, r1, top in tiles:
        if top is None:  # a window outside the columns
            outs[0][:, r0:r1], outs[1][:, r0:r1], outs[2][:, r0:r1] = math.nan, False, 0
            continue
        rawsq = torch.where(top.ok, _raw_dsq(raw_rows, raw_cols, r0, r1, top.col), math.inf)
        _store(outs, r0, r1, *_epilogue(sqrt_f32(top.dsq), rawsq, top.ok, high))
    return outs


def _window_dsq(rows, cols, boxes, r0, r1, s, w):
    """(F, r, w) imaged squared distances of rows [r0, r1) to columns
    [s, s + w), as the kernels' `dot3`."""
    d = window.window_disp(rows, cols, boxes, r0, r1, s, w)
    return window.dot3(d[:, 0], d[:, 0], d[:, 1], d[:, 1], d[:, 2], d[:, 2], fused=True)


@clock.plain
def lsi_split_window_plain(rows, cols, starts, boxes, w, row_tile, raw_rows, raw_cols,
                           starts_wide, w_wide, low_sq, high, high_sq, outer_sq, redo=None,
                           k_in=K_IN):
    """Plain PyTorch version of `lsi_split_window`, same contract, both
    forms: the k_in smallest in-shell squared distances (as values: equal
    ones need no order), and the first column of least raw distance among
    the wide window's (high, high+3.7] candidates. With `redo`, only the
    row tiles that hold a listed pair are computed."""
    window.check(rows, cols, starts, boxes, w, row_tile)
    window.check(rows, cols, starts_wide, boxes, w_wide, row_tile)
    window.check_raw(rows, cols, raw_rows, raw_cols)
    dev = rows.device
    low, hi2, out2 = (torch.tensor(v, dtype=torch.float32, device=dev)
                      for v in (low_sq, high_sq, outer_sq))
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    outs = _outs(rows, 3)
    n_rows, n_cols = rows.shape[2], cols.shape[2]
    shell_n = torch.zeros((rows.shape[0], n_rows), dtype=torch.int32, device=dev)
    tiles = range(starts.numel())
    if redo is not None:
        tiles = sorted(set((redo % n_rows // row_tile).tolist()))
    for t in tiles:
        s_n, s_w = int(starts[t]), int(starts_wide[t])
        r0, r1 = t * row_tile, min(n_rows, (t + 1) * row_tile)
        if not (0 <= s_n <= n_cols - w and 0 <= s_w <= n_cols - w_wide):
            outs[0][:, r0:r1], outs[1][:, r0:r1], outs[2][:, r0:r1] = math.nan, False, 0
            shell_n[:, r0:r1] = -1
            continue
        # pass 1: in-shell over the narrow window
        dsq = _window_dsq(rows, cols, boxes, r0, r1, s_n, w)
        shell = (dsq > low) & (dsq <= hi2)
        cd = torch.sort(torch.where(shell, dsq, inf), dim=-1).values[..., :k_in]
        if cd.shape[-1] < k_in:
            cd = torch.nn.functional.pad(cd, (0, k_in - cd.shape[-1]), value=math.inf)
        # pass 2: least raw distance over the wide window's next shell
        dsq = _window_dsq(rows, cols, boxes, r0, r1, s_w, w_wide)
        cand = (dsq > hi2) & (dsq <= out2)
        col = torch.arange(s_w, s_w + w_wide, device=dev).expand(dsq.shape)
        rawm = torch.where(cand, _raw_dsq(raw_rows, raw_cols, r0, r1, col), inf)
        best_raw = rawm.min(dim=-1, keepdim=True).values
        eq = (rawm == best_raw) & torch.isfinite(rawm)
        fc = torch.where(eq, col - s_w, w_wide).min(dim=-1, keepdim=True).values
        best_img = dsq.gather(-1, fc.clamp(max=w_wide - 1))
        has_next = torch.isfinite(best_raw)
        dist = torch.cat([sqrt_f32(cd), torch.where(has_next, sqrt_f32(best_img), inf)], dim=-1)
        rawsq = torch.cat([torch.full_like(cd, math.inf), best_raw], dim=-1)
        fin = torch.cat([torch.isfinite(cd), has_next], dim=-1)
        _store(outs, r0, r1, *_epilogue(dist, rawsq, fin, high))
        shell_n[:, r0:r1] = shell.sum(dim=-1)
    if redo is None:
        return (*outs, (shell_n > K_IN) | (shell_n < 0))
    got = tuple(o.reshape(-1)[redo] for o in (*outs, shell_n))
    over = got[3] > k_in
    got[0][over], got[1][over], got[2][over] = math.nan, False, 0
    return got


def split_tier(n: int, box_z: float, high_cut: float) -> bool:
    """Whether a system of `n` centers takes the split-shell tier.

    This is the rule by which the JAX package's `lsi_calc` picks its LSI
    kernel on a TPU, so that both packages take the same tier at every
    size: the split tier's next-shell pick (least raw distance among all
    candidates) differs from the K = 24 tiers' (among the 24 nearest). On
    the split tier the port also gives that pick on the rows that overfill
    the split kernel's 12 slots, where the JAX package falls back to its
    K = 24 pick. It copies the TPU's fit predicates,
    `slab.fits_scoped_vmem(128, window, 24)` and
    `lsi_slab2.fits_lsi_split(128, 1536, 12, n + 2 pad, ceil(n / 128))`,
    and the N <= 400,000 cut; it models no memory of this card. True where
    the K = 24 slab kernel would not fit the TPU's scoped memory and the
    split kernel would.
    """
    window, pad = slab.plan(n, box_z, high_cut + NEXT_SHELL, ROW_TILE)
    if 128 * window * 4 * (2.0 + 0.32 * K) <= 15_500_000:
        return False
    seg, n_ext, n_tiles = 1536, n + 2 * pad, -(-n // 128)
    need = (128 * seg * 4 * (2.0 + 0.32 * K_IN) + 4 * 128 * seg * 4 + 2 * 3 * n_ext * 4
            + 4 * n_tiles * 128 * 4)
    return n <= 400_000 and need <= 14_000_000


# `last_tier`: which tier served the most recent lsi_certified call, "slab"
# | "slab-split" | "brute"
__getattr__ = clock.tier_attr("lsi_certified", __name__)


def _escalate(args, incomplete, outs):
    """Redo the split launch's incomplete rows on the card and write them
    into `outs` (lsi, valid, count, each (F, R)): the escalation form with
    K_ESC in-shell slots, then, for the rows that overfill even those, with
    as many slots as the fullest of them holds. Counts the rows redone
    (`lsi:escalation:rows`) and those that took the last rung
    (`lsi:escalation:last`), inside a `lsi:escalation` span."""
    redo = torch.nonzero(incomplete.reshape(-1)).squeeze(1)
    clock.count("lsi:escalation:rows", redo.numel())
    if redo.numel() == 0:
        return
    with clock.span("lsi:escalation", device=True):
        got = lsi_split_window(*args, redo=redo, k_in=K_ESC)
        over = torch.nonzero(got[3] > K_ESC).squeeze(1)
        clock.count("lsi:escalation:last", over.numel())
        if over.numel():
            last = lsi_split_window(*args, redo=redo[over], k_in=int(got[3][over].max()))
            for g, x in zip(got, last):
                g[over] = x
        for o, g in zip(outs, got):
            o.view(-1)[redo] = g


@clock.traced("dispatch:lsi_certified", device=True)
def lsi_certified(pos, boxes, low_cut=0.0, high_cut=3.7):
    """LSI with certified exactness, on the JAX package's tier for this size.

    Where `split_tier` holds and both of its windows are covered: the split
    kernel over a narrow window at margin `high_cut` and a wide one at
    `high_cut + 3.7`, its incomplete rows (more than 12 within `high_cut`)
    redone on the card by `_escalate`; every row gets the definition's
    next-shell pick. Otherwise the K = 24 kernel through `window.certified`
    at margin `high_cut + 3.7`: the slab form if covered, else the brute
    form. pos: (F, N, 3) f32 stored coordinates; boxes: (F, 3) f32.

    Returns (lsi (F, N) f32, valid (F, N) bool, count (F, N) int32) in the
    original atom order.
    """
    n, box_z = pos.shape[1], float(boxes[0, 2])
    outer = high_cut + NEXT_SHELL
    low_sq, high_sq, outer_sq = low_cut * low_cut, high_cut * high_cut, outer * outer
    if split_tier(n, box_z, high_cut):
        w_wide, pad = slab.plan(n, box_z, outer, ROW_TILE)
        w_narrow = slab.suggest_window(n, box_z, margin=high_cut, row_tile=ROW_TILE)
        prep = slab.slab_prep_traj(pos, boxes, ((high_cut, w_narrow), (outer, w_wide)), ROW_TILE,
                                   pad)
        if bool((prep.covered[0] & prep.covered[1]).all()):
            raw_t = slab.raw_ext_t(pos, prep.order0, pad)
            args = (prep.ext_t[:, :, pad : pad + n], prep.ext_t, prep.starts[0], boxes,
                    prep.ws[0], ROW_TILE, raw_t[:, :, pad : pad + n], raw_t, prep.starts[1],
                    prep.ws[1], low_sq, high_cut, high_sq, outer_sq)
            *outs, incomplete = lsi_split_window(*args)
            _escalate(args, incomplete, outs)
            clock.serve_tier("lsi_certified", "slab-split")
            return tuple(slab.unsort_frames(o, prep.order0) for o in outs)
    out, tier = window.certified(lsi_window, pos, boxes, outer, ROW_TILE,
                                 low_sq, high_cut, outer_sq, raw=True)
    clock.serve_tier("lsi_certified", tier)
    return out
