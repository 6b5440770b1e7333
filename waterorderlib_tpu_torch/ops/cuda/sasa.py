"""Shrake-Rupley occlusion counts: the CUDA kernel's two wrappers and their
plain PyTorch versions (port of waterorderlib_tpu.ops.pallas.sasa_kernel,
serving the XLA tiers of waterorderlib_tpu.surface.sasa).

For each atom i (center c, radius r, probe included) and each unit point u
of P sphere points, the point c + r u is occluded when it lies strictly
inside an occluder sphere j: with pt = fma(r, u, c) and d = pt - occ_j,
fma(dz, dz, fma(dy, dy, dx*dx)) < r_j^2. That is the JAX package's
quadratic test in the order and with the fused multiply-adds XLA's CPU
backend gives it, so the visible counts n_vis equal the JAX tiers' exactly
and the pruned and brute tiers stay bit-identical. The Pallas kernel's
linear MXU form rounds apart at the occlusion boundary and is not ported.

`sasa_topk` tests each atom's K occluder slots (gathered and reimaged by the
caller, as `surface.sasa.sphere_surface_areas_topk` gathers them);
`sasa_brute` tests all N atoms, reimaged around each center as
`pbc.minimum_image` does, j = i left out by index. Each wrapper launches its
kernel (csrc/sasa.cu) on CUDA tensors and calls its plain version on CPU
tensors; any other device raises. There is no fallback from a kernel to a
plain version. n_vis is int32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from waterorderlib_tpu_torch.core import clock, pbc
from waterorderlib_tpu_torch.core.fp32 import fma_f32
from waterorderlib_tpu_torch.ops.cuda import build, window

PAIR_BUDGET = 1 << 22  # (point, occluder) tests per block of the plain versions

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _check(centers, radii, points, *more):
    dev = centers.device
    for name, t in (("centers", centers), ("radii", radii), ("points", points), *more):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, centers on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "valid" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n = centers.shape[0]
    if centers.dim() != 2 or centers.shape[1] != 3 or tuple(radii.shape) != (n,):
        raise ValueError(f"centers must be (N, 3) and radii (N,), got {tuple(centers.shape)}, "
                         f"{tuple(radii.shape)}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (P, 3), got {tuple(points.shape)}")


def _check_slots(centers, occ, occ_rsq, valid):
    n = centers.shape[0]
    k = occ.shape[1] if occ.dim() == 3 else -1
    if occ.dim() != 3 or tuple(occ.shape) != (n, k, 3) or tuple(occ_rsq.shape) != (n, k):
        raise ValueError(f"occ must be (N, K, 3) and occ_rsq (N, K), got {tuple(occ.shape)}, "
                         f"{tuple(occ_rsq.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n, k):
        raise ValueError(f"valid must be bool (N, K), got {valid.dtype} {tuple(valid.shape)}")


def _points_at(centers, radii, points):
    """(B, P, 3) sphere points fma(r, u, c) of a block of atoms."""
    b, p = centers.shape[0], points.shape[0]
    return fma_f32(radii[:, None, None].expand(b, p, 3), points[None].expand(b, p, 3),
                   centers[:, None, :].expand(b, p, 3))


def _n_visible(pts, occ, rsq):
    """Visible counts (B,) int32 of (B, P, 3) points against (B, M, 3)
    occluders of squared radii (B, M) (-inf where a slot cannot occlude)."""
    d = pts[:, :, None, :] - occ[:, None, :, :]
    d2 = fma_f32(d[..., 2], d[..., 2], fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    return (~(d2 < rsq[:, None, :]).any(dim=-1)).sum(dim=-1, dtype=torch.int32)


def _blocks(n, tests_per_atom):
    step = max(1, PAIR_BUDGET // max(1, tests_per_atom))
    return ((s, min(n, s + step)) for s in range(0, n, step))


def _launch(entry, argtypes, args):
    fn = getattr(build.load("sasa"), entry)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, _c_ptr]
        fn.restype = _c_int
    with torch.cuda.device(args[0].device):
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


@clock.kernel
def sasa_topk(centers, radii, points, occ, occ_rsq, valid):
    """Visible point counts (N,) int32 of each atom against its K occluder
    slots. centers (N, 3), radii (N,), points (P, 3) unit points, occ
    (N, K, 3) occluder centers reimaged around each atom, occ_rsq (N, K)
    their squared radii, valid (N, K) bool: the slot holds an occluder.
    All contiguous, float32 but `valid`."""
    _check(centers, radii, points, ("occ", occ), ("occ_rsq", occ_rsq), ("valid", valid))
    _check_slots(centers, occ, occ_rsq, valid)
    if window.runs_plain(centers, "sasa_topk"):
        return sasa_topk_plain(centers, radii, points, occ, occ_rsq, valid)
    n, k = occ.shape[:2]
    n_vis = torch.empty(n, dtype=torch.int32, device=centers.device)
    _launch("sasa_topk_launch",
            [_c_ptr, _c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr],
            (centers, radii, n, points, points.shape[0], occ, occ_rsq, valid, k, n_vis))
    clock.count("launches:sasa_topk")
    return n_vis


@clock.plain
def sasa_topk_plain(centers, radii, points, occ, occ_rsq, valid):
    """Plain PyTorch version of `sasa_topk`, blocked over atoms."""
    _check(centers, radii, points, ("occ", occ), ("occ_rsq", occ_rsq), ("valid", valid))
    _check_slots(centers, occ, occ_rsq, valid)
    n, k = occ.shape[:2]
    rsq = torch.where(valid, occ_rsq, -math.inf)
    return torch.cat([
        _n_visible(_points_at(centers[s:e], radii[s:e], points), occ[s:e], rsq[s:e])
        for s, e in _blocks(n, points.shape[0] * k)
    ] or [torch.zeros(0, dtype=torch.int32, device=centers.device)])


@clock.kernel
def sasa_brute(centers, radii, points, box):
    """Visible point counts (N,) int32 of each atom against all N atoms,
    each reimaged around the atom in `box` (3,) (a non-positive edge: no
    wrap), the atom itself left out. centers (N, 3), radii (N,), points
    (P, 3) unit points: contiguous float32."""
    _check(centers, radii, points, ("box", box))
    if tuple(box.shape) != (3,):
        raise ValueError(f"box must be (3,), got {tuple(box.shape)}")
    if window.runs_plain(centers, "sasa_brute"):
        return sasa_brute_plain(centers, radii, points, box)
    n = centers.shape[0]
    n_vis = torch.empty(n, dtype=torch.int32, device=centers.device)
    _launch("sasa_brute_launch", [_c_ptr, _c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr],
            (centers, radii, n, points, points.shape[0], box, n_vis))
    clock.count("launches:sasa_brute")
    return n_vis


@clock.plain
def sasa_brute_plain(centers, radii, points, box):
    """Plain PyTorch version of `sasa_brute`, blocked over atoms."""
    _check(centers, radii, points, ("box", box))
    n = centers.shape[0]
    rsq = radii * radii
    idx = torch.arange(n, device=centers.device)
    outs = []
    for s, e in _blocks(n, points.shape[0] * n):
        c = centers[s:e]
        occ = c[:, None, :] + pbc.minimum_image(centers[None, :, :] - c[:, None, :], box)
        own = torch.where(idx[s:e, None] == idx[None, :], -math.inf, rsq[None, :])
        outs.append(_n_visible(_points_at(c, radii[s:e], points), occ, own))
    return torch.cat(outs or [torch.zeros(0, dtype=torch.int32, device=centers.device)])
