"""Plain reference of the per-water Voronoi volume and area (the original
library's orderParam_lib.py:920-962): the points followed by their
reflection across the nearer box face in each axis, Qhull's Voronoi
diagram of that set in float64 (scipy), and for each original point its
cell's surface area (the sum of its faces' areas) and volume (the sum over
faces of area x half the distance to the neighbor / 3). A cell that Qhull
leaves open is infinite.

It imports numpy and scipy only, so that `cells_frames` can spread the
frames over worker processes. The control rounds the coordinates to TF32
before the diagram (Qhull computes in float64 only)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import Voronoi


def mirrored(points: np.ndarray, box_l: float) -> np.ndarray:
    """points (n, 3) then, for each axis, every point reflected across the
    face nearer to it in that axis: (4 n, 3)."""
    near = np.where(points >= 0.5 * box_l, 2.0 * box_l - points, -points)
    out = [points]
    for ax in range(3):
        r = points.copy()
        r[:, ax] = near[:, ax]
        out.append(r)
    return np.vstack(out)


def _polygon_areas(verts: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Areas of convex polygons verts (G, L, 3) lying in planes of normals
    (G, 3): the vertices ordered by angle about their centroid, then the
    shoelace sum."""
    c = verts.mean(axis=1, keepdims=True)
    r = verts - c
    nhat = normal / np.linalg.norm(normal, axis=1, keepdims=True)
    e1 = r[:, 0, :] - np.einsum("gk,gk->g", r[:, 0, :], nhat)[:, None] * nhat
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(nhat, e1)
    x, y = np.einsum("glk,gk->gl", r, e1), np.einsum("glk,gk->gl", r, e2)
    order = np.argsort(np.arctan2(y, x), axis=1)
    x, y = np.take_along_axis(x, order, 1), np.take_along_axis(y, order, 1)
    return 0.5 * np.abs(np.sum(x * np.roll(y, -1, 1) - np.roll(x, -1, 1) * y, axis=1))


def cells(points: np.ndarray, box_l: float) -> tuple[np.ndarray, np.ndarray]:
    """(volume (n,), area (n,)) float64 of the cells of `points` (n, 3)."""
    n = points.shape[0]
    vor = Voronoi(mirrored(np.asarray(points, np.float64), float(box_l)))
    rp = vor.ridge_points
    vol, area = np.zeros(n), np.zeros(n)
    is_open = np.zeros(n, bool)
    by_len: dict[int, list[int]] = {}
    for r, (a, b) in enumerate(rp):
        if a >= n and b >= n:
            continue
        rv = vor.ridge_vertices[r]
        if -1 in rv:
            is_open[[i for i in (a, b) if i < n]] = True
            continue
        by_len.setdefault(len(rv), []).append(r)
    for _, rows in by_len.items():
        rows = np.asarray(rows)
        verts = vor.vertices[np.asarray([vor.ridge_vertices[r] for r in rows])]
        pa, pb = vor.points[rp[rows, 0]], vor.points[rp[rows, 1]]
        a = _polygon_areas(verts, pb - pa)
        h = 0.5 * np.linalg.norm(pb - pa, axis=1)
        for side in (0, 1):
            idx = rp[rows, side]
            m = idx < n
            np.add.at(area, idx[m], a[m])
            np.add.at(vol, idx[m], a[m] * h[m] / 3.0)
    vol[is_open] = np.inf
    area[is_open] = np.inf
    return vol, area


def _cells_star(args):
    return cells(*args)


def cells_frames(frames: list[np.ndarray], box_ls: list[float], workers: int = 1):
    """`cells` of each frame, over `workers` spawned processes when more
    than one; returns (volumes (F, n), areas (F, n))."""
    jobs = list(zip(frames, box_ls))
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        pool = mp.get_context("spawn").Pool(min(workers, len(jobs)))
        try:
            outs = pool.map(_cells_star, jobs)
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    else:
        outs = [cells(*j) for j in jobs]
    return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])
