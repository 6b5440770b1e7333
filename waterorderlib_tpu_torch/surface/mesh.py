"""Isosurface extraction and triangle-mesh utilities (port of
waterorderlib_tpu.surface.mesh), host numpy.

Isosurfaces come from **marching tetrahedra** (each grid cube split into 6
tetrahedra; per-tetrahedron cases are derived from vertex signs, no lookup
tables), which produces a watertight triangle mesh of the level set;
`marching_tetrahedra` is the JAX package's function, with its vertex weld
and face order. Also: the imagelib mesh helpers `triangleArea`
(imagelib.f90:254-267), `transformTriangle` (:270-301) and
`propertyBarycentric` (:305-320) in numpy (float64 for float64 input, where
the JAX package computes them in float32), and the angle-defect discrete
Gaussian curvature that replaces trimesh's
`discrete_gaussian_curvature_measure` for mesh coloring.
"""

from __future__ import annotations

import itertools

import numpy as np

# The 6-tetrahedra decomposition of a unit cube (vertex ids 0..7 with
# bit order: v = x + 2*y + 4*z). All share the main diagonal 0-7.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int64,
)

_CUBE_OFFSETS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.int64
)  # index = x + 2y + 4z


def marching_tetrahedra(
    volume: np.ndarray,
    level: float,
    spacing=(1.0, 1.0, 1.0),
    origin=(0.0, 0.0, 0.0),
):
    """Extract the `level` isosurface of a 3-D scalar field.

    volume: (Nx, Ny, Nz) scalar field; returns (verts (V, 3), faces (F, 3)).
    Vertices lie on grid edges, linearly interpolated; triangles are
    consistently oriented with normals pointing toward higher field values.
    """
    vol = np.asarray(volume, dtype=np.float64)
    nx, ny, nz = vol.shape
    sp = np.asarray(spacing, dtype=np.float64).reshape(3)
    org = np.asarray(origin, dtype=np.float64).reshape(3)

    # cell base coordinates
    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # (C, 3)
    # cube corner coords (C, 8, 3) and values (C, 8)
    corners = base[:, None, :] + _CUBE_OFFSETS[None, :, :]
    vals = vol[corners[..., 0], corners[..., 1], corners[..., 2]]

    # cheap cull: keep only cubes straddling the level
    lo = vals.min(axis=1)
    hi = vals.max(axis=1)
    keep = (lo < level) & (hi >= level)
    corners = corners[keep]
    vals = vals[keep]
    if corners.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # (C, 4)
        tc = corners[:, tet, :]  # (C, 4, 3)
        inside = tv >= level  # (C, 4)
        n_in = inside.sum(axis=1)

        def edge_point(c_sel, a, b):
            va = tv[c_sel][:, a]
            vb = tv[c_sel][:, b]
            t = (level - va) / np.where(vb != va, vb - va, 1.0)
            pa = tc[c_sel][:, a, :].astype(np.float64)
            pb = tc[c_sel][:, b, :].astype(np.float64)
            return pa + t[:, None] * (pb - pa)

        # case: exactly one vertex inside -> one triangle around it
        for v_in in range(4):
            sel = (n_in == 1) & inside[:, v_in]
            if not np.any(sel):
                continue
            others = [o for o in range(4) if o != v_in]
            p = [edge_point(sel, v_in, o) for o in others]
            tris.append(np.stack(p, axis=1))
        # case: exactly three inside -> one triangle around the outside one
        for v_out in range(4):
            sel = (n_in == 3) & ~inside[:, v_out]
            if not np.any(sel):
                continue
            others = [o for o in range(4) if o != v_out]
            p = [edge_point(sel, o, v_out) for o in others]
            tris.append(np.stack(p, axis=1))
        # case: two inside -> quad split into two triangles
        for pair in itertools.combinations(range(4), 2):
            a, b = pair
            sel = (n_in == 2) & inside[:, a] & inside[:, b]
            if not np.any(sel):
                continue
            c, d = [o for o in range(4) if o not in pair]
            pac = edge_point(sel, a, c)
            pad = edge_point(sel, a, d)
            pbc_ = edge_point(sel, b, c)
            pbd = edge_point(sel, b, d)
            tris.append(np.stack([pac, pad, pbd], axis=1))
            tris.append(np.stack([pac, pbd, pbc_], axis=1))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tri_pts = np.concatenate(tris, axis=0)  # (T, 3, 3) in grid units

    # weld duplicate vertices
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * 1e6).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # representative coordinates (first occurrence)
    first = np.full(len(uniq), -1, dtype=np.int64)
    for idx, u in enumerate(inv):
        if first[u] < 0:
            first[u] = idx
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[good]
    verts_world = org[None, :] + verts * sp[None, :]
    return verts_world, faces


def triangle_area(verts) -> np.ndarray:
    """Area of 3-D triangle(s) (imagelib.f90:254-267). verts: (..., 3, 3)."""
    v = np.asarray(verts)
    a = v[..., 1, :] - v[..., 0, :]
    b = v[..., 2, :] - v[..., 0, :]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)


def transform_triangle(verts) -> np.ndarray:
    """Rotate 3-D triangle(s) into 2-D plane coordinates
    (imagelib.f90:270-301): vertex 0 at the origin, vertex 1 on the +x axis,
    vertex 2 in the upper half plane. verts: (..., 3, 3) -> (..., 3, 2)."""
    v = np.asarray(verts)
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    x_len = np.linalg.norm(e1, axis=-1)
    xhat = e1 / np.maximum(x_len, 1e-12)[..., None]
    proj = np.sum(e2 * xhat, axis=-1)
    perp = e2 - proj[..., None] * xhat
    y_len = np.linalg.norm(perp, axis=-1)
    zeros = np.zeros_like(x_len)
    p0 = np.stack([zeros, zeros], axis=-1)
    p1 = np.stack([x_len, zeros], axis=-1)
    p2 = np.stack([proj, y_len], axis=-1)
    return np.stack([p0, p1, p2], axis=-2)


def property_barycentric(vert_props) -> np.ndarray:
    """Interpolate vertex properties to triangle centroids
    (imagelib.f90:305-320): the mean of the 3 vertex values.
    vert_props: (..., 3) -> (...)."""
    return np.mean(np.asarray(vert_props), axis=-1)


def gaussian_curvature(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Angle-defect discrete Gaussian curvature per vertex (2*pi minus the
    sum of incident triangle angles). Replaces trimesh's
    discrete_gaussian_curvature_measure for mesh coloring."""
    verts = np.asarray(verts, float)
    faces = np.asarray(faces, int)
    defect = np.full(len(verts), 2.0 * np.pi)
    for k in range(3):
        i = faces[:, k]
        j = faces[:, (k + 1) % 3]
        l = faces[:, (k + 2) % 3]
        u = verts[j] - verts[i]
        w = verts[l] - verts[i]
        cu = np.linalg.norm(u, axis=1)
        cw = np.linalg.norm(w, axis=1)
        cosang = np.einsum("ij,ij->i", u, w) / np.maximum(cu * cw, 1e-12)
        ang = np.arccos(np.clip(cosang, -1.0, 1.0))
        np.subtract.at(defect, i, ang)
    return defect


def mesh_area(verts: np.ndarray, faces: np.ndarray) -> float:
    """Total surface area of a triangle mesh."""
    return float(np.sum(triangle_area(np.asarray(verts)[np.asarray(faces)])))
