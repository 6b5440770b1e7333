"""3-D surface/contact visualization (port of
waterorderlib_tpu.surface.plotting).

Replaces `genSphere`, `connectPlot`, `sasaPlot`, `densityPlot`
(the reference's surface_library.py:33-39, :352-391, :426-480,
:484-557). trimesh's curvature measure is replaced by the angle-defect
Gaussian curvature in surface.mesh; matplotlib is imported lazily with the
Agg backend so headless environments work.
"""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu_torch.surface.grids import density_grid, sasa_grid
from waterorderlib_tpu_torch.surface.mesh import gaussian_curvature, property_barycentric


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def gen_sphere():
    """Unit-sphere wireframe coordinates (surface_library.py:33-39)."""
    u = np.linspace(0, np.pi, 30)
    v = np.linspace(0, 2 * np.pi, 30)
    x = np.outer(np.sin(u), np.sin(v))
    y = np.outer(np.sin(u), np.cos(v))
    z = np.outer(np.cos(u), np.ones_like(v))
    return x, y, z


def connect_plot(heavy_pos, conn_mat, atom_prop, prop_name: str = "figure"):
    """3-D scatter colored by a per-atom property with contact-graph edges
    (surface_library.py:352-391). Writes <prop_name>.png."""
    matplotlib, plt = _plt()
    heavy_pos = np.asarray(heavy_pos)
    atom_prop = np.asarray(atom_prop).reshape(-1)
    fig = plt.figure(figsize=(10, 6))
    ax = fig.add_subplot(111, projection="3d")
    p = ax.scatter(
        heavy_pos[:, 0], heavy_pos[:, 1], heavy_pos[:, 2],
        c=atom_prop, vmin=atom_prop.min(), vmax=atom_prop.max(), cmap="RdBu_r",
    )
    ii, jj = np.nonzero(np.triu(np.asarray(conn_mat)))
    for i, j in zip(ii, jj):
        seg = np.stack([heavy_pos[i], heavy_pos[j]])
        ax.plot3D(seg[:, 0], seg[:, 1], seg[:, 2], color="black", linewidth=0.25)
    fig.colorbar(p, ax=ax, fraction=0.025, pad=0.0, location="left")
    fig.savefig(prop_name + ".png", dpi=120)
    plt.close(fig)


def _mesh_plot(verts, faces, out_png: str):
    matplotlib, plt = _plt()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    from matplotlib import cm

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    gauss = gaussian_curvature(verts, faces)
    face_prop = np.asarray(property_barycentric(gauss[faces]))
    norm = plt.Normalize(gauss.min(), max(gauss.max(), gauss.min() + 1e-9))
    cmap = plt.get_cmap("RdBu_r")
    colors = cmap(norm(face_prop))
    ax.add_collection3d(
        Poly3DCollection(verts[faces], alpha=0.5, facecolors=colors, linewidth=0.0)
    )
    mappable = cm.ScalarMappable(norm=norm, cmap=cmap)
    fig.colorbar(mappable=mappable, ax=ax, fraction=0.025, pad=0.0, location="left")
    lo, hi = verts.min(), verts.max()
    ax.set_xlim([0.9 * lo, 1.1 * hi])
    ax.set_ylim([0.9 * lo, 1.1 * hi])
    ax.set_zlim([0.9 * lo, 1.1 * hi])
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def sasa_plot(heavy_pos, box, vdw_radii, wat_radius: float = 1.4, out_png: str = "sasaSurf.png",
              device="cuda"):
    """Curvature-colored SASA isosurface (surface_library.py:426-480)."""
    verts, faces = sasa_grid(heavy_pos, box, np.asarray(vdw_radii) + wat_radius, device=device)
    if len(faces) == 0:
        return verts, faces
    _mesh_plot(verts, faces, out_png)
    return verts, faces


def density_plot(
    heavy_pos, wat_pos, box, level: float = 0.016, out_png: str = "densitySurf.png",
    device="cuda",
):
    """Curvature-colored Willard-Chandler interface mesh
    (surface_library.py:484-557)."""
    verts, faces = density_grid(heavy_pos, wat_pos, box, level=level, device=device)
    if len(faces) == 0:
        return verts, faces
    _mesh_plot(verts, faces, out_png)
    return verts, faces
