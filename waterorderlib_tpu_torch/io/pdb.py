"""Minimal PDB snapshot writer.

Replaces the labeled-snapshot export of the reference's DMSO driver
(the reference structureLibs/other/orderParam_lib_dmso.py:1671-1683),
which relabels bound/wrap/second-shell water residues BND/WRP/SEC and writes
`snapshot.pdb` for visualization.
"""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu_torch.io.topology import Topology


def write_pdb(
    path: str,
    topology: Topology,
    positions: np.ndarray,
    box: np.ndarray | None = None,
    res_name_override: dict[int, str] | None = None,
):
    """Write one frame as PDB. res_name_override maps atom index -> residue
    name (applied to every atom of that atom's residue is the caller's
    responsibility; pass all member atoms)."""
    positions = np.asarray(positions)
    over = res_name_override or {}
    lines = []
    if box is not None:
        b = np.asarray(box, float)
        lines.append(
            f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1"
        )
    for i in range(topology.n_atoms):
        name = str(topology.names[i])[:4]
        res = over.get(i, str(topology.res_names[i]))[:3]
        resid = int(topology.res_ids[i]) % 10000
        x, y, z = positions[i]
        el = str(topology.elements[i])[:2].rjust(2)
        lines.append(
            f"ATOM  {i % 100000:5d} {name:<4s} {res:<3s}  {resid:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {el}"
        )
    lines.append("END")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_labeled_snapshot(
    path: str,
    topology: Topology,
    positions: np.ndarray,
    box: np.ndarray,
    bound_inds: np.ndarray,
    wrap_inds: np.ndarray,
    second_inds: np.ndarray | None = None,
):
    """Relabel hydration populations BND/WRP (and SEC for a second shell)
    and write the frame (dmso driver parity). Index arrays hold any atom of
    the water; the whole residue is relabeled."""
    over: dict[int, str] = {}

    def label(inds, tag):
        if inds is None:
            return
        for a in np.asarray(inds, int):
            res = topology.res_ids[a]
            for j in np.where(topology.res_ids == res)[0]:
                over[int(j)] = tag

    label(second_inds, "SEC")
    label(wrap_inds, "WRP")
    label(bound_inds, "BND")
    write_pdb(path, topology, positions, box, res_name_override=over)
