"""Trajectory container and loaders.

Replaces the pytraj `iterload` trajectory of the reference
(the reference structureLibs/TrajObject.py:33) with a simple array-backed
container. Frames live in a single (F, N, 3) float32 array plus per-frame
(F, 3) orthorhombic boxes — exactly the HBM-resident layout the device
kernels consume. Native formats: our own .npz (positions + boxes + optional
embedded topology JSON); AMBER NetCDF/DCD readers can be layered on when
those parsers are available in the environment.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from waterorderlib_tpu_torch.io.topology import Topology


@dataclass
class Trajectory:
    """In-memory trajectory: positions (F, N, 3) f32, boxes (F, 3) f32."""

    positions: np.ndarray
    boxes: np.ndarray

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float32)
        self.boxes = np.asarray(self.boxes, dtype=np.float32)
        assert self.positions.ndim == 3 and self.positions.shape[-1] == 3
        assert self.boxes.shape == (self.positions.shape[0], 3)

    @property
    def n_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[1]

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, sl) -> "Trajectory":
        return Trajectory(self.positions[sl], self.boxes[sl])

    def strided(self, stride: int) -> "Trajectory":
        """Every `stride`-th frame (TrajObject's stride semantics)."""
        return Trajectory(self.positions[::stride], self.boxes[::stride])

    def save(self, path: str, topology: Topology | None = None):
        extra = {}
        if topology is not None:
            extra["topology_json"] = np.array(
                json.dumps(
                    {
                        "names": list(map(str, topology.names)),
                        "elements": list(map(str, topology.elements)),
                        "res_names": list(map(str, topology.res_names)),
                        "res_ids": topology.res_ids.tolist(),
                        "bonds": topology.bonds.tolist(),
                        "masses": topology.masses.tolist(),
                    }
                )
            )
        np.savez_compressed(path, positions=self.positions, boxes=self.boxes, **extra)

    @classmethod
    def load(cls, path: str, stride: int = 1) -> "Trajectory":
        with np.load(path, allow_pickle=False) as d:
            traj = cls(d["positions"], d["boxes"])
        return traj.strided(stride) if stride > 1 else traj


def load_topology_from_npz(path: str) -> Topology | None:
    with np.load(path, allow_pickle=False) as d:
        if "topology_json" not in d:
            return None
        t = json.loads(str(d["topology_json"]))
    return Topology(
        names=np.array(t["names"], dtype=object),
        elements=np.array(t["elements"], dtype=object),
        res_names=np.array(t["res_names"], dtype=object),
        res_ids=np.array(t["res_ids"]),
        bonds=np.array(t["bonds"], dtype=int).reshape(-1, 2),
        masses=np.array(t["masses"]),
    )


def load_topology(top_file: str) -> Topology:
    """Load a topology by extension: .json (ours), .npz (embedded), or AMBER
    .prmtop/.parm7/.top (TrajObject.py:30 loads these via parmed)."""
    low = top_file.lower()
    if low.endswith(".json"):
        return Topology.from_json(top_file)
    if low.endswith(".npz"):
        top = load_topology_from_npz(top_file)
        if top is None:
            raise ValueError(f"no topology embedded in {top_file}")
        return top
    if low.endswith((".prmtop", ".parm7", ".top")):
        from waterorderlib_tpu_torch.io.amber import load_prmtop

        return load_prmtop(top_file)
    raise ValueError(f"unsupported topology format: {top_file}")


def load_trajectory(traj_file: str, stride: int = 1, n_atoms: int | None = None) -> Trajectory:
    """Load a trajectory by extension: .npz (ours), .dcd, AMBER NetCDF
    .nc/.ncdf/.netcdf, or AMBER ASCII .mdcrd/.crd (TrajObject.py:33 reads
    the AMBER formats via pytraj iterload). ASCII mdcrd does not encode the
    atom count, so it requires `n_atoms` (load_system passes it from the
    topology)."""
    low = traj_file.lower()
    if low.endswith(".npz"):
        return Trajectory.load(traj_file, stride=stride)
    if low.endswith(".dcd"):
        from waterorderlib_tpu_torch.io.dcd import read_dcd

        return read_dcd(traj_file, stride=stride)
    if low.endswith((".nc", ".ncdf", ".netcdf")):
        from waterorderlib_tpu_torch.io.netcdf import read_amber_netcdf

        return read_amber_netcdf(traj_file, stride=stride)
    if low.endswith((".mdcrd", ".crd")):
        if n_atoms is None:
            raise ValueError(
                "AMBER ASCII trajectories need n_atoms (use load_system, "
                "which passes it from the topology)"
            )
        from waterorderlib_tpu_torch.io.mdcrd import read_mdcrd

        return read_mdcrd(traj_file, n_atoms, stride=stride)
    raise ValueError(f"unsupported trajectory format: {traj_file}")


def load_system(top_file: str, traj_file: str | None, stride: int = 1):
    """One-call loader mirroring TrajObject(topFile, trajFile, stride).

    top_file: .json / .npz (embedded) / AMBER .prmtop/.parm7/.top.
    traj_file: .npz / .dcd / AMBER NetCDF .nc / AMBER ASCII .mdcrd/.crd
    (or None for topology-only use).
    """
    top = load_topology(top_file)
    traj = (
        load_trajectory(traj_file, stride=stride, n_atoms=top.n_atoms)
        if traj_file else None
    )
    return top, traj
