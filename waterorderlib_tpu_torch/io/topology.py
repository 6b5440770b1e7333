"""Topology representation and index selectors.

Replaces the reference's parmed/pytraj `TrajObject`
(the reference structureLibs/TrajObject.py:15-103) and the bond-graph walk
`getHBInds` (the reference structureLibs/orderParam_lib.py:46-120) with a
self-contained array-backed topology (no AMBER-mask engine dependency): atom
names/elements/residues are plain numpy arrays, selectors return int index
arrays with the same semantics as the reference's cpptraj masks, and
(de)serialization is a single JSON file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Topology:
    """Array-backed molecular topology.

    names:    (N,) atom names (e.g. 'O', 'H1', 'C2').
    elements: (N,) element symbols ('O', 'H', 'C', 'N', 'S', 'EP' for
              virtual/extra points).
    res_names:(N,) residue name per atom (e.g. 'WAT', 'MOL').
    res_ids:  (N,) integer residue index per atom (0-based, contiguous).
    bonds:    (M, 2) atom-index pairs.
    masses:   (N,) atomic masses (optional, zeros if unknown).
    """

    names: np.ndarray
    elements: np.ndarray
    res_names: np.ndarray
    res_ids: np.ndarray
    bonds: np.ndarray
    masses: np.ndarray = field(default=None)

    def __post_init__(self):
        self.names = np.asarray(self.names, dtype=object)
        self.elements = np.asarray(self.elements, dtype=object)
        self.res_names = np.asarray(self.res_names, dtype=object)
        self.res_ids = np.asarray(self.res_ids, dtype=np.int32)
        self.bonds = np.asarray(self.bonds, dtype=np.int32).reshape(-1, 2)
        if self.masses is None:
            self.masses = np.zeros(len(self.names), dtype=np.float64)
        self.masses = np.asarray(self.masses, dtype=np.float64)

    @property
    def n_atoms(self) -> int:
        return len(self.names)

    # ---- masks ----------------------------------------------------------
    def _is_water(self, wat_res: str = "WAT") -> np.ndarray:
        return self.res_names == wat_res

    def _is_h(self) -> np.ndarray:
        return self.elements == "H"

    def _is_ep(self) -> np.ndarray:
        return self.elements == "EP"

    # ---- selectors (TrajObject.py parity) -------------------------------
    def get_wat_inds(self, wat_res: str = "WAT"):
        """(watInds, watHInds, lenWat): water heavy (non-H, non-EP) indices,
        water H indices, and atoms-per-water (TrajObject.py:35-52)."""
        w = self._is_water(wat_res)
        wat = np.where(w & ~self._is_h() & ~self._is_ep())[0]
        wat_h = np.where(w & self._is_h())[0]
        n_wat_atoms = int(np.sum(w))
        len_wat = n_wat_atoms // len(wat) if len(wat) else 0
        return wat, wat_h, len_wat

    def get_heavy_inds(self):
        """All non-H, non-virtual atoms (TrajObject.py:54-63)."""
        return np.where(~self._is_h() & ~self._is_ep())[0]

    def get_phobic_inds(self):
        """Hydrophobic C and S atoms, system-wide (TrajObject.py:65-73)."""
        return np.where((self.elements == "C") | (self.elements == "S"))[0]

    def get_philic_inds(self):
        """Hydrophilic O and N atoms, system-wide (TrajObject.py:75-83)."""
        return np.where((self.elements == "O") | (self.elements == "N"))[0]

    def get_sol_inds(self, wat_res: str = "WAT"):
        """(solInds, solHInds, solCInds, solNInds, solOInds, solSInds) of the
        non-water cosolvent (TrajObject.py:85-103)."""
        s = ~self._is_water(wat_res)
        el = self.elements
        sol = np.where(s & ~self._is_h())[0]
        return (
            sol,
            np.where(s & self._is_h())[0],
            np.where(s & (el == "C"))[0],
            np.where(s & (el == "N"))[0],
            np.where(s & (el == "O"))[0],
            np.where(s & (el == "S"))[0],
        )

    # ---- H-bond donor/acceptor walk (orderParam_lib.py:46-120) ----------
    def bond_partners(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.n_atoms)]
        for a, b in self.bonds:
            out[int(a)].append(int(b))
            out[int(b)].append(int(a))
        return out

    def get_hb_inds(self, n_inds: np.ndarray, o_inds: np.ndarray):
        """Build (acceptor, donor, donorH) triplets for O and N atoms.

        Matches getHBInds: each O/N in the given sets becomes an acceptor;
        for every bonded atom whose *name* contains 'H' the heavy atom is
        appended once to the donor list paired with that hydrogen
        (orderParam_lib.py:71-108). Returns (hbO, hbN), each a list
        [acceptors, donors, donorHs] of int arrays.

        The walk is array operations over the directed bond edges, a->b
        then b->a for each bond, sorted stably by source: that lists every
        atom's partners in `bond_partners()` order. Acceptors are the
        targets inside [0, n_atoms) in ascending order, each once.
        """
        n = self.n_atoms
        src = self.bonds.reshape(-1).astype(int)
        dst = self.bonds[:, ::-1].reshape(-1).astype(int)
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]

        def walk(inds):
            t = np.asarray(inds).astype(int).ravel()
            target = np.zeros(n, dtype=bool)
            target[t[(t >= 0) & (t < n)]] = True
            from_target = target[src]
            don, donh = src[from_target], dst[from_target]
            is_h = np.fromiter(("H" in str(s) for s in self.names[donh]), dtype=bool,
                               count=len(donh))
            return [np.flatnonzero(target), don[is_h], donh[is_h]]

        return walk(o_inds), walk(n_inds)

    # ---- serialization ---------------------------------------------------
    def to_json(self, path: str):
        data = {
            "names": list(map(str, self.names)),
            "elements": list(map(str, self.elements)),
            "res_names": list(map(str, self.res_names)),
            "res_ids": self.res_ids.tolist(),
            "bonds": self.bonds.tolist(),
            "masses": self.masses.tolist(),
        }
        with open(path, "w") as fh:
            json.dump(data, fh)

    @classmethod
    def from_json(cls, path: str) -> "Topology":
        with open(path) as fh:
            d = json.load(fh)
        return cls(
            names=np.array(d["names"], dtype=object),
            elements=np.array(d["elements"], dtype=object),
            res_names=np.array(d["res_names"], dtype=object),
            res_ids=np.array(d["res_ids"]),
            bonds=np.array(d["bonds"], dtype=int).reshape(-1, 2),
            masses=np.array(d["masses"]),
        )
