"""AMBER PRMTOP topology parser.

Replaces the reference's parmed dependency (`pmd.load_file`,
the reference structureLibs/TrajObject.py:30) for the common case: a
self-contained reader of the AMBER7 PRMTOP text format producing our
array-backed Topology (names, elements, residues, bonds, masses). Only the
sections the selectors and H-bond walks need are parsed.
"""

from __future__ import annotations

import numpy as np

from waterorderlib_tpu_torch.io.topology import Topology

_ELEMENTS = {
    1: "H", 6: "C", 7: "N", 8: "O", 9: "F", 11: "Na", 12: "Mg", 15: "P",
    16: "S", 17: "Cl", 19: "K", 20: "Ca", 26: "Fe", 30: "Zn", 35: "Br",
    53: "I", 0: "EP",
}


def _parse_sections(text: str) -> dict[str, list[str]]:
    sections: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        if line.startswith("%FLAG"):
            current = line.split()[1]
            sections[current] = []
        elif line.startswith("%FORMAT") or line.startswith("%VERSION") or line.startswith("%COMMENT"):
            continue
        elif current is not None:
            sections[current].append(line)
    return sections


def _fixed_width(lines: list[str], width: int) -> list[str]:
    out = []
    for line in lines:
        for i in range(0, len(line.rstrip("\n")), width):
            tok = line[i : i + width]
            if tok.strip():
                out.append(tok.strip())
    return out


def _numbers(lines: list[str], dtype=float) -> np.ndarray:
    vals: list = []
    for line in lines:
        vals.extend(line.split())
    return np.asarray(vals, dtype=dtype)


def _element_from_name(name: str) -> str:
    for ch in name:
        if ch.isalpha():
            return ch.upper()
    return "X"


def write_prmtop(path: str, top: Topology):
    """Write a minimal AMBER7 PRMTOP with the sections `load_prmtop` reads
    (POINTERS/ATOM_NAME/MASS/ATOMIC_NUMBER/RESIDUE_LABEL/RESIDUE_POINTER/
    BONDS_*). Enough for round-trips and real-format driver fixtures."""
    z_of = {v: k for k, v in _ELEMENTS.items()}
    natom = top.n_atoms
    res_starts = [0] + [
        i for i in range(1, natom) if top.res_ids[i] != top.res_ids[i - 1]
    ]
    nres = len(res_starts)

    def fmt_ints(vals, per_line=10, width=8):
        lines = []
        for i in range(0, len(vals), per_line):
            lines.append("".join(f"{int(v):{width}d}" for v in vals[i : i + per_line]))
        return "\n".join(lines) or ""

    def fmt_strs(vals, per_line=20, width=4):
        lines = []
        for i in range(0, len(vals), per_line):
            lines.append("".join(f"{str(v):<{width}s}" for v in vals[i : i + per_line]))
        return "\n".join(lines) or ""

    def fmt_floats(vals, per_line=5):
        lines = []
        for i in range(0, len(vals), per_line):
            lines.append("".join(f"{float(v):16.8E}" for v in vals[i : i + per_line]))
        return "\n".join(lines) or ""

    is_h = [str(e) == "H" for e in top.elements]
    bonds_h, bonds_heavy = [], []
    for i, j in np.asarray(top.bonds, int):
        (bonds_h if is_h[i] or is_h[j] else bonds_heavy).extend([3 * i, 3 * j, 1])

    pointers = [0] * 31
    pointers[0] = natom
    pointers[2] = len(bonds_h) // 3  # NBONH
    pointers[3] = len(bonds_heavy) // 3  # MBONA
    pointers[11] = nres

    parts = ["%VERSION  VERSION_STAMP = V0001.000  (waterorderlib_tpu)"]

    def section(flag, fmt, body):
        parts.append(f"%FLAG {flag}")
        parts.append(f"%FORMAT({fmt})")
        parts.append(body)

    section("POINTERS", "10I8", fmt_ints(pointers))
    section("ATOM_NAME", "20a4", fmt_strs([str(n)[:4] for n in top.names]))
    section("MASS", "5E16.8", fmt_floats(top.masses))
    section(
        "ATOMIC_NUMBER", "10I8",
        fmt_ints([z_of.get(str(e), 0) for e in top.elements]),
    )
    section(
        "RESIDUE_LABEL", "20a4",
        fmt_strs([str(top.res_names[s])[:4] for s in res_starts]),
    )
    section("RESIDUE_POINTER", "10I8", fmt_ints([s + 1 for s in res_starts]))
    section("BONDS_INC_HYDROGEN", "10I8", fmt_ints(bonds_h))
    section("BONDS_WITHOUT_HYDROGEN", "10I8", fmt_ints(bonds_heavy))
    with open(path, "w") as fh:
        fh.write("\n".join(parts) + "\n")


def load_prmtop(path: str) -> Topology:
    """Parse an AMBER PRMTOP file into a Topology."""
    with open(path) as fh:
        sec = _parse_sections(fh.read())

    pointers = _numbers(sec["POINTERS"], int)
    natom = int(pointers[0])
    nres = int(pointers[11])

    names = _fixed_width(sec["ATOM_NAME"], 4)[:natom]
    masses = _numbers(sec["MASS"])[:natom]

    if "ATOMIC_NUMBER" in sec:
        z = _numbers(sec["ATOMIC_NUMBER"], int)[:natom]
        elements = [_ELEMENTS.get(int(n), _element_from_name(nm)) for n, nm in zip(z, names)]
    else:
        elements = [_element_from_name(nm) for nm in names]
    # extra points / virtual sites
    elements = ["EP" if nm.upper().startswith("EP") else el for nm, el in zip(names, elements)]

    res_labels = _fixed_width(sec["RESIDUE_LABEL"], 4)[:nres]
    res_ptr = _numbers(sec["RESIDUE_POINTER"], int)[:nres]  # 1-based atom starts
    res_names = np.empty(natom, dtype=object)
    res_ids = np.zeros(natom, dtype=int)
    bounds = list(res_ptr - 1) + [natom]
    for r in range(nres):
        res_names[bounds[r] : bounds[r + 1]] = res_labels[r]
        res_ids[bounds[r] : bounds[r + 1]] = r

    bonds = []
    for key in ("BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN"):
        if key in sec:
            arr = _numbers(sec[key], int)
            # AMBER stores coordinate-array indices (3*i) in triples (i, j, type)
            for k in range(0, len(arr), 3):
                bonds.append([arr[k] // 3, arr[k + 1] // 3])
    bonds = np.asarray(bonds, int).reshape(-1, 2) if bonds else np.zeros((0, 2), int)

    return Topology(
        names=np.array(names, dtype=object),
        elements=np.array(elements, dtype=object),
        res_names=res_names,
        res_ids=res_ids,
        bonds=bonds,
        masses=masses,
    )
