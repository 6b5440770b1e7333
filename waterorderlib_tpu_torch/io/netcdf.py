"""AMBER NetCDF trajectory reader/writer (pure numpy, zero dependencies).

The reference loads AMBER trajectories through pytraj's `iterload`
(the reference structureLibs/TrajObject.py:33), which natively reads the
AMBER NetCDF convention. AMBER NetCDF files are plain netCDF-3 "classic"
(or 64-bit-offset) files — a simple self-describing binary layout that needs
no external library, so this module implements a compact netCDF-3 parser and
maps the AMBER convention (`coordinates(frame, atom, spatial)` float32,
`cell_lengths(frame, cell_spatial)` double) onto our Trajectory container.
"""

from __future__ import annotations

import struct

import numpy as np

from waterorderlib_tpu_torch.io.trajectory import Trajectory

_NC_BYTE, _NC_CHAR, _NC_SHORT, _NC_INT, _NC_FLOAT, _NC_DOUBLE = 1, 2, 3, 4, 5, 6
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 4, 6: 8}
_TYPE_DTYPE = {
    1: np.dtype(">i1"), 2: np.dtype("S1"), 3: np.dtype(">i2"),
    4: np.dtype(">i4"), 5: np.dtype(">f4"), 6: np.dtype(">f8"),
}
_ABSENT = 0
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C


class _Reader:
    """Minimal netCDF-3 (classic / 64-bit offset) structure parser."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0
        magic = self._bytes(3)
        if magic != b"CDF":
            raise ValueError("not a netCDF-3 file (missing CDF magic)")
        self.version = self._bytes(1)[0]
        if self.version not in (1, 2):
            raise ValueError(f"unsupported netCDF version byte {self.version}")
        self.numrecs = self._int()
        self.dims = self._dim_list()  # [(name, size)]
        self._att_list()  # global attributes: parsed and skipped
        self.vars = self._var_list()
        # records: sum of vsize over record vars; the single-record-var
        # special case uses the var's unpadded size as the stride
        rec_vars = [v for v in self.vars if v["record"]]
        if len(rec_vars) == 1:
            v = rec_vars[0]
            self.recsize = v["point_size"]
        else:
            self.recsize = sum(v["vsize"] for v in rec_vars)

    # --- primitive readers -------------------------------------------------
    def _bytes(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            raise ValueError("truncated netCDF header")
        self.off += n
        return b

    def _int(self) -> int:
        return struct.unpack(">i", self._bytes(4))[0]

    def _int64(self) -> int:
        return struct.unpack(">q", self._bytes(8))[0]

    def _name(self) -> str:
        n = self._int()
        s = self._bytes(n).decode("ascii")
        self.off += (-n) % 4  # names padded to 4-byte boundary
        return s

    # --- header lists ------------------------------------------------------
    def _dim_list(self):
        tag, n = self._int(), self._int()
        if tag == _ABSENT:
            return []
        assert tag == _NC_DIMENSION, f"bad dim tag {tag}"
        return [(self._name(), self._int()) for _ in range(n)]

    def _att_list(self):
        tag, n = self._int(), self._int()
        if tag == _ABSENT:
            return {}
        assert tag == _NC_ATTRIBUTE, f"bad attr tag {tag}"
        out = {}
        for _ in range(n):
            name = self._name()
            nc_type = self._int()
            nelems = self._int()
            nbytes = nelems * _TYPE_SIZE[nc_type]
            raw = self._bytes(nbytes)
            self.off += (-nbytes) % 4
            if nc_type == _NC_CHAR:
                out[name] = raw.decode("ascii", "replace")
            else:
                out[name] = np.frombuffer(raw, _TYPE_DTYPE[nc_type])
        return out

    def _var_list(self):
        tag, n = self._int(), self._int()
        if tag == _ABSENT:
            return []
        assert tag == _NC_VARIABLE, f"bad var tag {tag}"
        out = []
        for _ in range(n):
            name = self._name()
            ndims = self._int()
            dimids = [self._int() for _ in range(ndims)]
            self._att_list()
            nc_type = self._int()
            vsize = self._int()
            begin = self._int64() if self.version == 2 else self._int()
            shape = [self.dims[d][1] for d in dimids]
            record = bool(shape) and shape[0] == 0  # record dim has size 0
            point_shape = shape[1:] if record else shape
            point_count = int(np.prod(point_shape)) if point_shape else 1
            out.append(
                dict(
                    name=name, nc_type=nc_type, vsize=vsize, begin=begin,
                    record=record, shape=shape, point_shape=point_shape,
                    point_size=point_count * _TYPE_SIZE[nc_type],
                    point_count=point_count,
                )
            )
        return out

    # --- data access ---------------------------------------------------------
    def var(self, name: str):
        for v in self.vars:
            if v["name"] == name:
                return v
        return None

    def read_var(self, name: str) -> np.ndarray:
        """Full contents of a variable as a native-endian numpy array."""
        v = self.var(name)
        if v is None:
            raise KeyError(name)
        dt = _TYPE_DTYPE[v["nc_type"]]
        if not v["record"]:
            arr = np.frombuffer(
                self.data, dt, count=v["point_count"], offset=v["begin"]
            )
            return arr.reshape(v["point_shape"]).astype(dt.newbyteorder("="))
        nrec = self._n_records(v)
        out = np.empty((nrec, v["point_count"]), dt.newbyteorder("="))
        for r in range(nrec):
            off = v["begin"] + r * self.recsize
            out[r] = np.frombuffer(self.data, dt, count=v["point_count"], offset=off)
        return out.reshape((nrec, *v["point_shape"]))

    def _n_records(self, v) -> int:
        if self.numrecs not in (-1, 0xFFFFFFFF):
            return self.numrecs
        # streaming numrecs: infer from the file size
        return max(0, (len(self.data) - v["begin"]) // self.recsize)


def read_amber_netcdf(path: str, stride: int = 1) -> Trajectory:
    """Read an AMBER-convention NetCDF trajectory into a Trajectory.

    Uses `coordinates` (frame, atom, spatial) and, when present,
    `cell_lengths` (frame, cell_spatial); boxes default to -1 (no box) when
    cell information is absent, matching the DCD reader's convention.
    """
    with open(path, "rb") as fh:
        r = _Reader(fh.read())
    coords = r.read_var("coordinates").astype(np.float32)
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"{path}: unexpected coordinates shape {coords.shape}")
    if r.var("cell_lengths") is not None:
        boxes = r.read_var("cell_lengths").astype(np.float32)[:, :3]
    else:
        boxes = np.full((coords.shape[0], 3), -1.0, np.float32)
    traj = Trajectory(coords, boxes)
    return traj.strided(stride) if stride > 1 else traj


def write_amber_netcdf(path: str, traj: Trajectory):
    """Write a minimal AMBER-convention netCDF-3 classic file (round-trip
    and fixture use; includes coordinates + cell_lengths record vars so the
    multi-record-variable layout is exercised)."""
    n_atoms = traj.n_atoms

    def name(s: str) -> bytes:
        b = s.encode("ascii")
        return struct.pack(">i", len(b)) + b + b"\x00" * ((-len(b)) % 4)

    def att_text(nm: str, text: str) -> bytes:
        b = text.encode("ascii")
        return (
            name(nm) + struct.pack(">ii", _NC_CHAR, len(b)) + b + b"\x00" * ((-len(b)) % 4)
        )

    dims = [("frame", 0), ("spatial", 3), ("atom", n_atoms), ("cell_spatial", 3)]
    dim_list = struct.pack(">ii", _NC_DIMENSION, len(dims)) + b"".join(
        name(nm) + struct.pack(">i", sz) for nm, sz in dims
    )
    gatts = struct.pack(">ii", _NC_ATTRIBUTE, 3) + b"".join(
        [
            att_text("Conventions", "AMBER"),
            att_text("ConventionVersion", "1.0"),
            att_text("program", "waterorderlib_tpu"),
        ]
    )

    coord_vsize = -(-n_atoms * 3 * 4 // 4) * 4  # already 4-aligned
    cell_vsize = 3 * 8
    # header size depends only on fixed content below; compute by assembling
    def var_entry(nm, dimids, nc_type, vsize, begin):
        return (
            name(nm)
            + struct.pack(">i", len(dimids))
            + b"".join(struct.pack(">i", d) for d in dimids)
            + struct.pack(">ii", _ABSENT, 0)  # no var attributes
            + struct.pack(">iii", nc_type, vsize, begin)
        )

    # assemble with placeholder begins to measure the header, then fix up
    def assemble(begin_coord, begin_cell):
        var_list = struct.pack(">ii", _NC_VARIABLE, 2) + b"".join(
            [
                var_entry("coordinates", [0, 2, 1], _NC_FLOAT, coord_vsize, begin_coord),
                var_entry("cell_lengths", [0, 3], _NC_DOUBLE, cell_vsize, begin_cell),
            ]
        )
        return b"CDF\x01" + struct.pack(">i", traj.n_frames) + dim_list + gatts + var_list

    header_len = len(assemble(0, 0))
    begin_coord = header_len
    begin_cell = begin_coord + coord_vsize
    blob = bytearray(assemble(begin_coord, begin_cell))
    for f in range(traj.n_frames):
        blob += traj.positions[f].astype(">f4").tobytes()
        blob += traj.boxes[f].astype(">f8").tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
