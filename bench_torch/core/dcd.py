"""Writing a trajectory as a DCD file, the binary format of CHARMM, NAMD and
many MD engines, for the cells whose traffic reads from a file.

The layout is CHARMM's, little-endian, each record framed by its length as
a 4-byte int before and after:

- the header: `CORD` and 20 control ints (frames, first step, steps
  between frames, last step, the time step's float32 bits, the unit-cell
  flag set, CHARMM version 24);
- a title record (a count of 80-byte lines, then the lines);
- the atom count;
- for each frame a unit-cell record of 6 doubles (A, gamma, B, beta,
  alpha, C: an orthorhombic box, the angles 90 degrees), then the X, Y and
  Z records of every atom, float32.

Plain numpy; nothing of the program is used, so the file is the harness's
own yardstick of what the program reads."""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

CHARMM_VERSION = 24
TIME_STEP = 0.002  # the header's DELTA; no reader here uses it
TITLE = b"bench_torch: water frames made from a seed".ljust(80)
FRAMES_A_BLOCK = 256  # frames built in memory before each write


def _record(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


def frame_dtype(n_atoms: int) -> np.dtype:
    """One frame's bytes: the unit-cell record, then X, Y and Z, packed."""
    cell, axis = 6 * 8, 4 * n_atoms
    fields = [("cell_n0", "<i4"), ("cell", "<f8", (6,)), ("cell_n1", "<i4")]
    for a in "xyz":
        fields += [(f"{a}_n0", "<i4"), (a, "<f4", (n_atoms,)), (f"{a}_n1", "<i4")]
    dt = np.dtype(fields)
    assert dt.itemsize == cell + 8 + 3 * (axis + 8)
    return dt


def header(n_frames: int, n_atoms: int) -> bytes:
    """The three records before the first frame."""
    icntrl = [0] * 20
    icntrl[0] = n_frames        # NSET
    icntrl[1] = 0               # ISTART
    icntrl[2] = 1               # NSAVC
    icntrl[3] = n_frames        # NSTEP
    icntrl[9] = struct.unpack("<i", struct.pack("<f", TIME_STEP))[0]  # DELTA, float32 bits
    icntrl[10] = 1              # a unit cell on every frame
    icntrl[19] = CHARMM_VERSION
    return (_record(b"CORD" + struct.pack("<20i", *icntrl))
            + _record(struct.pack("<i", 1) + TITLE)
            + _record(struct.pack("<i", n_atoms)))


def write(path: str, positions: np.ndarray, boxes: np.ndarray) -> int:
    """Write positions (F, N, 3) and orthorhombic box edges (F, 3) to
    `path`; returns the bytes written."""
    n_frames, n_atoms = positions.shape[:2]
    dt = frame_dtype(n_atoms)
    block = np.empty(min(FRAMES_A_BLOCK, max(n_frames, 1)), dt)
    block["cell_n0"] = block["cell_n1"] = 48
    for a in "xyz":
        block[f"{a}_n0"] = block[f"{a}_n1"] = 4 * n_atoms
    block["cell"][:, [1, 3, 4]] = 90.0
    head = header(n_frames, n_atoms)
    with open(path, "wb") as fh:
        fh.write(head)
        for f0 in range(0, n_frames, block.shape[0]):
            b = block[:min(block.shape[0], n_frames - f0)]
            sl = slice(f0, f0 + b.shape[0])
            b["cell"][:, [0, 2, 5]] = boxes[sl]
            for d, a in enumerate("xyz"):
                b[a] = positions[sl, :, d]
            b.tofile(fh)
    return len(head) + n_frames * dt.itemsize


def touch(path: str) -> int:
    """Read one byte of every page of `path` through a fresh mmap, as the
    program's DCD reader maps the file; returns the bytes mapped. Timed at
    set-up, it shows whether the calls will read the file from memory."""
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        pages = np.frombuffer(mm, np.uint8)
        n = pages.size
        int(pages[::mmap.PAGESIZE].sum())
        del pages
    return n


def fs_type(path: str) -> str:
    """The type of the filesystem that holds `path`: that of the longest
    of this process's mount points above it."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    try:
        with open("/proc/self/mounts") as f:
            for line in f:
                _, mnt, typ = line.split()[:3]
                mnt = mnt.replace("\\040", " ")
                above = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if above and len(mnt) > len(best):
                    best, kind = mnt, typ
    except OSError:
        pass
    return kind
