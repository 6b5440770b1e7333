"""AMBER ASCII trajectory (.mdcrd/.crd) reader/writer, pure numpy.

The reference loads these through pytraj's `iterload`
(the reference structureLibs/TrajObject.py:33), which reads the classic
AMBER text convention: a title line, then each frame as the flattened
(3 * n_atoms) coordinates in 10F8.3 fixed-width lines, followed — for
periodic systems — by one 3F8.3 line of box lengths.

Fixed-width fields may abut without separators (e.g. "-100.123-200.456"),
so parsing slices 8-character fields rather than splitting on whitespace:
with newlines removed, a frame is exactly (3N [+3]) * 8 characters, and
numpy converts the S8 field view to floats in one vectorized astype.

The writer emits exactly this layout, which also makes every frame a fixed
byte count — `LazyMdcrd` seeks straight to a frame range for the streaming
pipeline (io/streaming.py).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from waterorderlib_tpu_torch.io.trajectory import Trajectory

_NATIVE = None


def _native():
    """ctypes handle to the native fixed-width decoder (native/mdcrdlib.cc),
    or None when the library isn't built. The native parse is bit-identical
    to the numpy path for fixed-point F8.3 fields and ~20x faster; any field
    it can't prove exact makes it return <0 and we fall back."""
    global _NATIVE
    if _NATIVE is None:
        so = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "native", "libmdcrd.so",
        )
        if os.path.exists(so):
            lib = ctypes.CDLL(so)
            lib.f8_decode.restype = ctypes.c_long
            lib.f8_decode.argtypes = [
                ctypes.c_char_p,  # raw body bytes (newlines ok, title excluded)
                ctypes.c_long,  # byte count
                ctypes.c_void_p,  # float32 out buffer
                ctypes.c_long,  # capacity in floats
            ]
            # load-time self-test: a stale or foreign .so must not silently
            # decode trajectories — verify a known vector and fall back to
            # the numpy parser on any mismatch
            probe = b"  12.345  -0.001 999.999\n -12.000"
            buf = np.empty(4, np.float32)
            n = lib.f8_decode(probe, len(probe), buf.ctypes.data, 4)
            expect = np.array([12.345, -0.001, 999.999, -12.0], np.float32)
            if n != 4 or not np.array_equal(buf, expect):
                from waterorderlib_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    "native/libmdcrd.so failed its decode self-test "
                    "(got n=%s %s); using the numpy parser", n, buf.tolist(),
                )
                _NATIVE = False
            else:
                _NATIVE = lib
        else:
            _NATIVE = False
    return _NATIVE or None


def _decode_fields(raw: bytes, path: str) -> np.ndarray:
    """Decode a byte stream of 8-char fixed-width fields (newlines allowed)
    into float32 values — native fast path with numpy fallback."""
    lib = _native()
    if lib is not None:
        cap = len(raw) // 8  # >= true field count (newlines only shrink it)
        out = np.empty(cap, np.float32)
        n = lib.f8_decode(raw, len(raw), out.ctypes.data_as(ctypes.c_void_p), cap)
        if n >= 0:
            return out[:n].copy()
        # negative: unparseable field (stars/scientific) or ragged layout —
        # fall through to the permissive numpy path
    body = raw.replace(b"\r", b"").replace(b"\n", b"")
    if len(body) % 8:
        raise ValueError(f"{path}: body length {len(body)} is not 8-char aligned")
    return np.frombuffer(body, dtype="S8").astype(np.float32)


def _frame_layout(n_atoms: int, has_box: bool) -> tuple[int, int]:
    """(values per frame, bytes per frame) for the fixed 10F8.3 layout
    (every line newline-terminated)."""
    nvals = 3 * n_atoms
    nlines = -(-nvals // 10)
    nbytes = nvals * 8 + nlines
    if has_box:
        nvals += 3
        nbytes += 3 * 8 + 1
    return nvals, nbytes


def _detect_box(n_values: int, n_atoms: int, has_box):
    """Decide whether frames carry a box line from the total value count."""
    if has_box is not None:
        return bool(has_box)
    per_nobox = 3 * n_atoms
    per_box = per_nobox + 3
    fits_box = n_values % per_box == 0
    fits_nobox = n_values % per_nobox == 0
    if fits_box and not fits_nobox:
        return True
    if fits_nobox and not fits_box:
        return False
    if fits_box and fits_nobox:
        # pathological frame counts fit both layouts; prefer the (far more
        # common) boxed convention — pass has_box explicitly to override
        from waterorderlib_tpu_torch.utils.logging import get_logger

        get_logger().warning(
            "mdcrd layout ambiguous (%d values fit both %d and %d per "
            "frame); assuming a box line — pass has_box=False to override",
            n_values, per_box, per_nobox,
        )
        return True
    raise ValueError(
        f"mdcrd value count {n_values} fits neither {per_nobox} nor "
        f"{per_box} values/frame for n_atoms={n_atoms}"
    )


def read_mdcrd(
    path: str, n_atoms: int, stride: int = 1, has_box: bool | None = None
) -> Trajectory:
    """Read an AMBER ASCII trajectory. `n_atoms` must come from the topology
    (the format does not encode it — pytraj needs the topology too).

    Returns a Trajectory; boxes are -1 for box-less files (matching the
    no-box convention of the other readers)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    nl = raw.index(b"\n")
    vals = _decode_fields(raw[nl + 1 :], path)
    box = _detect_box(len(vals), n_atoms, has_box)
    per = 3 * n_atoms + (3 if box else 0)
    if len(vals) % per:
        raise ValueError(
            f"{path}: {len(vals)} values is not a whole number of frames "
            f"({per} values/frame, n_atoms={n_atoms}, box={box})"
        )
    frames = vals.reshape(-1, per)
    pos = frames[:, : 3 * n_atoms].reshape(-1, n_atoms, 3)
    if box:
        boxes = frames[:, 3 * n_atoms :]
    else:
        boxes = np.full((frames.shape[0], 3), -1.0, np.float32)
    return Trajectory(pos[::stride].copy(), boxes[::stride].copy())


def write_mdcrd(path: str, traj: Trajectory, title: str = "waterorderlib_tpu"):
    """Write the fixed 10F8.3 AMBER ASCII layout (box line when the
    trajectory has a positive box).

    Values outside the F8.3 field (-999.999 .. 9999.999) would overflow the
    8-char column and silently corrupt the fixed-width layout (Fortran
    prints '********'); we raise instead — wrap the trajectory (e.g.
    np.mod(pos, box)) before writing unwrapped coordinates."""
    lo, hi = -999.9995, 9999.9995  # rounds to within 8 chars at %.3f
    has_box = bool(np.all(traj.boxes > 0))
    vals = [traj.positions] + ([traj.boxes] if has_box else [])
    for v in vals:
        if np.min(v) <= lo or np.max(v) >= hi:
            raise ValueError(
                "coordinate outside the F8.3 field (-999.999..9999.999); "
                "wrap positions into the box before writing mdcrd"
            )

    def lines(flat):
        return "".join(
            "".join(f"{v:8.3f}" for v in flat[i : i + 10]) + "\n"
            for i in range(0, len(flat), 10)
        )

    with open(path, "w") as fh:
        fh.write(title.replace("\n", " ") + "\n")
        for f in range(traj.n_frames):
            fh.write(lines(traj.positions[f].reshape(-1)))
            if has_box:
                fh.write("".join(f"{v:8.3f}" for v in traj.boxes[f]) + "\n")


class LazyMdcrd:
    """Frame-range reader over the fixed-width layout (streaming pipeline).

    Assumes the uniform 10F8.3 layout `write_mdcrd` produces (also what
    AMBER's sander/pmemd emit); frames are fixed byte counts, so a range
    read is one seek."""

    def __init__(self, path: str, n_atoms: int, has_box: bool | None = None):
        self._fh = open(path, "rb")
        first = self._fh.readline()
        self._offset = len(first)
        self._fh.seek(0, 2)
        total = self._fh.tell() - self._offset
        self.n_atoms = n_atoms
        if has_box is None:
            # byte-count divisibility mirrors _detect_box's value-count rule
            _, b_box = _frame_layout(n_atoms, True)
            _, b_nobox = _frame_layout(n_atoms, False)
            if total % b_box == 0:
                has_box = True  # prefer the boxed convention on a tie
            elif total % b_nobox == 0:
                has_box = False
            else:
                raise ValueError(f"{path}: size fits no uniform frame layout")
        self.has_box = bool(has_box)
        self._nvals, self._nbytes = _frame_layout(n_atoms, self.has_box)
        if total % self._nbytes:
            raise ValueError(
                f"{path}: {total} body bytes is not a whole number of "
                f"{self._nbytes}-byte frames"
            )
        self.n_frames = total // self._nbytes

    def read(self, start: int, count: int):
        count = max(0, min(count, self.n_frames - start))
        self._fh.seek(self._offset + start * self._nbytes)
        raw = self._fh.read(count * self._nbytes)
        vals = _decode_fields(raw, "LazyMdcrd")
        frames = vals.reshape(count, self._nvals)
        pos = frames[:, : 3 * self.n_atoms].reshape(count, self.n_atoms, 3)
        if self.has_box:
            boxes = frames[:, 3 * self.n_atoms :]
        else:
            boxes = np.full((count, 3), -1.0, np.float32)
        return pos.copy(), boxes.copy()

    def close(self):
        self._fh.close()
