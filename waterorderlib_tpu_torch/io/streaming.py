"""Streaming trajectory pipeline: larger-than-memory frame chunks with
host->device double buffering.

The reference iterates frames lazily through pytraj's `iterload`
(orderParam_lib.py:617 and every other driver loop). This module streams
frame chunks to the device:

- `LazyNetCDF` / `LazyDCD` read frame ranges straight from the mmap'd file
  (both formats store frames as fixed-stride records, so a chunk read is a
  seek + frombuffer — no full-file parse);
- `iter_chunks` yields (positions, boxes) chunks with a one-chunk prefetch
  thread, so disk/decode of chunk k+1 overlaps device compute on chunk k;
- drivers accept `chunk_frames=...` and scan per chunk with carried
  histograms — chunked results match the single-shot path (counts exactly,
  float stats to ~1 ulp) because every
  per-frame computation is frame-local.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
from queue import Queue

import numpy as np

from waterorderlib_tpu_torch.io.trajectory import Trajectory


class LazyNetCDF:
    """Lazy AMBER-convention NetCDF reader (frame-range access)."""

    def __init__(self, path: str):
        from waterorderlib_tpu_torch.io.netcdf import _Reader

        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._r = _Reader(self._mm)
        self._coords = self._r.var("coordinates")
        if self._coords is None or not self._coords["record"]:
            raise ValueError(f"{path}: no record 'coordinates' variable")
        self._cells = self._r.var("cell_lengths")
        self.n_frames = self._r._n_records(self._coords)
        self.n_atoms = self._coords["point_shape"][0]

    def read(self, start: int, count: int) -> tuple[np.ndarray, np.ndarray]:
        count = min(count, self.n_frames - start)
        pos = np.empty((count, self.n_atoms, 3), np.float32)
        boxes = np.full((count, 3), -1.0, np.float32)
        from waterorderlib_tpu_torch.io.netcdf import _TYPE_DTYPE

        cdt = _TYPE_DTYPE[self._coords["nc_type"]]
        for r in range(count):
            off = self._coords["begin"] + (start + r) * self._r.recsize
            pos[r] = np.frombuffer(
                self._mm, cdt, count=self._coords["point_count"], offset=off
            ).reshape(self.n_atoms, 3)
            if self._cells is not None:
                coff = self._cells["begin"] + (start + r) * self._r.recsize
                boxes[r] = np.frombuffer(self._mm, ">f8", count=3, offset=coff)
        return pos, boxes

    def close(self):
        self._mm.close()
        self._fh.close()


class LazyDCD:
    """Lazy DCD reader (frame-range access; fixed-stride frames)."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)

        def record_at(off):
            (n,) = struct.unpack_from("<i", self._mm, off)
            return off + 4, n, off + 8 + n

        off, n, nxt = record_at(0)
        if self._mm[off : off + 4] != b"CORD":
            raise ValueError("not a DCD file (missing CORD magic)")
        icntrl = struct.unpack_from("<20i", self._mm, off + 4)
        self.has_cell = icntrl[10] != 0
        _, _, nxt = record_at(nxt)  # title
        off, _, nxt = record_at(nxt)
        (self.n_atoms,) = struct.unpack_from("<i", self._mm, off)
        self._data_start = nxt
        self._frame_bytes = (3 * (4 * self.n_atoms + 8)) + (56 if self.has_cell else 0)
        self.n_frames = (len(self._mm) - self._data_start) // self._frame_bytes

    def read(self, start: int, count: int) -> tuple[np.ndarray, np.ndarray]:
        count = min(count, self.n_frames - start)
        pos = np.empty((count, self.n_atoms, 3), np.float32)
        boxes = np.full((count, 3), -1.0, np.float32)
        for r in range(count):
            off = self._data_start + (start + r) * self._frame_bytes
            if self.has_cell:
                cell = np.frombuffer(self._mm, "<f8", count=6, offset=off + 4)
                boxes[r] = [cell[0], cell[2], cell[5]]
                off += 56
            for d in range(3):
                pos[r, :, d] = np.frombuffer(
                    self._mm, "<f4", count=self.n_atoms, offset=off + 4
                )
                off += 4 * self.n_atoms + 8
        return pos, boxes

    def close(self):
        self._mm.close()
        self._fh.close()


class _ArraySource:
    """Chunk view over an in-memory Trajectory (no copy until slicing)."""

    def __init__(self, traj: Trajectory):
        self._t = traj
        self.n_frames = traj.n_frames
        self.n_atoms = traj.n_atoms

    def read(self, start: int, count: int):
        sl = slice(start, min(start + count, self.n_frames))
        return self._t.positions[sl], self._t.boxes[sl]

    def close(self):
        pass


def open_lazy(source, n_atoms: int | None = None):
    """A frame-range reader for a path (.nc/.dcd/.mdcrd) or in-memory
    Trajectory. AMBER ASCII needs `n_atoms` (the format doesn't encode it)."""
    if isinstance(source, Trajectory):
        return _ArraySource(source)
    low = str(source).lower()
    if low.endswith((".nc", ".ncdf", ".netcdf")):
        return LazyNetCDF(source)
    if low.endswith(".dcd"):
        return LazyDCD(source)
    if low.endswith((".mdcrd", ".crd")):
        if n_atoms is None:
            raise ValueError("streaming an AMBER ASCII trajectory needs n_atoms")
        from waterorderlib_tpu_torch.io.mdcrd import LazyMdcrd

        return LazyMdcrd(source, n_atoms)
    if low.endswith(".npz"):
        # compressed archives cannot be partially decoded; load once and
        # chunk the in-memory array (still bounds DEVICE memory per chunk)
        return _ArraySource(Trajectory.load(source))
    raise ValueError(f"unsupported streaming source: {source}")


def iter_chunks(source, chunk_frames: int, stride: int = 1, n_atoms: int | None = None):
    """Yield (positions (C, N, 3) f32, boxes (C, 3) f32) chunks.

    One chunk of read-ahead runs on a prefetch thread, so decoding chunk
    k+1 overlaps device compute on chunk k (the PP-analog of SURVEY §2c:
    a host->device double-buffered input pipeline).
    """
    rdr = open_lazy(source, n_atoms=n_atoms)
    t = None
    stop = threading.Event()
    q: Queue = Queue(maxsize=1)
    try:
        starts = list(range(0, rdr.n_frames, chunk_frames * stride))
        if not starts:
            return

        def bounded_put(item):
            # bounded put so an abandoned consumer can't block us forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return
                except Exception:  # queue.Full
                    continue

        error: list = []

        def produce():
            try:
                for s in starts:
                    if stop.is_set():
                        break
                    pos, boxes = rdr.read(s, chunk_frames * stride)
                    bounded_put((pos[::stride], boxes[::stride]))
            except Exception as e:  # surfaced to the consumer below
                error.append(e)
            finally:
                bounded_put(None)  # end-of-stream sentinel MUST eventually land

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            try:
                item = q.get(timeout=1.0)
            except Exception:  # queue.Empty: re-check producer health
                if not t.is_alive() and q.empty():
                    break
                continue
            if item is None:
                break
            pos, boxes = item
            yield np.asarray(pos, np.float32), np.asarray(boxes, np.float32)
        if error:
            raise error[0]
    finally:
        # unwind safely when the consumer raises mid-iteration: signal the
        # producer, drain its pending chunk (so its q.put returns and it
        # drops any live views of the mmap), join, and only then close the
        # mmap — closing early would raise BufferError (masking the caller's
        # exception) and leave the thread blocked forever
        stop.set()
        if t is not None:
            try:
                while not q.empty():
                    q.get_nowait()
            except Exception:
                pass
            t.join(timeout=5.0)
        try:
            rdr.close()
        except BufferError:
            pass  # a straggling read still holds a view; let GC reclaim the
            # map rather than mask the caller's exception
