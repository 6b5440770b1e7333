"""`gather_gbps`: GB/s of the order-parameter drivers' device gather of
center rows (`orderparams._center_rows`: `device_gather` spans, one a chunk
of frames): the rows made (`device_gather_bytes`) over the device time
between each span's CUDA events, summed over the window's recorded calls
(core/program_trace.py). The device gather took the place of the drivers'
host gather of center rows (`gather` spans, `gather_bytes`), which only
the Voronoi driver keeps; it is not read here."""

from bench_torch.core import program_trace


def read(run):
    got = [s for _, s in program_trace.spans(run, "device_gather") or ()
           if s.device_ms is not None]
    nbytes = sum(s.counts.get("device_gather_bytes", 0) for s in got)
    ms = sum(s.device_ms for s in got)
    return nbytes / (ms * 1e6) if nbytes and ms > 0 else None
