"""`h2d_gbps`: GB/s of the drivers' host-to-device copies (`h2d` spans):
the bytes moved (`h2d_bytes`) over the device time between each span's
CUDA events, summed over the window's recorded calls
(core/program_trace.py)."""

from bench_torch.core import program_trace


def read(run):
    got = [s for _, s in program_trace.spans(run, "h2d") or () if s.device_ms is not None]
    nbytes = sum(s.counts.get("h2d_bytes", 0) for s in got)
    ms = sum(s.device_ms for s in got)
    return nbytes / (ms * 1e6) if nbytes and ms > 0 else None
