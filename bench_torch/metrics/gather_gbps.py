"""`gather_gbps`: GB/s of the drivers' host gather of center rows (`gather`
spans): the bytes gathered (`gather_bytes`) over the spans' host time,
summed over the window's recorded calls (core/program_trace.py)."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.spans(run, "gather")
    if got is None:
        return None
    nbytes = sum(s.counts.get("gather_bytes", 0) for _, s in got)
    ms = sum(s.ms for _, s in got)
    return nbytes / (ms * 1e6) if nbytes and ms > 0 else None
