"""`psi6_truncated_share`: percent of the psi6 rows whose full shell holds
more than the K = 24 neighbors kept, the rows whose answer the top-24
selection decides: the program's counters `psi6:rows_over_k` over
`psi6:rows`, summed over the window's recorded calls
(core/program_trace.py). None where no recorded call holds the counters
(a program without them)."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.calls(run) or ()
    rows = sum(c.counts.get("psi6:rows", 0) for c in got)
    over = sum(c.counts.get("psi6:rows_over_k", 0) for c in got)
    return 100.0 * over / rows if rows else None
