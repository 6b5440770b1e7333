"""`voronoi_escalation_yield`: percent of the rows that the Voronoi
escalation tiers (every tier after the first) searched, bucket padding
included, that they certified: the program's counters
`voronoi:escalation:certified` over `voronoi:escalation:rows`, summed over
the window's recorded calls (core/program_trace.py)."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.calls(run) or ()
    rows = sum(c.counts.get("voronoi:escalation:rows", 0) for c in got)
    cert = sum(c.counts.get("voronoi:escalation:certified", 0) for c in got)
    return 100.0 * cert / rows if rows else None
