"""`topology_ms`: ms a call in the drivers' index derivation from the
topology (`topology` spans: the centers, the row map, the H-bond triplets,
the Voronoi heavy and water selection), self time, mean over the window's
recorded calls (core/program_trace.py)."""

from bench_torch.core import program_trace


def read(run):
    if program_trace.spans(run, "topology") is None:
        return None
    got = program_trace.calls(run)
    return sum(c.self_ms(s) for c in got for s in c.named("topology")) / len(got)
