"""`hb_matrix_ms`: ms a call of device time in the H-bond cluster
dispatch's matrix: the `hb_clusters:matrix` spans (CUDA events around the
acceptor x donor H-bond matrix and its fold into the residue adjacency,
one a frame block), summed over the window's recorded calls and divided
by their number (core/program_trace.py). None where the program records
no such span."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.spans(run, "hb_clusters:matrix")
    ms = [s.device_ms for _, s in got or () if s.device_ms is not None]
    return sum(ms) / len(program_trace.calls(run)) if ms else None
