"""`cluster_sweeps`: label-propagation sweeps a frame in the H-bond
cluster dispatch: the program's counters `hb_clusters:sweeps` (each sweep
of a frame block, the last one finding nothing to change) over
`hb_clusters:frames`, summed over the window's recorded calls
(core/program_trace.py). A block of one frame, as at 4,096 residues,
makes it the sweeps of each frame. None where no recorded call holds the
counters (a program without them)."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.calls(run) or ()
    frames = sum(c.counts.get("hb_clusters:frames", 0) for c in got)
    sweeps = sum(c.counts.get("hb_clusters:sweeps", 0) for c in got)
    return sweeps / frames if frames else None
