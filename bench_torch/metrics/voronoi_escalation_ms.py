"""`voronoi_escalation_ms`: ms a call in the stages that the cell's file lists for it,
from the program's stage clock in the traced run (core/stages.py)."""

from bench_torch.core.stages import ms_per_call


def read(run):
    return ms_per_call(run, "voronoi_escalation_ms")
