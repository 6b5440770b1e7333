"""`lsi_escalation_ms`: ms a call of device time in the split LSI tier's
escalation: the `lsi:escalation` spans (CUDA events around the redo of the
rows that overfill the split kernel's 12 in-shell slots), summed over the
window's recorded calls and divided by their number (a call with no
escalation adds 0; core/program_trace.py). None where the program records
no such span."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.spans(run, "lsi:escalation")
    ms = [s.device_ms for _, s in got or () if s.device_ms is not None]
    return sum(ms) / len(program_trace.calls(run)) if ms else None
