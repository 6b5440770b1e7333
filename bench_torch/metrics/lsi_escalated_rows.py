"""`lsi_escalated_rows`: (frame, row) pairs a call that the split LSI tier's
escalation redid: the program's counter `lsi:escalation:rows`, which every
split-tier call adds to (0 where no row overfills the split kernel's 12
in-shell slots), summed over the window's recorded calls and divided by
their number (core/program_trace.py). None where no recorded call holds
the counter."""

from bench_torch.core import program_trace


def read(run):
    got = program_trace.calls(run) or ()
    seen = [c.counts["lsi:escalation:rows"] for c in got if "lsi:escalation:rows" in c.counts]
    return sum(seen) / len(got) if seen else None
