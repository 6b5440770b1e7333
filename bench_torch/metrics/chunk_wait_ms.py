"""`chunk_wait_ms`: ms a call in the stages that the cell's file lists for
it, from the program's stage clock in the traced run (core/stages.py).

A driver that streams a trajectory file in chunks (`chunk_frames`) ends
its `host gather` stage once a chunk has come off the prefetch queue and
its center bounds are taken; the stage starts at the previous chunk's
D2H, or at the call's start for the first chunk. So it holds the wait for
each chunk's decode that the prefetch did not hide, and the first chunk's
whole decode with the file's opening."""

from bench_torch.core.stages import ms_per_call


def read(run):
    return ms_per_call(run, "chunk_wait_ms")
