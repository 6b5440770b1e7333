"""`memory_peak_mib`: the card's peak of allocated memory over set-up's
warm-up call and the window, in MiB, read from the device allocator once the
window has closed (`torch.cuda.max_memory_allocated`); nothing on the CPU.

End to end in the cells whose frame rate follows the host's speed too
closely to hold a bound (`frames_per_s.host_bound`): what the analysis
takes of the card does not, since each run does the same work."""


def read(run):
    peak = getattr(run, "memory_peak_bytes", None)
    return peak / 2**20 if peak else None
