"""`host_prep_ms.host_bound`: `host_prep_ms` (read by its reader) in the cells whose frame
rate is a per-layer metric (`frames_per_s.host_bound`), where the cell's
end-to-end metric besides `setup_s` is `memory_peak_mib`."""

from bench_torch.core import spec


def read(run):
    return spec.metric_reader("host_prep_ms").read(run)
