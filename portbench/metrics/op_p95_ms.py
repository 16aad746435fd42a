"""95th percentile (nearest rank) of the same latencies as op_p50_ms."""

from portbench.stats import percentile


def read(run):
    lat = [(op[2] - op[1]) * 1e3 for op in run.window_ops()]
    return percentile(lat, 95)
