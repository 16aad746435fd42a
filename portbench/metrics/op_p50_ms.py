"""Median latency of every op issued inside the window, from its issue
to its reply (host clock; ops still in flight at the close are waited
for)."""

from portbench.stats import percentile


def read(run):
    lat = [(op[2] - op[1]) * 1e3 for op in run.window_ops()]
    return percentile(lat, 50)
