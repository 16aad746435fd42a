"""Share of the window in which the host's one event loop ran a step:
the loop monitor's busy time in the window's 10 ms buckets (the edge
buckets in proportion) over the window's length."""

from portbench.looptrace import window_buckets


def read(run):
    buckets = window_buckets(run)
    if buckets is None:
        return None
    busy = sum(b[1] * share for b, share in buckets)
    return 100.0 * busy / (run.window_s * 1e9)
