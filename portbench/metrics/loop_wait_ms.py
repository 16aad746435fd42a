"""How long runnable work waits for the event loop: the mean lag of the
loop monitor's probe (a ``call_soon`` every 10 ms, timed from its
scheduling to its run) over the window."""

from portbench.looptrace import window_buckets


def read(run):
    buckets = window_buckets(run)
    if buckets is None:
        return None
    lag = sum(b[4] for b, _ in buckets)
    probes = sum(b[5] for b, _ in buckets)
    if not probes:
        return None
    return lag / probes / 1e6
