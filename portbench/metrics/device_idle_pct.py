"""Share of the profiled window in which no kernel, copy or set ran on
the card (torch.profiler's device events, their union against the
window's host-clock length)."""


def read(run):
    if run.devtrace is None or not run.devtrace.window_s:
        return None
    return 100.0 * (1.0 - run.devtrace.busy_s / run.devtrace.window_s)
