"""Event-loop time of the object stores per client op: the loop
monitor's busy time in the window under ``store:commit`` and
``store:read``, over the ops issued and completed in it."""

from portbench.looptrace import window_labels


def read(run):
    by = window_labels(run)
    ops = len(run.done_ops())
    if not by or not ops:
        return None
    return sum(v for k, v in by.items() if k.startswith("store:")) \
        / 1e6 / ops
