"""Event-loop time of the messengers per client op: the loop monitor's
busy time in the window under ``msgr:send`` (encode, frame CRC, socket
write), ``msgr:recv`` (frame read, CRC, decode) and ``msgr:dispatch``,
over the ops issued and completed in it."""

from portbench.looptrace import window_labels

LABELS = ("msgr:send", "msgr:recv", "msgr:dispatch")


def read(run):
    by = window_labels(run)
    ops = len(run.done_ops())
    if not by or not ops:
        return None
    return sum(by.get(k, 0.0) for k in LABELS) / 1e6 / ops
