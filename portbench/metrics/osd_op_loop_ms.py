"""Event-loop time an OSD primary spends on a client op: the mean
``loop_ms`` of the ``osd:do_op`` spans, the loop steps charged to the
span itself (its sub-op sends, store work, messages and launches carry
their own)."""

from portbench.looptrace import spans_with
from portbench.stats import mean


def read(run):
    return mean(s["loop_ms"] for s in spans_with(run, "loop_ms",
                                                  names={"osd:do_op"}))
