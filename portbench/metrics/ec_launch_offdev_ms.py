"""Host time of an EC device launch that the card does not account for:
the mean, over the window's coalesced launches, of an ``osd:ec:launch``
span's host duration less the part of it that its device interval
(``dev_t_ns``, ``dev_ms``: CUDA events around the launch's device work,
on the stream every daemon shares, so other daemons' copies queued
between them count too) covers.  A launch whose result stays on the card returns before its
device work ends; only the overlap counts.  A launch serving several
sampled ops is recorded once per op with the same start; it counts
once."""

from portbench.looptrace import spans_with
from portbench.stats import mean


def read(run):
    launches = {}
    for s in spans_with(run, "dev_ms", names={"osd:ec:launch"}):
        launches[(s["entity"], s["t_ns"])] = s
    return mean(s["duration_ms"] - _overlap_ms(s)
                for s in launches.values())


def _overlap_ms(s) -> float:
    host_end = s["t_ns"] + s["duration_ms"] * 1e6
    dev_end = s["dev_t_ns"] + s["dev_ms"] * 1e6
    return max(0.0, min(host_end, dev_end) - max(s["t_ns"], s["dev_t_ns"])) \
        / 1e6
