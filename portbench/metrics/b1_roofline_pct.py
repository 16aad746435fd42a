"""B1's share of its roofline over the window: the least time the EC
work of the cell's ops needs at the H100's 3.35 TB/s, over the device
time of every B1 launch (``gf2_words_kernel`` on its word view, from the
profiler's trace).

The bytes come from the ops, not from the port's counters (the traffic
module counts them per op): an encode reads the stripe-aligned object
and writes m/k of it as parity; a degraded read whose lost shard is a
data shard reads k surviving shards and writes the one rebuilt; other
reads need none."""

from portbench.peaks import HBM_BYTES_PER_S

KERNEL = "gf2_words_kernel"
VIEW = "WordIO"


def read(run):
    if run.devtrace is None:
        return None
    busy = sum(s for name, s in run.devtrace.seconds_by_name().items()
               if KERNEL in name and VIEW in name)
    need = sum(op[5] for op in run.done_ops() if op[4])
    if not busy or not need:
        return None
    return 100.0 * (need / HBM_BYTES_PER_S) / busy
