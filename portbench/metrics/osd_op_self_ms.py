"""Mean self time of the primaries' ``osd:do_op`` spans less their
``osd:sub_op:*`` and ``osd:ec:launch`` children: the OSD daemon's own
host time per client op."""

from portbench.stats import mean, self_times_ms


def _child(name: str) -> bool:
    return name.startswith("osd:sub_op:") or name == "osd:ec:launch"


def read(run):
    return mean(self_times_ms(run.spans, {"osd:do_op"}, _child))
