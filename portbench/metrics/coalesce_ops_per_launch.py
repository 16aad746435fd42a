"""Ops per device launch of the EC backends' coalescers over the window:
the daemons' summed ``ec_coalesce_ops`` over ``ec_coalesce_launches``."""


def read(run):
    launches = run.counters.get("ec_coalesce_launches", 0.0)
    if not launches:
        return None
    return run.counters.get("ec_coalesce_ops", 0.0) / launches
