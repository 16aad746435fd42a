"""Bytes the resident shard caches copied host to device over the
window (the daemons' summed ``ec_resident_h2d_bytes``) per client
payload byte."""


def read(run):
    nbytes = run.client_bytes()
    if not nbytes or "ec_resident_h2d_bytes" not in run.counters:
        return None
    return run.counters["ec_resident_h2d_bytes"] / nbytes
