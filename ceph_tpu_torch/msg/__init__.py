"""Messenger helpers of the port (counterpart of ceph_tpu.msg).

Ported so far: the wire codec (``codec``), which the PG log encodes its
entries with.  The messenger itself (connections, dispatchers, the
control plane) is not ported yet.
"""
