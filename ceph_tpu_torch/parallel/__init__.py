"""Repair planes of the port (counterpart of ceph_tpu.parallel).

Ported so far: the single-device host functions of ``clay_sharding`` and
``lrc_sharding``.  The mesh functions (``sharded_clay_repair``,
``sharded_lrc_repair``) wait for the port's multi-device planes
(ROADMAP A10).
"""
