"""Shared helpers of the port (counterpart of ceph_tpu.common)."""
