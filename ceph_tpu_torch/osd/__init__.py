"""OSD-side helpers of the port (counterpart of ceph_tpu.osd)."""
