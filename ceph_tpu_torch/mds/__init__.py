"""CephFS-lite: metadata service + POSIX-ish client (reference src/mds +
src/client, SURVEY.md §2.8).

Counterpart of ceph_tpu/mds/__init__.py: the same module over the
port's imports.
"""

from ceph_tpu_torch.mds.daemon import MDSDaemon  # noqa: F401
