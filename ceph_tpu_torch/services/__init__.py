"""Services on RADOS, as far as the port has them.

Counterpart of ceph_tpu/services/__init__.py.  The port has the object
classes (``services.cls``: methods run inside the OSD's op interpreter,
reference src/cls + osd/ClassHandler.cc), which the OSD daemon hosts.  The
block images, the gateway, the manager and the rest of the reference's
services arrive with ROADMAP A12.
"""

from ceph_tpu_torch.services.cls import ClassRegistry, ClsError

__all__ = ["ClassRegistry", "ClsError"]
