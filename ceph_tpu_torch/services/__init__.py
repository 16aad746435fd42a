"""Services on RADOS, as far as the port has them.

Counterpart of ceph_tpu/services/__init__.py.  The port has:

- ``services.cls`` — the object classes: methods run inside the OSD's op
  interpreter (reference src/cls + osd/ClassHandler.cc), which the OSD
  daemon hosts;
- ``services.mgr`` — the manager: perf-counter aggregation into the PG
  digest, Prometheus text exposition, and its modules (``mgr_modules``,
  ``mgr_perf``, ``mgr_slo``, ``mgr_qos``, ``mgr_tsdb``, ``mgr_multisite``,
  ``orchestrator``) and HTTP ``dashboard`` (reference src/mgr +
  pybind/mgr).

Still to come (ROADMAP A12): the gateway (``rgw*``, which the dashboard's
zone-placement route and the multisite module reach), block images
(``rbd``, which ``mgr_perf``'s RBD support reaches) and the rest.
"""

from ceph_tpu_torch.services.cls import ClassRegistry, ClsError
from ceph_tpu_torch.services.mgr import Mgr

__all__ = ["ClassRegistry", "ClsError", "Mgr"]
