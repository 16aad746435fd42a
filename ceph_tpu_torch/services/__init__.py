"""Services on RADOS, as far as the port has them.

Counterpart of ceph_tpu/services/__init__.py.  The port has:

- ``services.cls`` — the object classes: methods run inside the OSD's op
  interpreter (reference src/cls + osd/ClassHandler.cc), which the OSD
  daemon hosts;
- ``services.mgr`` — the manager: perf-counter aggregation into the PG
  digest, Prometheus text exposition, and its modules (``mgr_modules``,
  ``mgr_perf``, ``mgr_slo``, ``mgr_qos``, ``mgr_tsdb``, ``mgr_multisite``,
  ``orchestrator``) and HTTP ``dashboard`` (reference src/mgr +
  pybind/mgr);
- ``services.rgw`` — the S3 gateway: bucket/object semantics with omap
  bucket indexes (reference src/rgw RGWRados), its bucket policies
  (``iam``), key management for server-side encryption (``kms``),
  notification push endpoints (``rgw_push``), zone placement with the
  storage classes lifecycle transitions move data across (``rgw_zone``)
  and the S3 REST front end with SigV4 (``rgw_http``).

Still to come (ROADMAP A12.2b-A12.4): multisite sync (``rgw_sync``, which
``rgw_zone.SyncOrchestrator`` reaches), Swift and the NFS-style file view
of the gateway, block images (``rbd``, which ``mgr_perf``'s RBD support
reaches) and the rest.
"""

from ceph_tpu_torch.services.cls import ClassRegistry, ClsError
from ceph_tpu_torch.services.mgr import Mgr
from ceph_tpu_torch.services.rgw import RGWLite

__all__ = ["ClassRegistry", "ClsError", "Mgr", "RGWLite"]
