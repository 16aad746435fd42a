"""Services on RADOS.

Counterpart of ceph_tpu/services/__init__.py:

- ``services.cls`` — the object classes: methods run inside the OSD's op
  interpreter (reference src/cls + osd/ClassHandler.cc), which the OSD
  daemon hosts;
- ``services.mgr`` — the manager: perf-counter aggregation into the PG
  digest, Prometheus text exposition, and its modules (``mgr_modules``,
  ``mgr_perf``, ``mgr_slo``, ``mgr_qos``, ``mgr_tsdb``, ``mgr_multisite``,
  ``orchestrator``) and HTTP ``dashboard`` (reference src/mgr +
  pybind/mgr);
- ``services.rbd`` — block images striped over data objects with v2-style
  id/header metadata (reference src/librbd), their journal
  (``rbd_journal``), consistency groups and namespaces (``rbd_group``),
  cross-cluster mirroring (``rbd_mirror``) and the persistent write-back
  log (``rbd_pwl``);
- ``services.rgw`` — the S3 gateway: bucket/object semantics with omap
  bucket indexes (reference src/rgw RGWRados), its bucket policies
  (``iam``), key management for server-side encryption (``kms``),
  notification push endpoints (``rgw_push``), zone placement with the
  storage classes lifecycle transitions move data across (``rgw_zone``),
  the S3 REST front end with SigV4 (``rgw_http``), multisite sync
  (``rgw_sync``), the Swift front end (``swift``) and the NFS-style file
  view of buckets (``rgw_file``);
- ``services.volumes`` — CephFS subvolumes and subvolume groups (reference
  src/pybind/mgr/volumes), which the CLI's ``fs subvolume`` commands
  reach.
"""

from ceph_tpu_torch.services.cls import ClassRegistry, ClsError
from ceph_tpu_torch.services.mgr import Mgr
from ceph_tpu_torch.services.rbd import RBD, Image
from ceph_tpu_torch.services.rbd_group import RBDGroups
from ceph_tpu_torch.services.rgw import RGWLite

__all__ = ["RBD", "RBDGroups", "ClassRegistry", "ClsError", "Image",
           "Mgr", "RGWLite"]
