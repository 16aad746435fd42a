"""Client stack: Objecter + librados-shaped API + striper.

Counterpart of ceph_tpu/client/__init__.py: the same module over the
port's imports.

The reference's client layers (src/osdc/Objecter.{h,cc} op engine;
src/librados C/C++ API; src/libradosstriper) as asyncio-native Python:
clients compute placement themselves from the osdmap (CRUSH is
client-side — no metadata server in the data path), submit ops to the
primary OSD, resend on map change, and keep watch registrations alive
across intervals.
"""

from ceph_tpu_torch.client.objecter import Objecter
from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, Rados
from ceph_tpu_torch.client.striper import RadosStriper

__all__ = ["IoCtx", "ObjectOperation", "Objecter", "Rados", "RadosStriper"]
