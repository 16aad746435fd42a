"""Local object store of the port (counterpart of ceph_tpu.store).

Host-side durability tier: an ObjectStore-style transactional API
(reference src/os/ObjectStore.h + Transaction.h) with shard-qualified
object ids (ghobject_t), the MemStore backend (reference
src/os/memstore/MemStore.h:30) and the transaction wire codec; device
memory is a compute/cache tier (``DeviceShardCache``), not durability.
The WAL and file-backed stores are not ported yet.
"""

from ceph_tpu_torch.store.types import CollectionId, GHObject  # noqa: F401
from ceph_tpu_torch.store.object_store import ObjectStore, Transaction  # noqa: F401,E501
from ceph_tpu_torch.store.memstore import MemStore  # noqa: F401
from ceph_tpu_torch.store.txcodec import decode_tx, encode_tx  # noqa: F401
from ceph_tpu_torch.store.device_cache import DeviceShardCache  # noqa: F401
