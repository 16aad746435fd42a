"""Local object store of the port (counterpart of ceph_tpu.store).

Host-side durability tier: an ObjectStore-style transactional API
(reference src/os/ObjectStore.h + Transaction.h) with shard-qualified
object ids (ghobject_t), the MemStore backend (reference
src/os/memstore/MemStore.h:30), the durable WalStore (write-ahead log +
checkpoint segments, the native WAL engine when it builds) and FileStore
(data on disk, a WAL for atomicity), and the transaction wire codec;
device memory is a compute/cache tier (``DeviceShardCache``), not
durability.
"""

from ceph_tpu_torch.store.types import CollectionId, GHObject  # noqa: F401
from ceph_tpu_torch.store.object_store import ObjectStore, Transaction  # noqa: F401,E501
from ceph_tpu_torch.store.memstore import MemStore  # noqa: F401
from ceph_tpu_torch.store.walstore import WalStore  # noqa: F401
from ceph_tpu_torch.store.filestore import FileStore  # noqa: F401
from ceph_tpu_torch.store.txcodec import decode_tx, encode_tx  # noqa: F401
from ceph_tpu_torch.store.device_cache import DeviceShardCache  # noqa: F401
