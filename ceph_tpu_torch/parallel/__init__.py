"""Multi-device parallelism of the port: the interconnect data plane.

Counterpart of ceph_tpu.parallel over the port's mesh (``parallel.mesh``):
EC stripe batches shard over a mesh of slots ('dp' axis = declustered
stripe parallelism), encoded chunks fan out across the 'cs' axis (chunk
sharding — the MOSDECSubOpWrite fan-out of reference
osd/ECBackend.cc:2090-2106 becomes an all_to_all between slots), and
repair reads ride all_gather (BASELINE.md config #5 LRC shard-group
repair).
"""

from ceph_tpu_torch.parallel.clay_sharding import (  # noqa: F401
    sharded_clay_repair,
    sharded_clay_repair_check,
)
from ceph_tpu_torch.parallel.ec_sharding import (  # noqa: F401
    distributed_ec_step,
    make_ec_mesh,
    sharded_encode,
)
from ceph_tpu_torch.parallel.lrc_sharding import (  # noqa: F401
    make_group_mesh,
    sharded_lrc_repair,
    sharded_lrc_repair_check,
)
