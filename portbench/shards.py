"""What the OSD daemons' stores hold: the shard streams of an object,
read straight from each daemon's ObjectStore (the program's output that
the reference judges)."""

from __future__ import annotations

NO_OSD = -1


def acting(cluster, pool_id: int, name: str) -> list[int]:
    """The acting set of the object's PG on the admin client's map."""
    from ceph_tpu_torch.osd.pg import object_to_ps

    m = cluster.rados.monc.osdmap
    ps = object_to_ps(name, m.pools[pool_id].pg_num)
    return list(m.pg_to_up_acting(pool_id, ps)[2])


def object_shards(cluster, pool_id: int, name: str) -> dict[int, bytes]:
    """Shard position -> the stored stream, for each position whose OSD
    is up and in the acting set; a position whose store lacks the
    object maps to None."""
    from ceph_tpu_torch.osd.pg import object_to_ps
    from ceph_tpu_torch.store.types import CollectionId, GHObject

    m = cluster.rados.monc.osdmap
    ps = object_to_ps(name, m.pools[pool_id].pg_num)
    out: dict[int, bytes | None] = {}
    for pos, osd_id in enumerate(m.pg_to_up_acting(pool_id, ps)[2]):
        osd = cluster.dev.osds.get(osd_id)
        if osd_id == NO_OSD or osd is None:
            continue
        try:
            out[pos] = osd.store.read(CollectionId(pool_id, ps, pos),
                                      GHObject(pool_id, name, shard=pos))
        except KeyError:
            out[pos] = None
    return out

