"""ceph-objectstore-tool: offline object-store inspection.

Counterpart of ceph_tpu/objectstore_tool.py: the same module over the
port's imports.

The role of reference src/tools/ceph_objectstore_tool.cc: operate
directly on a stopped OSD's store directory — list collections and
objects, dump one object's data/attrs/omap, export/import an object —
without any cluster running.  Works on a WalStore directory (checkpoint
+ WAL replay happens at mount, exactly as the OSD would).

Usage:
    python -m ceph_tpu_torch.objectstore_tool --data-path run/osd.0 \
        --op list
    python -m ceph_tpu_torch.objectstore_tool --data-path run/osd.0 \
        --op dump --pool 1 --ps 3 --name obj-7
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import sys

from ceph_tpu_torch.store.types import NO_GEN, NO_SHARD, CollectionId, GHObject
from ceph_tpu_torch.store.walstore import WalStore


# collection keys use CollectionId.__str__ (hex pg, the store's own
# naming) so listings cross-reference the on-disk collection names;
# --ps is therefore parsed as hex

# The OSD's meta collection (mirrors OSDDaemon._SUPER_CID/_SUPER_OID/
# _MAPS_OID — asserted identical by tests): superblock omap plus the
# bounded OSDMap-epoch history monstore_tool harvests for rebuild.
META_CID = CollectionId(-1, 0)
SUPERBLOCK_OID = GHObject(-1, "_osd_superblock")
MAPS_OID = GHObject(-1, "_osd_maps")


def open_store(data_path: str):
    """Offline store for a stopped OSD's directory: sniff the on-disk
    layout — ``colls/`` marks a FileStore, anything else mounts as a
    WalStore (checkpoint + WAL replay, exactly as the OSD would)."""
    import os

    if os.path.isdir(os.path.join(data_path, "colls")):
        from ceph_tpu_torch.store.filestore import FileStore

        return FileStore(data_path)
    return WalStore(data_path)


async def harvest_meta(data_path: str) -> dict:
    """Read one stopped OSD's DR-harvest material (the update-mon-db
    source): every persisted full OSDMap epoch, the superblock's
    pool->pg_num view, and the last rotating-service-secret snapshot.
    Returns {"epochs": {epoch: map_dict}, "pool_pg_num": {...},
    "service_secrets": {epoch: secret}}."""
    from ceph_tpu_torch.msg.codec import decode

    store = open_store(data_path)
    await store.mount()
    try:
        out = {"epochs": {}, "pool_pg_num": {}, "service_secrets": {}}
        try:
            omap = store.omap_get(META_CID, MAPS_OID)
        except KeyError:
            omap = {}
        for k, v in omap.items():
            if k.startswith("full_"):
                out["epochs"][int(k[len("full_"):])] = decode(v)
            elif k == "service_secrets":
                out["service_secrets"] = {
                    int(e): str(s)
                    for e, s in json.loads(v).items()
                }
        try:
            sb = store.omap_get(META_CID, SUPERBLOCK_OID)
        except KeyError:
            sb = {}
        out["pool_pg_num"] = {int(k): int(v) for k, v in sb.items()}
        return out
    finally:
        await store.umount()


def _oid_json(oid: GHObject) -> dict:
    out = {"name": oid.name}
    if oid.snap != -2:
        out["snap"] = oid.snap
    if oid.gen != NO_GEN:
        out["gen"] = oid.gen
    if oid.shard != NO_SHARD:
        out["shard"] = oid.shard
    return out


async def _run(args) -> int:
    if args.op == "meta":
        meta = await harvest_meta(args.data_path)
        print(json.dumps({
            "data_path": args.data_path,
            "osdmap_epochs": sorted(meta["epochs"]),
            "newest_epoch": max(meta["epochs"], default=0),
            "pool_pg_num": meta["pool_pg_num"],
            "service_secret_epochs": sorted(meta["service_secrets"]),
        }, indent=2))
        return 0
    store = open_store(args.data_path)
    await store.mount()
    try:
        if args.op == "list":
            out = {}
            for cid in sorted(store.list_collections(),
                              key=lambda c: (c.pool, c.pg, c.shard)):
                out[str(cid)] = [
                    _oid_json(o) for o in store.list_objects(cid)
                ]
            print(json.dumps(out, indent=2))
            return 0
        if args.op in ("dump", "export"):
            cid = CollectionId(args.pool, args.ps, args.shard)
            oid = GHObject(args.pool, args.name, snap=args.snap,
                           shard=args.shard)
            data = store.read(cid, oid)
            if args.op == "export":
                sys.stdout.buffer.write(data)
                return 0
            print(json.dumps({
                "object": _oid_json(oid),
                "size": len(data),
                "data_b64": base64.b64encode(data).decode(),
                "attrs": {
                    k: base64.b64encode(v).decode()
                    for k, v in store.getattrs(cid, oid).items()
                },
                "omap": {
                    k: base64.b64encode(v).decode()
                    for k, v in store.omap_get(cid, oid).items()
                },
            }, indent=2))
            return 0
        if args.op == "info":
            colls = store.list_collections()
            n_objs = sum(len(store.list_objects(c)) for c in colls)
            print(json.dumps({
                "data_path": args.data_path,
                "backend": "native" if store.native else "python",
                "collections": len(colls),
                "objects": n_objs,
            }, indent=2))
            return 0
        print(f"unknown --op {args.op!r}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"objectstore-tool: not found: {e}", file=sys.stderr)
        return 1
    finally:
        await store.umount()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-objectstore-tool",
                                description=__doc__)
    p.add_argument("--data-path", required=True,
                   help="a WalStore directory (osd store_dir)")
    p.add_argument("--op", required=True,
                   choices=["list", "dump", "export", "info", "meta"])
    p.add_argument("--pool", type=int, default=0)
    p.add_argument("--ps", type=lambda s: int(s, 16),
               default=0, help="pg id (hex, as listed)")
    p.add_argument("--shard", type=int, default=NO_SHARD)
    p.add_argument("--snap", type=int, default=-2)
    p.add_argument("--name", default="")
    args = p.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
