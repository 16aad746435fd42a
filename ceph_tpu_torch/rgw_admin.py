"""radosgw-admin: the object-gateway admin CLI.

Counterpart of ceph_tpu/rgw_admin.py: the same module over the
port's imports.

The role of reference src/rgw/rgw_admin.cc reduced to the surfaces our
RGW-lite implements: user management + quotas, bucket listing/stats,
ACLs, lifecycle processing, zone placement targets (per-storage-class
data pools).

Usage:
    python -m ceph_tpu_torch.rgw_admin --conf cluster.json --pool rgw \
        user create --uid alice
    python -m ceph_tpu_torch.rgw_admin ... bucket stats --bucket site
    python -m ceph_tpu_torch.rgw_admin ... lc process
    python -m ceph_tpu_torch.rgw_admin ... zone placement add \
        --storage-class COLD --data-pool rgw.cold \
        --ec-profile rgw_cold --create-pool
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.services.rgw import RGWError, RGWLite, RGWUsers


async def _run(args) -> int:
    from ceph_tpu_torch.cli import _load_conf
    from ceph_tpu_torch.client.rados import Rados

    try:
        monmap, conf = _load_conf(args.conf)
    except (OSError, ValueError, KeyError) as e:
        print(f"radosgw-admin: bad conf {args.conf!r}: {e}",
              file=sys.stderr)
        return 1
    rados = Rados(monmap, conf, name="client.rgw-admin")
    try:
        await rados.connect(timeout=args.timeout)
        ioctx = await rados.open_ioctx(args.pool)
        users = RGWUsers(ioctx)
        gw = RGWLite(ioctx, users=users,   # admin/system context
                     datalog_shards=int(
                         rados.conf["rgw_datalog_shards"]))
        out = await _dispatch(args, gw, users)
        if out is not None:
            print(json.dumps(out, indent=2, default=str))
        return 0
    except (IOError, KeyError) as e:
        print(f"radosgw-admin: {e}", file=sys.stderr)
        return 1
    finally:
        await rados.shutdown()


async def _dispatch(args, gw: RGWLite, users: RGWUsers):
    if args.cmd == "user":
        if args.sub == "create":
            return await users.create(
                args.uid, args.display_name,
                max_size=args.max_size, max_objects=args.max_objects,
            )
        if args.sub == "ls":
            return await users.list()
        if args.sub == "info":
            return await users.get(args.uid)
        if args.sub == "rm":
            await users.remove(args.uid)
            return None
        if args.sub in ("suspend", "enable"):
            await users.set_suspended(args.uid,
                                      args.sub == "suspend")
            return None
    if args.cmd == "quota":
        await users.set_quota(args.uid, max_size=args.max_size,
                              max_objects=args.max_objects)
        return None
    if args.cmd == "bucket":
        if args.sub == "ls":
            return await gw.list_buckets()
        if args.sub == "stats":
            meta = await gw._bucket_meta(args.bucket)
            size, count = await gw._bucket_usage(args.bucket, meta)
            return {
                "bucket": args.bucket,
                "owner": meta.get("owner", ""),
                "size_bytes": size,
                "num_objects": count,
                "num_shards": int(meta.get("index_shards", 1)),
                "quota": meta.get("quota", {}),
            }
        if args.sub == "reshard":
            if args.abort:
                await gw.reshard_abort(args.bucket)
                return {"bucket": args.bucket, "aborted": True}
            return await gw.reshard_bucket(args.bucket,
                                           args.num_shards)
        if args.sub == "quota":
            await gw.set_bucket_quota(args.bucket,
                                      max_size=args.max_size,
                                      max_objects=args.max_objects)
            return None
        if args.sub == "acl":
            await gw.put_bucket_acl(args.bucket, args.canned)
            return None
    if args.cmd == "lc":
        if args.sub == "process":
            return await gw.lc_process()
        if args.sub == "get":
            return await gw.get_lifecycle(args.bucket)
    if args.cmd == "gc":
        if args.sub == "list":
            return await gw.gc_list()
        if args.sub == "process":
            return {"reaped": await gw.gc_process()}
    if args.cmd == "zone" and args.sub == "placement":
        # placement targets live in the zone's own pool — no realm
        # topology required (rgw_zone.h RGWZonePlacementInfo verbs)
        from ceph_tpu_torch.services.rgw_zone import ZonePlacement

        zp = ZonePlacement(gw.ioctx)
        if args.psub in ("add", "modify"):
            fn = zp.add if args.psub == "add" else zp.modify
            return await fn(
                args.placement_id,
                storage_class=args.storage_class,
                data_pool=args.data_pool,
                compression=args.compression,
                ec_profile=args.ec_profile,
                ec_k=args.ec_k, ec_m=args.ec_m,
                create_pool=args.create_pool, pg_num=args.pg_num)
        if args.psub == "rm":
            await zp.rm(args.placement_id,
                        args.storage_class or None)
            return {"removed": args.placement_id}
        if args.psub == "ls":
            return await zp.ls()
    if args.cmd == "sync" and args.sub == "status":
        # this zone's view of replication: per-shard source datalog
        # positions (what a peer must reach) + the persisted sync
        # markers of agents pulling INTO this zone (where they are)
        from ceph_tpu_torch.client.rados import RadosError
        from ceph_tpu_torch.services.rgw_sync import STATUS_OID

        try:
            kv = await gw.ioctx.get_omap(STATUS_OID)
        except RadosError as e:
            if e.rc != -2:
                raise
            kv = {}
        markers: dict[str, dict[int, int]] = {}
        for k, v in kv.items():
            if "\x00" in k:
                b, _, s = k.rpartition("\x00")
                markers.setdefault(b, {})[int(s)] = int(v)
            else:
                markers.setdefault(k, {}).setdefault(0, int(v))
        positions: dict[str, dict[str, int]] = {}
        for b in await gw.list_buckets():
            positions[b] = {
                str(s): int((await gw.log_list(
                    b, after=0, max_entries=1, shard=s))
                    .get("max_seq", 0))
                for s in range(gw.datalog_shards)}
        return {
            "datalog_shards": gw.datalog_shards,
            "source_positions": positions,
            "sync_markers": {
                b: {str(s): q for s, q in sorted(m.items())}
                for b, m in sorted(markers.items())},
        }
    if args.cmd in ("realm", "zonegroup", "zone", "period"):
        from ceph_tpu_torch.services.rgw_zone import RealmStore

        store = RealmStore(gw.ioctx)
        if args.cmd == "realm":
            if args.sub == "create":
                return await store.realm_create(args.rgw_realm)
            if args.sub == "list":
                return await store.realm_list()
            if args.sub == "get":
                return await store.realm_get(args.rgw_realm)
        if args.cmd == "zonegroup":
            if args.sub == "create":
                return await store.zonegroup_create(
                    args.rgw_realm, args.rgw_zonegroup,
                    master=args.master)
            if args.sub == "list":
                return await store.zonegroup_list(args.rgw_realm)
        if args.cmd == "zone":
            if args.sub == "create":
                return await store.zone_create(
                    args.rgw_realm, args.rgw_zonegroup,
                    args.rgw_zone, endpoint=args.endpoint,
                    master=args.master)
            if args.sub == "modify":
                return await store.zone_modify(
                    args.rgw_realm, args.rgw_zonegroup,
                    args.rgw_zone,
                    endpoint=args.endpoint or None,
                    master=args.master or None)
            if args.sub == "rm":
                await store.zone_rm(args.rgw_realm,
                                    args.rgw_zonegroup, args.rgw_zone)
                return {"removed": args.rgw_zone}
        if args.cmd == "period":
            if args.sub == "update":
                return await store.period_update(args.rgw_realm,
                                                 commit=args.commit)
            if args.sub == "get":
                return await store.period_get(
                    args.rgw_realm, args.period_id or None)
            if args.sub == "list":
                return await store.period_list(args.rgw_realm)
    raise RGWError("InvalidArgument", f"{args.cmd} {args.sub}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="radosgw-admin",
                                description=__doc__)
    p.add_argument("--conf", default="cluster.json")
    p.add_argument("--pool", default="rgw")
    p.add_argument("--timeout", type=float, default=15.0)
    sub = p.add_subparsers(dest="cmd", required=True)

    user = sub.add_parser("user")
    user_sub = user.add_subparsers(dest="sub", required=True)
    uc = user_sub.add_parser("create")
    uc.add_argument("--uid", required=True)
    uc.add_argument("--display-name", default="")
    uc.add_argument("--max-size", type=int, default=0)
    uc.add_argument("--max-objects", type=int, default=0)
    for sname in ("suspend", "enable"):
        sp_ = user_sub.add_parser(sname)
        sp_.add_argument("--uid", required=True)
    user_sub.add_parser("ls")
    for name in ("info", "rm"):
        x = user_sub.add_parser(name)
        x.add_argument("--uid", required=True)

    quota = sub.add_parser("quota")
    quota.add_argument("sub", choices=["set"])
    quota.add_argument("--uid", required=True)
    quota.add_argument("--max-size", type=int, default=0)
    quota.add_argument("--max-objects", type=int, default=0)

    bucket = sub.add_parser("bucket")
    bucket_sub = bucket.add_subparsers(dest="sub", required=True)
    bucket_sub.add_parser("ls")
    rs = bucket_sub.add_parser("reshard")
    rs.add_argument("--bucket", required=True)
    rs.add_argument("--num-shards", type=int, default=2)
    rs.add_argument("--abort", action="store_true")
    for name in ("stats", "quota", "acl"):
        x = bucket_sub.add_parser(name)
        x.add_argument("--bucket", required=True)
        if name == "quota":
            x.add_argument("--max-size", type=int, default=0)
            x.add_argument("--max-objects", type=int, default=0)
        if name == "acl":
            x.add_argument("--canned", default="private")

    lc = sub.add_parser("lc")
    lc_sub = lc.add_subparsers(dest="sub", required=True)
    lc_sub.add_parser("process")
    lg = lc_sub.add_parser("get")
    lg.add_argument("--bucket", required=True)

    gc = sub.add_parser("gc")
    gc_sub = gc.add_subparsers(dest="sub", required=True)
    gc_sub.add_parser("list")
    gc_sub.add_parser("process")

    # multisite config model (rgw_zone.h realm/zonegroup/zone/period)
    realm = sub.add_parser("realm")
    realm_sub = realm.add_subparsers(dest="sub", required=True)
    for name in ("create", "get"):
        x = realm_sub.add_parser(name)
        x.add_argument("--rgw-realm", required=True)
    realm_sub.add_parser("list")

    zg = sub.add_parser("zonegroup")
    zg_sub = zg.add_subparsers(dest="sub", required=True)
    zgc = zg_sub.add_parser("create")
    zgc.add_argument("--rgw-realm", required=True)
    zgc.add_argument("--rgw-zonegroup", required=True)
    zgc.add_argument("--master", action="store_true")
    zgl = zg_sub.add_parser("list")
    zgl.add_argument("--rgw-realm", required=True)

    zone = sub.add_parser("zone")
    zone_sub = zone.add_subparsers(dest="sub", required=True)
    for name in ("create", "modify", "rm"):
        x = zone_sub.add_parser(name)
        x.add_argument("--rgw-realm", required=True)
        x.add_argument("--rgw-zonegroup", required=True)
        x.add_argument("--rgw-zone", required=True)
        if name != "rm":
            x.add_argument("--endpoint", default="")
            x.add_argument("--master", action="store_true")
    # zone placement targets: per-storage-class data pools
    placement = zone_sub.add_parser("placement")
    pl_sub = placement.add_subparsers(dest="psub", required=True)
    for name in ("add", "modify"):
        x = pl_sub.add_parser(name)
        x.add_argument("--placement-id", default="default-placement")
        x.add_argument("--storage-class", default="STANDARD")
        x.add_argument("--data-pool", default="")
        x.add_argument("--compression", default="")
        x.add_argument("--ec-profile", default="")
        x.add_argument("--ec-k", type=int, default=2)
        x.add_argument("--ec-m", type=int, default=1)
        x.add_argument("--create-pool", action="store_true")
        x.add_argument("--pg-num", type=int, default=8)
    plrm = pl_sub.add_parser("rm")
    plrm.add_argument("--placement-id", default="default-placement")
    plrm.add_argument("--storage-class", default="")
    pl_sub.add_parser("ls")

    sync = sub.add_parser("sync")
    sync_sub = sync.add_subparsers(dest="sub", required=True)
    sync_sub.add_parser("status")

    period = sub.add_parser("period")
    period_sub = period.add_subparsers(dest="sub", required=True)
    pu = period_sub.add_parser("update")
    pu.add_argument("--rgw-realm", required=True)
    pu.add_argument("--commit", action="store_true")
    pg = period_sub.add_parser("get")
    pg.add_argument("--rgw-realm", required=True)
    pg.add_argument("--period-id", default="")
    pl = period_sub.add_parser("list")
    pl.add_argument("--rgw-realm", required=True)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
