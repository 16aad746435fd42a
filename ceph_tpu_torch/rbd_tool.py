"""rbd: the block-image admin CLI.

Counterpart of ceph_tpu/rbd_tool.py: the same module over the
port's imports.

The role of reference src/tools/rbd (rbd create/ls/info/snap/clone/...):
a thin command surface over services.rbd against a cluster conf file
(DevCluster.write_conf), plus import/export to local files.

Usage:
    python -m ceph_tpu_torch.rbd_tool --conf cluster.json --pool rbd \
        create img1 --size 8388608
    python -m ceph_tpu_torch.rbd_tool ... snap create img1@s1
    python -m ceph_tpu_torch.rbd_tool ... clone img1@s1 img2
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.services.rbd import RBD, RBDError


def _image_spec(spec: str) -> tuple[str, str | None]:
    name, _, snap = spec.partition("@")
    return name, (snap or None)


async def _run(args) -> int:
    from ceph_tpu_torch.cli import _load_conf
    from ceph_tpu_torch.client.rados import Rados

    try:
        monmap, conf = _load_conf(args.conf)
    except (OSError, ValueError, KeyError) as e:
        print(f"rbd: bad conf {args.conf!r}: {e}",
              file=sys.stderr)
        return 1
    rados = Rados(monmap, conf, name="client.rbd-tool")
    try:
        await rados.connect(timeout=args.timeout)
        ioctx = await rados.open_ioctx(args.pool)
        if getattr(args, "namespace", ""):
            ioctx.set_namespace(args.namespace)
        rbd = RBD(ioctx)
        out = await _dispatch(args, rbd)
        if out is not None:
            print(json.dumps(out, indent=2, default=str))
        return 0
    except (IOError, KeyError) as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1
    finally:
        await rados.shutdown()


async def _dispatch(args, rbd: RBD):
    cmd = args.cmd
    if cmd == "group":
        from ceph_tpu_torch.services.rbd_group import RBDGroups

        groups = RBDGroups(rbd)
        g = args.group_args
        gc = args.group_cmd
        if gc == "create":
            return {"id": await groups.create(g[0])}
        if gc == "ls":
            return await groups.list()
        if gc == "rm":
            await groups.remove(g[0])
            return None
        if gc == "rename":
            await groups.rename(g[0], g[1])
            return None
        if gc == "image-add":
            await groups.image_add(g[0], g[1])
            return None
        if gc == "image-rm":
            await groups.image_remove(g[0], g[1])
            return None
        if gc == "image-ls":
            return await groups.image_list(g[0])
        if gc == "snap-create":
            return {"id": await groups.snap_create(g[0], g[1])}
        if gc == "snap-ls":
            return await groups.snap_list(g[0])
        if gc == "snap-rm":
            await groups.snap_remove(g[0], g[1])
            return None
        if gc == "snap-rollback":
            await groups.snap_rollback(g[0], g[1])
            return None
    if cmd == "namespace":
        if args.ns_cmd == "create":
            await rbd.namespace_create(args.ns_name)
            return None
        if args.ns_cmd == "ls":
            return await rbd.namespace_list()
        if args.ns_cmd == "rm":
            await rbd.namespace_remove(args.ns_name)
            return None
    if cmd == "create":
        await rbd.create(args.image, args.size, order=args.order,
                         object_map=not args.no_object_map)
        return None
    if cmd == "ls":
        return await rbd.list()
    if cmd == "info":
        img = await rbd.open(args.image)
        info = img.stat()
        info["snaps"] = img.snap_list()
        if img.parent is not None:
            info["parent"] = img.parent
        return info
    if cmd == "rm":
        await rbd.remove(args.image)
        return None
    if cmd == "resize":
        img = await rbd.open(args.image)
        await img.resize(args.size)
        return None
    if cmd == "children":
        name, snap = _image_spec(args.snap_spec)
        if snap is None:
            raise RBDError("children wants image@snap")
        return await rbd.children(name, snap)
    if cmd == "clone":
        name, snap = _image_spec(args.snap_spec)
        if snap is None:
            raise RBDError("clone wants parent image@snap")
        child = args.child
        dest = None
        if "/" in child:            # cross-pool: pool/child syntax
            dpool, child = child.split("/", 1)
            dest = RBD(await rbd.ioctx.rados.open_ioctx(dpool))
        await rbd.clone(name, snap, child, dest=dest)
        return None
    if cmd == "flatten":
        img = await rbd.open(args.image)
        await img.flatten()
        return None
    if cmd == "object-map":
        img = await rbd.open(args.image)
        await img.object_map_rebuild()
        return None
    if cmd == "export":
        img = await rbd.open(args.image)
        data = await img.read(0, img.size)
        with open(args.path, "wb") as f:
            f.write(data)
        return {"exported": len(data)}
    if cmd == "import":
        with open(args.path, "rb") as f:
            data = f.read()
        await rbd.create(args.image, len(data), order=args.order)
        img = await rbd.open(args.image)
        await img.write(0, data)
        return {"imported": len(data)}
    if cmd == "snap":
        name, snap = _image_spec(args.snap_spec)
        img = await rbd.open(name)
        if args.snap_cmd == "ls":
            return img.snap_list()
        if snap is None:
            raise RBDError(f"snap {args.snap_cmd} wants image@snap")
        if args.snap_cmd == "create":
            await img.snap_create(snap)
        elif args.snap_cmd == "rm":
            await img.snap_remove(snap)
        elif args.snap_cmd == "protect":
            await img.snap_protect(snap)
        elif args.snap_cmd == "unprotect":
            await img.snap_unprotect(snap)
        elif args.snap_cmd == "rollback":
            await img.snap_rollback(snap)
        return None
    if cmd in ("deep-cp", "migrate"):
        dst = args.dst
        dest = None
        if "/" in dst:              # cross-pool: pool/name syntax
            dpool, dst = dst.split("/", 1)
            dest = RBD(await rbd.ioctx.rados.open_ioctx(dpool))
        if cmd == "deep-cp":
            await rbd.deep_copy(args.src, dst, dest=dest)
        else:
            await rbd.migrate(args.src, dst, dest=dest)
        return None
    if cmd == "image-meta":
        img = await rbd.open(args.image)
        if args.meta_cmd == "set":
            await img.meta_set(args.key, args.value)
            return None
        if args.meta_cmd == "get":
            return await img.meta_get(args.key)
        if args.meta_cmd == "ls":
            return await img.meta_list()
        if args.meta_cmd == "rm":
            await img.meta_remove(args.key)
            return None
    if cmd == "bench":
        img = await rbd.open(args.image)
        import secrets as _secrets
        import time as _time

        if args.io_size <= 0 or args.io_size > img.size:
            raise RBDError("--io-size must be in [1, image size]")
        payload = b"\xa5" * args.io_size
        rng = _secrets.SystemRandom()
        nops = args.io_total // args.io_size
        lat = []
        t0 = _time.perf_counter()
        for _ in range(nops):
            off = rng.randrange(
                max(1, img.size - args.io_size)
            ) // 512 * 512
            t1 = _time.perf_counter()
            if args.io_type == "write":
                await img.write(off, payload)
            else:
                await img.read(off, args.io_size)
            lat.append(_time.perf_counter() - t1)
        elapsed = _time.perf_counter() - t0
        await img.close()
        lat.sort()
        return {
            "ops": nops, "seconds": round(elapsed, 3),
            "iops": round(nops / elapsed, 1),
            "MiB_per_s": round(nops * args.io_size / elapsed
                               / (1 << 20), 2),
            "lat_p50_ms": round(lat[len(lat) // 2] * 1e3, 3)
            if lat else 0.0,
            "lat_p99_ms": round(lat[int(len(lat) * 0.99)] * 1e3, 3)
            if lat else 0.0,
        }
    if cmd == "trash":
        if args.trash_cmd == "mv":
            return {"id": await rbd.trash_move(args.image,
                                               delay=args.delay)}
        if args.trash_cmd == "ls":
            return await rbd.trash_list()
        if args.trash_cmd == "restore":
            return {"name": await rbd.trash_restore(
                args.image_id, args.name or None)}
        if args.trash_cmd == "rm":
            await rbd.trash_remove(args.image_id, force=args.force)
            return None
    if cmd == "lock":
        img = await rbd.open(args.image)
        if args.lock_cmd == "ls":
            info = await img.lock_info()
            return [{"locker": lk, **v}
                    for lk, v in sorted(info.get("lockers",
                                                 {}).items())]
        if args.lock_cmd == "break":
            await img.break_lock(args.locker,
                                 blocklist=args.blocklist)
            return None
    raise RBDError(f"unknown command {cmd!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rbd", description=__doc__)
    p.add_argument("--conf", default="cluster.json")
    p.add_argument("--pool", default="rbd")
    p.add_argument("--namespace", default="",
                   help="rados namespace scoping every image op")
    p.add_argument("--timeout", type=float, default=15.0)
    sub = p.add_subparsers(dest="cmd", required=True)

    grp = sub.add_parser("group")
    grp.add_argument("group_cmd", choices=[
        "create", "ls", "rm", "rename", "image-add", "image-rm",
        "image-ls", "snap-create", "snap-ls", "snap-rm",
        "snap-rollback",
    ])
    grp.add_argument("group_args", nargs="*",
                     help="group [image|snap|new-name]")

    ns = sub.add_parser("namespace")
    ns.add_argument("ns_cmd", choices=["create", "ls", "rm"])
    ns.add_argument("ns_name", nargs="?", default="")

    c = sub.add_parser("create")
    c.add_argument("image")
    c.add_argument("--size", type=int, required=True)
    c.add_argument("--order", type=int, default=22)
    c.add_argument("--no-object-map", action="store_true")
    sub.add_parser("ls")
    for name in ("info", "rm", "flatten"):
        x = sub.add_parser(name)
        x.add_argument("image")
    r = sub.add_parser("resize")
    r.add_argument("image")
    r.add_argument("--size", type=int, required=True)
    om = sub.add_parser("object-map")
    om.add_argument("om_cmd", choices=["rebuild"])
    om.add_argument("image")
    ch = sub.add_parser("children")
    ch.add_argument("snap_spec", help="image@snap")
    cl = sub.add_parser("clone")
    cl.add_argument("snap_spec", help="parent image@snap")
    cl.add_argument("child")
    for name in ("export", "import"):
        x = sub.add_parser(name)
        x.add_argument("image")
        x.add_argument("path")
        if name == "import":
            x.add_argument("--order", type=int, default=22)
    for name in ("deep-cp", "migrate"):
        x = sub.add_parser(name)
        x.add_argument("src")
        x.add_argument("dst")
    im = sub.add_parser("image-meta")
    im_sub = im.add_subparsers(dest="meta_cmd", required=True)
    for name in ("set", "get", "rm", "ls"):
        x = im_sub.add_parser(name)
        x.add_argument("image")
        if name != "ls":
            x.add_argument("key")
        if name == "set":
            x.add_argument("value")
    bn = sub.add_parser("bench")
    bn.add_argument("image")
    bn.add_argument("--io-type", choices=["write", "read"],
                    default="write")
    bn.add_argument("--io-size", type=int, default=4096)
    bn.add_argument("--io-total", type=int, default=4 << 20)
    tr = sub.add_parser("trash")
    tr_sub = tr.add_subparsers(dest="trash_cmd", required=True)
    trm = tr_sub.add_parser("mv")
    trm.add_argument("image")
    trm.add_argument("--delay", type=float, default=0.0)
    tr_sub.add_parser("ls")
    trr = tr_sub.add_parser("restore")
    trr.add_argument("image_id")
    trr.add_argument("--name", default="")
    trx = tr_sub.add_parser("rm")
    trx.add_argument("image_id")
    trx.add_argument("--force", action="store_true")
    lk = sub.add_parser("lock")
    lk_sub = lk.add_subparsers(dest="lock_cmd", required=True)
    lkl = lk_sub.add_parser("ls")
    lkl.add_argument("image")
    lkb = lk_sub.add_parser("break")
    lkb.add_argument("image")
    lkb.add_argument("locker")
    lkb.add_argument("--blocklist", action="store_true",
                     help="fence the owner's client instance at the "
                          "OSDs before breaking (reference default)")
    sn = sub.add_parser("snap")
    sn.add_argument("snap_cmd", choices=[
        "create", "ls", "rm", "protect", "unprotect", "rollback",
    ])
    sn.add_argument("snap_spec", help="image[@snap]")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
