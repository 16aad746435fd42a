"""cephfs-data-scan: rebuild CephFS metadata from the data pool.

Counterpart of ceph_tpu/cephfs_data_scan.py: the same module over the
port's imports.

Reference src/tools/cephfs/DataScan.cc (cephfs-data-scan
scan_extents / scan_inodes / scan_links): when the metadata pool is
damaged or lost, every file's data objects plus the backtrace each
file carries in the data pool are enough to reconstruct dentries.

-lite shapes: data blocks are ``<ino:x>.<block:08x>`` (mds/daemon.py
block_oid) and every file create/rename writes a ``<ino:x>.bt``
sidecar whose ``backtrace`` xattr encodes {parent, name}
(mds/daemon.py:_write_backtrace — the reference's object-0 backtrace
xattr).  Scan phases:

- ``scan`` (scan_extents + scan_inodes): group data objects by ino,
  recover size from the highest block + its length, read backtraces.
- ``inject``: re-create missing dentries in the metadata pool at
  their backtraced location when the parent dirfrag exists; anything
  unplaceable (no backtrace, dead parent, name taken by another ino)
  goes under ``lost+found`` in the root dirfrag, like the reference.

Run offline (MDS stopped), then restart the MDS.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys
import time

from ceph_tpu_torch.client.rados import ObjectOperation, Rados, RadosError
from ceph_tpu_torch.mds.daemon import ROOT_INO, backtrace_oid, dirfrag_oid
from ceph_tpu_torch.msg.codec import decode, encode

ENOENT = -2
_BLOCK_RE = re.compile(r"^([0-9a-f]+)\.([0-9a-f]{8})$")
_BT_RE = re.compile(r"^([0-9a-f]+)\.bt$")
LOST_FOUND = "lost+found"


async def scan_pool(data, block_size: int) -> dict[int, dict]:
    """Phase 1: every recoverable ino -> {size, blocks, parent,
    name}.  Size is exact for our write pattern (the tail block's
    real length); backtrace absence leaves parent/name None."""
    inos: dict[int, dict] = {}
    tails: dict[int, int] = {}         # ino -> highest block seen
    for oid in await data.list_objects():
        m = _BLOCK_RE.match(oid)
        if m:
            ino, block = int(m.group(1), 16), int(m.group(2), 16)
            rec = inos.setdefault(ino, {"blocks": 0, "size": 0,
                                        "parent": None, "name": None,
                                        "type": "file"})
            rec["blocks"] += 1
            tails[ino] = max(tails.get(ino, -1), block)
            continue
        m = _BT_RE.match(oid)
        if m:
            ino = int(m.group(1), 16)
            rec = inos.setdefault(ino, {"blocks": 0, "size": 0,
                                        "parent": None, "name": None,
                                        "type": "file"})
            try:
                bt = decode(await data.get_xattr(oid, "backtrace"))
                # parse FULLY before assigning: a truncated record
                # must not leave a half-filled backtrace (parent set,
                # name None) for inject to trip over
                parent, name = int(bt["parent"]), str(bt["name"])
                btype = str(bt.get("type", "file"))
                target = str(bt.get("target", "")) \
                    if btype == "symlink" else None
            except (RadosError, KeyError, ValueError, TypeError):
                continue      # scan is best-effort; inject handles it
            rec["parent"], rec["name"] = parent, name
            rec["type"] = btype
            if target is not None:
                rec["target"] = target
    # one stat per ino (the tail block alone fixes the size), not
    # one per object: recovery cost scales with files, not blocks
    for ino, top in tails.items():
        from ceph_tpu_torch.mds.daemon import block_oid
        tail = int((await data.stat(block_oid(ino, top)))
                   .get("size", 0))
        inos[ino]["size"] = top * block_size + tail
    return inos


async def _dirfrag_alive(meta, dino: int) -> bool:
    try:
        # stat, not get_omap: liveness must not pull a large
        # directory's full dentry listing per probe
        await meta.stat(dirfrag_oid(dino))
        return True
    except RadosError as e:
        if e.rc != ENOENT:
            raise
        # the root dirfrag is created lazily on its first dentry
        return dino == ROOT_INO


async def _dentry_for(meta, dino: int, name: str) -> dict | None:
    from ceph_tpu_torch.mds.daemon import frag_oid_for_name

    try:
        kv = await meta.get_omap(
            await frag_oid_for_name(meta, dino, name), [name])
    except RadosError as e:
        if e.rc != ENOENT:
            raise
        return None
    return decode(kv[name]) if name in kv else None


async def _link(meta, dino: int, name: str, dentry: dict) -> None:
    from ceph_tpu_torch.mds.daemon import frag_oid_for_name

    await meta.operate(await frag_oid_for_name(meta, dino, name),
                       ObjectOperation().create().omap_set(
                           {name: encode(dentry)}))


async def inject(meta, inos: dict[int, dict]) -> dict:
    """Phase 2: link every recovered ino whose dentry is missing.
    Placement: the backtraced (parent, name) when the parent dirfrag
    is alive and the name is free or already ours; otherwise
    ``lost+found/<ino:x>``."""
    linked, existing, lost = [], [], []
    lf_ino = None
    alive_cache: dict[int, bool] = {}

    async def parent_alive(dino: int) -> bool:
        if dino not in alive_cache:
            alive_cache[dino] = await _dirfrag_alive(meta, dino)
        return alive_cache[dino]

    for ino in sorted(inos):
        rec = inos[ino]
        target = None
        if rec["parent"] is not None and rec["name"] is not None \
                and await parent_alive(rec["parent"]):
            cur = await _dentry_for(meta, rec["parent"], rec["name"])
            if cur is None:
                target = (rec["parent"], rec["name"])
            elif int(cur.get("ino", 0)) == ino:
                existing.append(ino)
                continue
            # name taken by a different ino: fall through to l+f
        if target is None:
            if lf_ino is None:
                lf_ino = await _ensure_lost_found(meta)
            name = f"{ino:x}"
            cur = await _dentry_for(meta, lf_ino, name)
            if cur is not None:
                existing.append(ino)
                continue
            target = (lf_ino, name)
            lost.append(ino)
        now = time.time()
        dentry = {"ino": ino, "type": rec.get("type", "file"),
                  "mode": 0o644, "size": rec["size"],
                  "mtime": now, "ctime": now}
        if dentry["type"] == "symlink":
            dentry["target"] = rec.get("target", "")
            dentry["size"] = 0
        await _link(meta, target[0], target[1], dentry)
        linked.append({"ino": ino, "parent": target[0],
                       "name": target[1], "size": rec["size"]})
    return {"linked": linked, "already_present": existing,
            "lost_found": lost}


async def _ensure_lost_found(meta) -> int:
    """lost+found under root; its ino rides the root dirfrag like
    any directory (created with an out-of-band recovery ino derived
    from the name hash, stable across reruns)."""
    cur = await _dentry_for(meta, ROOT_INO, LOST_FOUND)
    if cur is not None:
        return int(cur["ino"])
    # recovery ino: far above any allocator partition floor traffic
    # would reach quickly, deterministic so reruns converge
    lf_ino = (1 << 40) | 0xF05F
    now = time.time()
    await _link(meta, ROOT_INO, LOST_FOUND, {
        "ino": lf_ino, "type": "dir", "mode": 0o755,
        "mtime": now, "ctime": now,
    })
    await meta.operate(dirfrag_oid(lf_ino),
                       ObjectOperation().create().set_xattr(
                           "parent", str(ROOT_INO).encode()))
    return lf_ino


async def _run(args) -> int:
    from ceph_tpu_torch.cli import _load_conf
    monmap, conf = _load_conf(args.conf)
    rados = Rados(monmap, conf, name="client.data-scan")
    await rados.connect()
    try:
        data = await rados.open_ioctx(args.data_pool)
        inos = await scan_pool(data, args.block_size)
        if args.cmd == "scan":
            out = {f"{i:x}": r for i, r in sorted(inos.items())}
        else:
            meta = await rados.open_ioctx(args.meta_pool)
            out = await inject(meta, inos)
        print(json.dumps(out, indent=2, default=str))
        return 0
    finally:
        await rados.shutdown()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cephfs-data-scan")
    p.add_argument("--conf", default="cluster.json")
    p.add_argument("--meta-pool", default="cephfs_meta")
    p.add_argument("--data-pool", default="cephfs_data")
    p.add_argument("--block-size", type=int, default=4 << 20,
                   help="the filesystem's data block size")
    p.add_argument("cmd", choices=["scan", "inject"])
    return p


def main(argv: list[str] | None = None) -> int:
    return asyncio.run(_run(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
