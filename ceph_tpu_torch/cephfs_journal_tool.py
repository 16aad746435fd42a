"""cephfs-journal-tool: offline MDS journal inspection and recovery.

Counterpart of ceph_tpu/cephfs_journal_tool.py: the same module over the
port's imports.

Reference src/tools/cephfs/JournalTool.cc (cephfs-journal-tool):
`journal inspect` walks the log and reports integrity,
`journal export`/`event get list` dump the events, and
`journal reset` truncates a corrupt log so the rank can boot —
the disaster-recovery companion to `cephfs-table-tool`
(here: the `table show/reset` verbs over the InoTable xattrs).

The -lite journal is a framed stream of encoded mutation records in
one RADOS object per rank (``mds_journal[.N]`` — see
mds/daemon.py:_journal), applied synchronously; "damage" here means a
torn tail or an undecodable frame, both of which `inspect` localises
to a byte offset.

Usage (offline: stop the MDS first, like the reference tool insists):
    python -m ceph_tpu_torch.cephfs_journal_tool --conf cluster.json \
        journal inspect [--rank N]
    ... journal export [--rank N]         # JSON events to stdout
    ... journal reset [--rank N] [--keep-intents]
    ... event get list [--rank N] [--op OP]
    ... table show | table reset --rank N
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.client.rados import ObjectOperation, Rados, RadosError
from ceph_tpu_torch.mds.daemon import (
    _FRAME,
    JOURNAL_OID,
    RANK_INO_BASE,
    ROOT_INO,
    SUBTREE_OID,
    TABLE_OID,
)
from ceph_tpu_torch.msg.codec import decode

ENOENT = -2


def journal_oid(rank: int) -> str:
    return JOURNAL_OID if rank == 0 else f"{JOURNAL_OID}.{rank}"


def walk_frames(raw: bytes) -> tuple[list[dict], int, str]:
    """Decode the framed event stream.  Returns (events,
    good_bytes, damage) where ``damage`` is "" for a clean log,
    else a description anchored at the offset ``good_bytes``."""
    pos = 0
    events: list[dict] = []
    while pos + _FRAME.size <= len(raw):
        (n,) = _FRAME.unpack_from(raw, pos)
        if pos + _FRAME.size + n > len(raw):
            return events, pos, (
                f"torn tail: frame of {n} bytes at offset {pos} "
                f"overruns the {len(raw)}-byte log")
        try:
            events.append(decode(raw[pos + _FRAME.size:
                                     pos + _FRAME.size + n]))
        except (ValueError, TypeError) as e:
            return events, pos, (
                f"undecodable event at offset {pos}: {e}")
        pos += _FRAME.size + n
    if pos != len(raw):
        return events, pos, (
            f"{len(raw) - pos} trailing bytes (short of a frame "
            f"header) at offset {pos}")
    return events, pos, ""


async def read_journal(meta, rank: int) -> bytes:
    try:
        return await meta.read(journal_oid(rank))
    except RadosError as e:
        if e.rc == ENOENT:
            return b""
        raise


def open_intents(events: list[dict]) -> dict[str, dict]:
    """Cross-rank two-phase intents still dangling at the log tail
    (the entries `journal reset --keep-intents` preserves: resolving
    them is what crash replay is FOR)."""
    out: dict[str, dict] = {}
    for e in events:
        op = str(e.get("op", ""))
        token = str(e.get("token", ""))
        if op.endswith("_intent"):
            out[token] = e
        elif op.endswith(("_finish", "_abort")):
            out.pop(token, None)
    return out


async def cmd_inspect(meta, rank: int) -> dict:
    raw = await read_journal(meta, rank)
    events, good, damage = walk_frames(raw)
    ops: dict[str, int] = {}
    for e in events:
        op = str(e.get("op", "?"))
        ops[op] = ops.get(op, 0) + 1
    return {
        "rank": rank,
        "object": journal_oid(rank),
        "bytes": len(raw),
        "events": len(events),
        "ops": dict(sorted(ops.items())),
        "open_intents": sorted(open_intents(events)),
        "overall": "OK" if not damage else "DAMAGED",
        "damage": damage,
    }


async def cmd_export(meta, rank: int) -> list[dict]:
    raw = await read_journal(meta, rank)
    events, _, damage = walk_frames(raw)
    if damage:
        print(f"# WARNING: {damage}; exporting the readable prefix",
              file=sys.stderr)
    return events


async def cmd_reset(meta, rank: int, keep_intents: bool) -> dict:
    raw = await read_journal(meta, rank)
    events, _, damage = walk_frames(raw)
    keep = b""
    kept = []
    if keep_intents:
        for token, e in open_intents(events).items():
            from ceph_tpu_torch.msg.codec import encode
            payload = encode(e)
            keep += _FRAME.pack(len(payload)) + payload
            kept.append(token)
    await meta.operate(journal_oid(rank),
                       ObjectOperation().create().write_full(keep))
    return {"rank": rank, "reset": True, "was_damaged": bool(damage),
            "dropped_events": len(events) - len(kept),
            "kept_intents": kept}


async def cmd_events(meta, rank: int, op_filter: str) -> list[dict]:
    raw = await read_journal(meta, rank)
    events, _, damage = walk_frames(raw)
    out = []
    for i, e in enumerate(events):
        if op_filter and str(e.get("op", "")) != op_filter:
            continue
        row = {"index": i, "op": e.get("op", "?")}
        for k in ("ino", "parent", "name", "token", "rank"):
            if k in e:
                row[k] = e[k]
        out.append(row)
    if damage:
        print(f"# WARNING: {damage}", file=sys.stderr)
    return out


async def cmd_table_show(meta) -> dict:
    """InoTable watermarks + the subtree map (cephfs-table-tool
    show_table role)."""
    ranks: dict[str, int] = {}
    try:
        for key, raw in (await meta.get_xattrs(TABLE_OID)).items():
            if key == "next_ino":
                ranks["0"] = int(raw)
            elif key.startswith("next_ino."):
                ranks[key.split(".", 1)[1]] = int(raw)
    except RadosError as e:
        if e.rc != ENOENT:
            raise
    try:
        subtrees = {k: int(v) for k, v in
                    (await meta.get_omap(SUBTREE_OID)).items()}
    except RadosError as e:
        if e.rc != ENOENT:
            raise
        subtrees = {}
    return {"inotable": ranks, "subtrees": subtrees}


async def cmd_table_reset(meta, rank: int) -> dict:
    """Reset one rank's ino allocator to its partition floor — ONLY
    safe when the rank's journal has also been reset (a stale
    watermark risks duplicate ino allocation; the reference tool
    carries the same warning)."""
    floor = ROOT_INO + 1 if rank == 0 else rank * RANK_INO_BASE + 1
    key = "next_ino" if rank == 0 else f"next_ino.{rank}"
    await meta.operate(TABLE_OID, ObjectOperation().create()
                       .set_xattr(key, str(floor).encode()))
    return {"rank": rank, "next_ino": floor}


async def _run(args) -> int:
    from ceph_tpu_torch.cli import _load_conf
    monmap, conf = _load_conf(args.conf)
    rados = Rados(monmap, conf, name="client.journal-tool")
    await rados.connect()
    try:
        meta = await rados.open_ioctx(args.meta_pool)
        if args.cmd == "journal":
            if args.action == "inspect":
                out = await cmd_inspect(meta, args.rank)
            elif args.action == "export":
                out = await cmd_export(meta, args.rank)
            else:
                out = await cmd_reset(meta, args.rank,
                                      args.keep_intents)
        elif args.cmd == "event":
            out = await cmd_events(meta, args.rank, args.op)
        else:
            if args.action == "show":
                out = await cmd_table_show(meta)
            else:
                out = await cmd_table_reset(meta, args.rank)
        print(json.dumps(out, indent=2, default=str))
        if isinstance(out, dict) and out.get("overall") == "DAMAGED":
            return 1
        return 0
    finally:
        await rados.shutdown()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cephfs-journal-tool")
    p.add_argument("--conf", default="cluster.json")
    p.add_argument("--meta-pool", default="cephfs_meta")
    sub = p.add_subparsers(dest="cmd", required=True)

    j = sub.add_parser("journal")
    j.add_argument("action", choices=["inspect", "export", "reset"])
    j.add_argument("--rank", type=int, default=0)
    j.add_argument("--keep-intents", action="store_true",
                   help="reset: preserve dangling cross-rank intents")

    e = sub.add_parser("event")
    e.add_argument("get", choices=["get"])
    e.add_argument("action", choices=["list"])
    e.add_argument("--rank", type=int, default=0)
    e.add_argument("--op", default="",
                   help="only events with this op")

    t = sub.add_parser("table")
    t.add_argument("action", choices=["show", "reset"])
    t.add_argument("--rank", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
