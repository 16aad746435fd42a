"""monstore_tool: offline MonitorDBStore surgery (ceph-monstore-tool).

Counterpart of ceph_tpu/tools/monstore_tool.py: the same module over the
port's imports.

Verbs over a STOPPED monitor's store directory:

    dump      list every (prefix, key) with value sizes
    get       print one value, decoded best-effort
    rebuild   reconstruct the store from surviving OSD data — the
              last-resort path after TOTAL monitor loss (the reference
              ceph-monstore-tool rebuild + ceph-objectstore-tool
              update-mon-db combination): harvest the newest OSDMap
              epochs and rotating-service-secret snapshots out of each
              OSD's object store, synthesize consistent paxos
              first/last-committed markers, and commit with a
              two-phase atomic store swap.

Usage:
    python -m ceph_tpu_torch.tools.monstore_tool dump --store-path run/mon.a
    python -m ceph_tpu_torch.tools.monstore_tool rebuild \
        --store-path run/mon.a \
        --osd-store run/osd.0 --osd-store run/osd.1 \
        --admin-key secret

A rebuilt store holds the osdmap service at the newest harvested
epoch, auth material (admin entity + harvested service secrets), and
one synthesized paxos version carrying the whole state, so a restarted
quorum elects, refreshes, and serves without re-running genesis.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import sys
import time

from ceph_tpu_torch.mon.store import MonitorDBStore, StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.objectstore_tool import harvest_meta


def _decode_value(raw: bytes) -> object:
    """Best-effort value rendering for dump/get: int markers, codec
    blobs, json, then base64 as the last resort."""
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return decode(raw)
    except Exception:  # noqa: BLE001 — not a codec blob
        pass
    try:
        return json.loads(raw)
    except ValueError:
        return {"b64": base64.b64encode(raw).decode()}


async def _harvest(osd_paths: list[str]) -> tuple[dict, dict]:
    """Union of every OSD's persisted map history and service-secret
    snapshots: {epoch: map_dict}, {secret_epoch: secret}.  A partially
    harvestable fleet is fine — the newest epoch any survivor holds
    wins (same epoch from two OSDs is the same deterministic map)."""
    epochs: dict[int, dict] = {}
    secrets: dict[int, str] = {}
    for path in osd_paths:
        meta = await harvest_meta(path)
        if not meta["epochs"]:
            print(f"monstore_tool: warning: no map history in {path}",
                  file=sys.stderr)
        epochs.update(meta["epochs"])
        secrets.update(meta["service_secrets"])
    return epochs, secrets


def build_rebuild_tx(epochs: dict[int, dict], secrets: dict[int, str],
                     admin_key: str = "", keep: int = 64
                     ) -> StoreTransaction:
    """The complete rebuilt store as one transaction.  Layout must
    satisfy every consumer on the restart path: OSDMonitor.refresh
    (osdmap/full_{last} + last_committed), Paxos.__init__ (paxos/
    last_committed, and version 1 holding the state so collect/share
    with a behind peon works), AuthMonitor.refresh (auth/entity/* +
    auth/secret/*)."""
    if not epochs:
        raise ValueError("no OSDMap epochs harvested — nothing to "
                         "rebuild from")
    newest = max(epochs)
    kept = sorted(epochs)[-keep:]
    svc = StoreTransaction()
    for e in kept:
        svc.put("osdmap", f"full_{e}", encode(epochs[e]))
    svc.put("osdmap", "last_committed", newest)
    if admin_key:
        svc.put("auth", "entity/client.admin", json.dumps({
            "key": admin_key,
            "caps": {"mon": "allow *", "osd": "allow *",
                     "mds": "allow *"},
        }).encode())
    for se, secret in sorted(secrets.items()):
        svc.put("auth", f"secret/{se}", json.dumps({
            "secret": secret, "created": time.time(),
        }).encode())
    # paxos version 1 IS the service state: a peon restored from an
    # older rebuild can be caught up by plain share_state replay
    tx = StoreTransaction().append(svc)
    tx.put("paxos", "1", svc.encode())
    tx.put("paxos", "first_committed", 1)
    tx.put("paxos", "last_committed", 1)
    return tx


async def _run(args) -> int:
    if args.verb == "rebuild":
        epochs, secrets = await _harvest(args.osd_store)
        try:
            tx = build_rebuild_tx(epochs, secrets,
                                  admin_key=args.admin_key,
                                  keep=args.keep)
        except ValueError as e:
            print(f"monstore_tool: {e}", file=sys.stderr)
            return 1
        wal = MonitorDBStore.install(args.store_path, tx)
        print(json.dumps({
            "rebuilt": wal,
            "osdmap_last_committed": max(epochs),
            "osdmap_epochs": sorted(epochs)[-args.keep:],
            "service_secret_epochs": sorted(secrets),
            "admin_entity": bool(args.admin_key),
        }, indent=2))
        return 0

    try:
        store = MonitorDBStore.open_readonly(args.store_path)
    except FileNotFoundError as e:
        print(f"monstore_tool: {e}", file=sys.stderr)
        return 1
    if args.verb == "dump":
        out: dict[str, dict] = {}
        for prefix, key, value in store.iter_all():
            out.setdefault(prefix, {})[key] = len(value)
        print(json.dumps(out, indent=2))
        return 0
    if args.verb == "get":
        raw = store.get(args.prefix, args.key)
        if raw is None:
            print(f"monstore_tool: no ({args.prefix!r}, {args.key!r})",
                  file=sys.stderr)
            return 1
        if args.raw:
            sys.stdout.buffer.write(raw)
            return 0
        print(json.dumps({
            "prefix": args.prefix, "key": args.key, "size": len(raw),
            "value": _decode_value(raw),
        }, indent=2, default=str))
        return 0
    print(f"unknown verb {args.verb!r}", file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="monstore-tool",
                                description=__doc__)
    sub = p.add_subparsers(dest="verb", required=True)

    d = sub.add_parser("dump", help="list every prefix/key with sizes")
    d.add_argument("--store-path", required=True,
                   help="a stopped monitor's store directory")

    g = sub.add_parser("get", help="print one value")
    g.add_argument("--store-path", required=True)
    g.add_argument("prefix")
    g.add_argument("key")
    g.add_argument("--raw", action="store_true",
                   help="write the raw bytes to stdout")

    r = sub.add_parser(
        "rebuild",
        help="reconstruct the store from surviving OSD stores",
    )
    r.add_argument("--store-path", required=True,
                   help="monitor store directory to (re)create")
    r.add_argument("--osd-store", action="append", required=True,
                   help="a stopped OSD's store directory (repeat per "
                        "survivor)")
    r.add_argument("--admin-key", default="",
                   help="client.admin key to seed into the auth "
                        "database (required for a cephx cluster)")
    r.add_argument("--keep", type=int, default=64,
                   help="newest harvested epochs to retain")
    return p


def main(argv=None) -> int:
    return asyncio.run(_run(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
