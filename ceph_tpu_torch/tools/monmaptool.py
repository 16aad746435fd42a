"""monmaptool: create and edit monmaps offline (src/tools/monmaptool).

Counterpart of ceph_tpu/tools/monmaptool.py: the same module over the
port's imports.

The monmap here is the ``{name: addr}`` dict every daemon is handed at
boot; durable form is either a bare monmap JSON or the cluster-conf
document the CLI reads (``{"monmap": {...}, "overrides": {...}}`` —
vstart's write_conf shape).  This tool edits both, preserving whichever
shape the file already has, so after a mon-store rebuild the operator
can point the rebuilt store at a NEW quorum:

    python -m ceph_tpu_torch.tools.monmaptool /run/cluster.json --create \
        --add a local://mon.a --add b local://mon.b
    python -m ceph_tpu_torch.tools.monmaptool /run/cluster.json --rm c
    python -m ceph_tpu_torch.tools.monmaptool /run/cluster.json --print

Writes are atomic (tmp + rename): a crashed edit never leaves a
half-written conf for the next daemon boot to trip on.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def _load(path: str, create: bool) -> tuple[dict, dict]:
    """Returns (document, monmap-view).  The view aliases the document
    so edits land in whichever shape the file uses."""
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
        if create and doc:
            raise FileExistsError(
                f"{path} exists (use --clobber to recreate)")
    elif create:
        doc = {"monmap": {}, "overrides": {}}
    else:
        raise FileNotFoundError(f"{path}: no monmap (want --create?)")
    if "monmap" in doc:
        return doc, doc["monmap"]
    return doc, doc


def _save(path: str, doc: dict) -> None:
    tmp = path + ".new"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


async def _run(args) -> int:
    try:
        if args.create and args.clobber and os.path.exists(args.path):
            os.unlink(args.path)
        doc, monmap = _load(args.path, args.create)
    except (FileNotFoundError, FileExistsError,
            json.JSONDecodeError) as e:
        print(f"monmaptool: {e}", file=sys.stderr)
        return 1
    changed = bool(args.create)
    for name, addr in args.add or []:
        if name in monmap and monmap[name] != addr:
            print(f"monmaptool: mon.{name} exists at {monmap[name]}",
                  file=sys.stderr)
            return 1
        changed |= monmap.get(name) != addr
        monmap[name] = addr
    for name in args.rm or []:
        if name not in monmap:
            print(f"monmaptool: no mon.{name}", file=sys.stderr)
            return 1
        del monmap[name]
        changed = True
    if changed:
        _save(args.path, doc)
    if args.print_map or not changed:
        print(json.dumps({
            "path": args.path,
            "mons": dict(sorted(monmap.items())),
            "num_mons": len(monmap),
        }, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="monmaptool",
                                description=__doc__)
    p.add_argument("path", help="monmap JSON or cluster-conf file")
    p.add_argument("--create", action="store_true",
                   help="start a fresh (cluster-conf shaped) file")
    p.add_argument("--clobber", action="store_true",
                   help="with --create: replace an existing file")
    p.add_argument("--add", nargs=2, action="append",
                   metavar=("NAME", "ADDR"),
                   help="add a monitor (repeat)")
    p.add_argument("--rm", action="append", metavar="NAME",
                   help="remove a monitor (repeat)")
    p.add_argument("--print", dest="print_map", action="store_true")
    return p


def main(argv=None) -> int:
    return asyncio.run(_run(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
