"""ceph-dencoder: encode/decode round-trip checking for wire types.

Counterpart of ceph_tpu/dencoder.py: the same module over the
port's imports.

The role of reference src/tools/ceph-dencoder + the per-type
``generate_test_instances`` fixtures (e.g. OSDMap.h:430): every
control-plane type that crosses a wire or lands in a durable store
must survive encode -> decode bit-for-bit.  The registry below pairs
each type with generated sample instances (empty, typical, and
edge-shaped) and a round-trip derived from the type's own wire form.

Usage:
    python -m ceph_tpu_torch.dencoder list
    python -m ceph_tpu_torch.dencoder check <type>
    python -m ceph_tpu_torch.dencoder check-all
"""

from __future__ import annotations

import argparse
import sys

from ceph_tpu_torch.msg.codec import decode, encode


def _codec_instances() -> list:
    return [
        None, True, False, 0, -1, 2 ** 63 - 1, -(2 ** 63),
        2 ** 80, -(2 ** 200), 1.5, -0.0, "", "uniçode",
        b"", b"\x00\xff" * 3, [], [1, [2, [3]]],
        {}, {"k": [None, {"n": b"deep"}], "": 0},
    ]


def _osdmap_instances() -> list:
    from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap, PoolInfo
    from ceph_tpu_torch.placement.crush_map import CrushMap

    empty = OSDMap()
    crush = CrushMap()
    crush.add_bucket("default", "root")
    for i in range(3):
        hb = crush.add_bucket(f"h{i}", "host")
        crush.add_item("default", hb)
        crush.add_item(f"h{i}", i)
    crush.create_replicated_rule("replicated_rule",
                                 failure_domain="host")
    m = OSDMap()
    inc1 = Incremental(1, new_crush=crush.to_dict())
    for i in range(3):
        inc1.new_up[i] = f"local://osd.{i}"
        inc1.new_weights[i] = 0x10000
    inc1.new_pools.append(PoolInfo(
        1, "p", "replicated", size=3, min_size=2, pg_num=8,
        crush_rule="replicated_rule"))
    m.apply_incremental(inc1)
    inc2 = Incremental(2, set_flags=["noout"])
    inc2.new_pg_upmap_items[(1, 0)] = [(0, 2)]
    m2 = OSDMap.from_dict(m.to_dict())
    m2.apply_incremental(inc2)
    return [empty, m, m2]


def _registry() -> dict:
    from ceph_tpu_torch.msg.message import Message
    from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap, PoolInfo
    from ceph_tpu_torch.osd.pg_log import LogEntry
    from ceph_tpu_torch.placement.crush_map import CrushMap
    from ceph_tpu_torch.store.object_store import Transaction
    from ceph_tpu_torch.store.txcodec import decode_tx, encode_tx
    from ceph_tpu_torch.store.types import CollectionId, GHObject

    def tx_samples() -> list:
        cid = CollectionId(1, 3, -1)
        oid = GHObject(1, "obj", -2, 0, -1)
        t1 = Transaction()
        t1.create_collection(cid)
        t1.touch(cid, oid)
        t1.write(cid, oid, 0, b"\x00payload\xff")
        t1.setattr(cid, oid, "k", b"v")
        t1.omap_setkeys(cid, oid, {"a": b"1", "b": b""})
        t2 = Transaction()
        t2.remove(cid, oid)
        return [Transaction(), t1, t2]

    def crush_samples() -> list:
        plain = CrushMap()
        classed = CrushMap()
        classed.add_bucket("default", "root")
        h = classed.add_bucket("h0", "host")
        classed.add_item("default", h)
        classed.add_item("h0", 0)
        classed.add_item("h0", 1)
        classed.set_item_class(0, "ssd")
        classed.create_replicated_rule("r", failure_domain="osd")
        return [plain, classed]

    return {
        "codec": {
            "instances": _codec_instances,
            "roundtrip": lambda v: decode(encode(v)),
            "project": lambda v: v,
        },
        "OSDMap": {
            "instances": _osdmap_instances,
            "roundtrip": lambda m: type(m).from_dict(
                decode(encode(m.to_dict()))),
            "project": lambda m: m.to_dict(),
        },
        "OSDMap::Incremental": {
            "instances": lambda: [
                Incremental(1),
                Incremental(5, set_flags=["noout", "pause"],
                            unset_flags=["nodown"]),
                _inc_full(),
            ],
            "roundtrip": lambda i: Incremental.from_dict(
                decode(encode(i.to_dict()))),
            "project": lambda i: i.to_dict(),
        },
        "PoolInfo": {
            "instances": lambda: [
                PoolInfo(1, "p", "replicated", size=3, min_size=2,
                         pg_num=8, crush_rule="r"),
                PoolInfo(2, "ec", "erasure", size=6, min_size=5,
                         pg_num=32, crush_rule="ec",
                         ec_profile={"k": "4", "m": "2"}),
            ],
            "roundtrip": lambda p: PoolInfo.from_dict(
                decode(encode(p.to_dict()))),
            "project": lambda p: p.to_dict(),
        },
        "CrushMap": {
            "instances": crush_samples,
            "roundtrip": lambda c: CrushMap.from_dict(
                decode(encode(c.to_dict()))),
            "project": lambda c: c.to_dict(),
        },
        "pg_log_entry_t": {
            "instances": lambda: [
                LogEntry(1, 1, "o", "modify", 1),
                LogEntry(7, 3, "x" * 64, "delete", 9, 8,
                         "client.4:17"),
            ],
            "roundtrip": lambda e: LogEntry.from_wire(
                decode(encode(e.to_wire()))),
            "project": lambda e: e.to_wire(),
        },
        "Message": {
            "instances": lambda: [
                Message("ping", {}),
                Message("osd_op", {"oid": "o", "ops": [
                    {"op": "write", "data": b"\xde\xad"}]},
                    priority=196),
            ],
            "roundtrip": lambda m: Message.from_wire(
                decode(encode(m.to_wire())), seq=m.seq),
            "project": lambda m: m.to_wire(),
        },
        "ObjectStore::Transaction": {
            "instances": tx_samples,
            "roundtrip": lambda t: decode_tx(
                decode(encode(encode_tx(t)))),
            "project": lambda t: encode_tx(t),
        },
    }


def _inc_full():
    from ceph_tpu_torch.osd.osd_map import Incremental, PoolInfo

    inc = Incremental(9)
    inc.new_up[0] = "local://osd.0"
    inc.new_down.append(1)
    inc.new_weights[0] = 0x8000
    inc.new_pools.append(PoolInfo(3, "q", "replicated", size=2,
                                  min_size=1, pg_num=4,
                                  crush_rule="r"))
    inc.new_pg_temp[(3, 1)] = [2, 0]
    inc.new_pg_upmap_items[(3, 0)] = [(0, 1)]
    return inc


def check(name: str) -> list[str]:
    """Round-trip every sample instance of ``name``; returns failure
    descriptions (empty = pass)."""
    spec = _registry()[name]
    failures = []
    for i, inst in enumerate(spec["instances"]()):
        back = spec["roundtrip"](inst)
        a, b = spec["project"](inst), spec["project"](back)
        if a != b:
            failures.append(f"{name}[{i}]: {a!r} != {b!r}")
        # determinism: same value must produce identical bytes
        ra = encode(a) if not isinstance(a, (bytes, bytearray)) else a
        rb = encode(b) if not isinstance(b, (bytes, bytearray)) else b
        if ra != rb:
            failures.append(f"{name}[{i}]: non-deterministic encode")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-dencoder",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    c = sub.add_parser("check")
    c.add_argument("type")
    sub.add_parser("check-all")
    args = p.parse_args(argv)
    reg = _registry()
    if args.cmd == "list":
        print("\n".join(sorted(reg)))
        return 0
    names = sorted(reg) if args.cmd == "check-all" else [args.type]
    bad = 0
    for name in names:
        if name not in reg:
            print(f"unknown type {name!r}", file=sys.stderr)
            return 2
        failures = check(name)
        n = len(reg[name]["instances"]())
        if failures:
            bad += 1
            print(f"{name}: FAIL ({len(failures)}/{n})")
            for f in failures:
                print(f"  {f}", file=sys.stderr)
        else:
            print(f"{name}: ok ({n} instances)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
