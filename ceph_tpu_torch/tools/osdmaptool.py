"""osdmaptool: offline OSDMap inspection and placement simulation.

Counterpart of ceph_tpu/tools/osdmaptool.py: the same module over the
port's imports.

The reference src/tools/osdmaptool.cc roles that matter for DR and
rebalancing, over a map taken from a file or pulled out of a (stopped)
monitor store:

    --print            map summary
    --export FILE      write the encoded map (for later offline runs)
    --diff OTHER       structural delta against a second map
    --test-map-pgs     simulate the WHOLE PG space.  Raw CRUSH rows
                       ride the vectorized placement/bulk mapper
                       (map_pgs_bulk — bit-identical to do_rule, with
                       scalar fallback for EC/indep rules), then the
                       shared raw_row_to_up pipeline + pg_temp/
                       primary_temp overrides, so offline output is
                       bit-identical to the live cluster's
                       pg_to_up_acting at the same epoch.
    --upmap            propose pg-upmap-items moving PGs from the
                       fullest to the emptiest OSDs until per-OSD PG
                       counts sit within --upmap-deviation.

Usage:
    python -m ceph_tpu_torch.tools.osdmaptool --mon-store run/mon.a \
        --export /tmp/om.bin
    python -m ceph_tpu_torch.tools.osdmaptool /tmp/om.bin --test-map-pgs
    python -m ceph_tpu_torch.tools.osdmaptool /tmp/om.bin --upmap \
        --upmap-deviation 1
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.osd.osd_map import NO_OSD, OSDMap
from ceph_tpu_torch.placement.bulk import map_pgs_bulk


def load_map(args) -> OSDMap:
    """An OSDMap from ``mapfile`` (codec bytes or JSON text) or from a
    stopped monitor's store (``--mon-store`` [+ ``--epoch``])."""
    if args.mon_store:
        from ceph_tpu_torch.mon.store import MonitorDBStore

        store = MonitorDBStore.open_readonly(args.mon_store)
        epoch = args.epoch or store.get_int("osdmap", "last_committed")
        raw = store.get("osdmap", f"full_{epoch}")
        if raw is None:
            raise FileNotFoundError(
                f"no full_{epoch} in {args.mon_store} (have: "
                f"{[k for k in store.keys('osdmap')][:8]}...)")
        return OSDMap.from_dict(decode(raw))
    if not args.mapfile:
        raise FileNotFoundError("need a mapfile or --mon-store")
    with open(args.mapfile, "rb") as f:
        raw = f.read()
    if raw[:1] == b"{":
        return OSDMap.from_dict(json.loads(raw))
    return OSDMap.from_dict(decode(raw))


def map_pool_pgs(m: OSDMap, pool_id: int) -> dict[int, tuple]:
    """Every PG of one pool -> (up, up_primary, acting,
    acting_primary), raw rows computed in ONE vectorized bulk-mapper
    call and then pushed through the same raw_row_to_up + temp-override
    pipeline pg_to_up_acting uses — shared truth, not a re-
    implementation."""
    pool = m.pools[pool_id]
    xs = [pool.raw_pg_to_pps(ps) for ps in range(pool.pg_num)]
    rows = map_pgs_bulk(m.crush, pool.crush_rule, xs, pool.size,
                        m.reweight_vector())
    out = {}
    for ps in range(pool.pg_num):
        up = m.raw_row_to_up(pool_id, ps, [int(o) for o in rows[ps]])
        acting = list(m.pg_temp.get((pool_id, ps), up)) or up
        primary = m.primary_temp.get((pool_id, ps))
        up_primary = next((o for o in up if o != NO_OSD), NO_OSD)
        acting_primary = (
            primary if primary is not None
            else next((o for o in acting if o != NO_OSD), NO_OSD)
        )
        out[ps] = (up, up_primary, acting, acting_primary)
    return out


def _pg_counts(m: OSDMap, pools: list[int]) -> dict[int, int]:
    """PGs-per-OSD over the up sets of ``pools`` (what upmap
    balances).  Every up+in OSD appears, even at count 0 — the
    emptiest OSD is exactly who rebalancing must find."""
    counts = {o: 0 for o, i in m.osds.items()
              if i.up and i.in_cluster}
    for pid in pools:
        for up, *_ in map_pool_pgs(m, pid).values():
            for o in up:
                if o != NO_OSD:
                    counts[o] = counts.get(o, 0) + 1
    return counts


def propose_upmaps(m: OSDMap, pools: list[int], deviation: int = 1,
                   max_proposals: int = 10) -> dict:
    """Greedy pg-upmap-items proposals (the OSDMap::calc_pg_upmaps
    role): repeatedly move one PG from the fullest OSD to the emptiest
    candidate until max-min <= deviation.  Every proposal is validated
    by applying it to a working copy of the map and recomputing the
    PG's up set — an upmap the placement pipeline would ignore
    (_apply_upmap's to-is-up/in/absent rules) is never emitted."""
    work = OSDMap.from_dict(m.to_dict())
    proposals: list[dict] = []
    before = _pg_counts(work, pools)
    for _ in range(max_proposals):
        counts = _pg_counts(work, pools)
        if not counts or max(counts.values()) - min(counts.values()) \
                <= deviation:
            break
        full = max(counts, key=lambda o: (counts[o], o))
        empties = sorted(counts, key=lambda o: (counts[o], o))
        moved = False
        for pid in pools:
            for ps, (up, *_rest) in map_pool_pgs(work, pid).items():
                if full not in up:
                    continue
                to = next((u for u in empties
                           if counts[u] < counts[full] - deviation
                           and u not in up), None)
                if to is None:
                    continue
                pairs = list(work.pg_upmap_items.get((pid, ps), []))
                pairs.append((full, to))
                work.pg_upmap_items[(pid, ps)] = pairs
                new_up, *_ = work.pg_to_up_acting(pid, ps)
                if full in new_up or to not in new_up:
                    # the pipeline rejected it: back out and keep
                    # looking rather than publish a dead proposal
                    work.pg_upmap_items[(pid, ps)] = pairs[:-1]
                    if not pairs[:-1]:
                        work.pg_upmap_items.pop((pid, ps), None)
                    continue
                # the full pair list: pg-upmap-items SETS a pg's
                # mapping wholesale, so a later proposal for the same
                # pg must supersede (not append to) an earlier one
                proposals.append({
                    "pgid": f"{pid}.{ps}",
                    "mappings": [list(pair) for pair in pairs],
                })
                moved = True
                break
            if moved:
                break
        if not moved:
            break
    after = _pg_counts(work, pools)
    return {
        "proposals": proposals,
        "commands": [
            "ceph osd pg-upmap-items {} {}".format(
                p["pgid"],
                " ".join(str(x) for pair in p["mappings"]
                         for x in pair))
            for p in proposals
        ],
        "before": {str(k): v for k, v in sorted(before.items())},
        "after": {str(k): v for k, v in sorted(after.items())},
    }


def _summary(m: OSDMap) -> dict:
    return {
        "epoch": m.epoch,
        "flags": sorted(m.flags),
        "pools": {
            str(pid): {"name": p.name, "pg_num": p.pg_num,
                       "size": p.size, "type": p.pool_type,
                       "crush_rule": p.crush_rule}
            for pid, p in sorted(m.pools.items())
        },
        "osds": {
            str(o): {"up": i.up, "in": i.in_cluster,
                     "weight": i.weight}
            for o, i in sorted(m.osds.items())
        },
        "pg_upmap_items": {
            f"{pid}.{ps}": [list(pair) for pair in pairs]
            for (pid, ps), pairs in sorted(m.pg_upmap_items.items())
        },
    }


def _diff(a: OSDMap, b: OSDMap) -> dict:
    sa, sb = _summary(a), _summary(b)
    out: dict = {"epoch": [a.epoch, b.epoch]}
    for section in ("flags", "pools", "osds", "pg_upmap_items"):
        if sa[section] != sb[section]:
            if isinstance(sa[section], dict):
                keys = set(sa[section]) | set(sb[section])
                out[section] = {
                    k: [sa[section].get(k), sb[section].get(k)]
                    for k in sorted(keys)
                    if sa[section].get(k) != sb[section].get(k)
                }
            else:
                out[section] = [sa[section], sb[section]]
    return out


def _select_pools(m: OSDMap, spec: list[str] | None) -> list[int]:
    if not spec:
        return sorted(m.pools)
    out = []
    for s in spec:
        pid = next((pid for pid, p in m.pools.items()
                    if p.name == s or str(pid) == s), None)
        if pid is None:
            raise KeyError(f"no pool {s!r}")
        out.append(pid)
    return out


async def _run(args) -> int:
    try:
        m = load_map(args)
    except (FileNotFoundError, KeyError) as e:
        print(f"osdmaptool: {e}", file=sys.stderr)
        return 1
    did = False
    if args.export:
        with open(args.export, "wb") as f:
            f.write(encode(m.to_dict()))
        print(f"exported epoch {m.epoch} to {args.export}")
        did = True
    if args.print_map:
        print(json.dumps(_summary(m), indent=2))
        did = True
    if args.diff:
        other = load_map(argparse.Namespace(
            mapfile=args.diff, mon_store=None, epoch=0))
        print(json.dumps(_diff(m, other), indent=2))
        did = True
    if args.test_map_pgs:
        try:
            pools = _select_pools(m, args.pool)
        except KeyError as e:
            print(f"osdmaptool: {e}", file=sys.stderr)
            return 1
        result: dict = {"epoch": m.epoch, "pools": {}}
        for pid in pools:
            result["pools"][str(pid)] = {
                str(ps): {"up": up, "up_primary": upp,
                          "acting": acting, "acting_primary": actp}
                for ps, (up, upp, acting, actp)
                in map_pool_pgs(m, pid).items()
            }
        counts = _pg_counts(m, pools)
        result["osd_pg_count"] = {
            str(k): v for k, v in sorted(counts.items())}
        if counts:
            vals = list(counts.values())
            result["stats"] = {
                "min": min(vals), "max": max(vals),
                "avg": round(sum(vals) / len(vals), 2),
            }
        print(json.dumps(result, indent=2))
        did = True
    if args.upmap:
        try:
            pools = _select_pools(m, args.pool)
        except KeyError as e:
            print(f"osdmaptool: {e}", file=sys.stderr)
            return 1
        print(json.dumps(propose_upmaps(
            m, pools, deviation=args.upmap_deviation,
            max_proposals=args.upmap_max), indent=2))
        did = True
    if not did:
        print("osdmaptool: nothing to do (want --print, --export, "
              "--diff, --test-map-pgs or --upmap)", file=sys.stderr)
        return 2
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="osdmaptool",
                                description=__doc__)
    p.add_argument("mapfile", nargs="?", default="",
                   help="an exported OSDMap (codec bytes or JSON)")
    p.add_argument("--mon-store", default="",
                   help="pull the map from a stopped monitor's store")
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch to pull with --mon-store (0 = newest)")
    p.add_argument("--export", default="",
                   help="write the encoded map to this file")
    p.add_argument("--print", dest="print_map", action="store_true")
    p.add_argument("--diff", default="",
                   help="second mapfile to diff against")
    p.add_argument("--test-map-pgs", action="store_true",
                   help="simulate every PG's placement")
    p.add_argument("--upmap", action="store_true",
                   help="propose pg-upmap-items rebalancing")
    p.add_argument("--pool", action="append",
                   help="restrict to this pool (name or id; repeat)")
    p.add_argument("--upmap-deviation", type=int, default=1,
                   help="target max-min PGs-per-OSD spread")
    p.add_argument("--upmap-max", type=int, default=10,
                   help="max proposals per run")
    return p


def main(argv=None) -> int:
    return asyncio.run(_run(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
