"""OSDMap: epoch-versioned cluster map + incrementals.

Counterpart of ceph_tpu/osd/osd_map.py: the same module over the
port's imports.

Mirrors reference osd/OSDMap.{h,cc}: pools, osd up/in state + reweights,
placement pipeline pg_to_raw_osds -> _raw_to_up_osds -> pg_temp overrides
(reference OSDMap.cc:2585, 2395 crush call, 2472 raw_to_up), and
OSDMap::Incremental deltas (OSDMap.h:354). Serializable to plain dicts for
the wire/monitor store.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ceph_tpu_torch.placement.crush_map import CrushMap, ITEM_NONE, Rule
from ceph_tpu_torch.placement.hashing import crush_hash32_2

NO_OSD = -1  # CRUSH_ITEM_NONE mapped to acting-set hole


@dataclass
class OSDInfo:
    up: bool = False
    in_cluster: bool = True
    weight: int = 0x10000       # in/out reweight, 16.16
    addr: str = ""


@dataclass
class PoolInfo:
    pool_id: int
    name: str
    pool_type: str = "replicated"           # or "erasure"
    size: int = 3                            # replicas, or k+m for EC
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 0            # 0 = follow pg_num (set at create)
    pg_autoscale_mode: str = "warn"     # off | warn | on
    crush_rule: str = "replicated_rule"
    ec_profile: str = ""                     # EC profile name
    snap_seq: int = 0                        # newest allocated snap id
    hit_set_type: str = ""                   # "" = off, or "bloom"
    hit_set_period: float = 0.0              # seconds per archived set
    hit_set_count: int = 4                   # archived sets kept
    # cache tiering (pg_pool_t tier fields): a cache pool points at its
    # base via tier_of; the base redirects clients via read/write_tier
    tier_of: int = -1                        # base pool id (cache pools)
    read_tier: int = -1                      # overlay for reads (base)
    write_tier: int = -1                     # overlay for writes (base)
    cache_mode: str = ""                     # "", writeback, readonly
    target_max_objects: int = 0              # eviction ceiling (cache)
    target_max_bytes: int = 0
    # pool quotas (pg_pool_t quota_max_*): the mon raises full_quota
    # when the PGMap digest shows usage at/over a limit; OSDs then
    # refuse writes with EDQUOT until usage drops and it clears
    quota_max_bytes: int = 0
    quota_max_objects: int = 0
    full_quota: bool = False
    removed_snaps: list = field(default_factory=list)

    def raw_pg_to_pps(self, ps: int) -> int:
        """Placement seed: stable mod then mix with pool id
        (pg_pool_t::raw_pg_to_pps semantics)."""
        from ceph_tpu_torch.osd.pg import ceph_stable_mod, pg_num_mask

        pgp = self.pgp_num or self.pg_num
        return int(crush_hash32_2(
            ceph_stable_mod(ps, pgp, pg_num_mask(pgp)), self.pool_id))

    def to_dict(self) -> dict:
        return {
            "pool_id": self.pool_id, "name": self.name,
            "type": self.pool_type, "size": self.size,
            "min_size": self.min_size, "pg_num": self.pg_num,
            "pgp_num": self.pgp_num,
            "pg_autoscale_mode": self.pg_autoscale_mode,
            "crush_rule": self.crush_rule, "ec_profile": self.ec_profile,
            "snap_seq": self.snap_seq,
            "removed_snaps": list(self.removed_snaps),
            "hit_set_type": self.hit_set_type,
            "hit_set_period": self.hit_set_period,
            "hit_set_count": self.hit_set_count,
            "tier_of": self.tier_of,
            "read_tier": self.read_tier,
            "write_tier": self.write_tier,
            "cache_mode": self.cache_mode,
            "target_max_objects": self.target_max_objects,
            "target_max_bytes": self.target_max_bytes,
            "quota_max_bytes": self.quota_max_bytes,
            "quota_max_objects": self.quota_max_objects,
            "full_quota": self.full_quota,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PoolInfo":
        return cls(
            pool_id=int(d["pool_id"]), name=d["name"],
            pool_type=d.get("type", "replicated"),
            size=int(d.get("size", 3)), min_size=int(d.get("min_size", 2)),
            pg_num=int(d.get("pg_num", 32)),
            pgp_num=int(d.get("pgp_num", 0)),
            pg_autoscale_mode=str(d.get("pg_autoscale_mode", "warn")),
            crush_rule=d.get("crush_rule", "replicated_rule"),
            ec_profile=d.get("ec_profile", ""),
            snap_seq=int(d.get("snap_seq", 0)),
            removed_snaps=[int(s) for s in d.get("removed_snaps", ())],
            hit_set_type=str(d.get("hit_set_type", "")),
            hit_set_period=float(d.get("hit_set_period", 0.0)),
            hit_set_count=int(d.get("hit_set_count", 4)),
            tier_of=int(d.get("tier_of", -1)),
            read_tier=int(d.get("read_tier", -1)),
            write_tier=int(d.get("write_tier", -1)),
            cache_mode=str(d.get("cache_mode", "")),
            target_max_objects=int(d.get("target_max_objects", 0)),
            target_max_bytes=int(d.get("target_max_bytes", 0)),
            quota_max_bytes=int(d.get("quota_max_bytes", 0)),
            quota_max_objects=int(d.get("quota_max_objects", 0)),
            full_quota=bool(d.get("full_quota", False)),
        )


@dataclass
class Incremental:
    epoch: int
    new_up: dict[int, str] = field(default_factory=dict)       # osd -> addr
    new_down: list[int] = field(default_factory=list)
    new_weights: dict[int, int] = field(default_factory=dict)  # 16.16
    # OSDs purged from the map (``osd purge`` after a drain); the
    # same epoch carries the CRUSH dump without their device items
    removed_osds: list[int] = field(default_factory=list)
    new_pools: list[PoolInfo] = field(default_factory=list)
    removed_pools: list[int] = field(default_factory=list)
    new_pg_temp: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    new_primary_temp: dict[tuple[int, int], int] = field(default_factory=dict)
    # pgid -> [(from_osd, to_osd), ...] persistent up-set remaps
    # (OSDMap.h pg_upmap_items; empty list clears the entry)
    new_pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = \
        field(default_factory=dict)
    # cluster flags (CEPH_OSDMAP_* bits as strings: noout, nodown, ...)
    set_flags: list[str] = field(default_factory=list)
    unset_flags: list[str] = field(default_factory=list)
    new_ec_profiles: dict[str, dict] = field(default_factory=dict)
    removed_ec_profiles: list[str] = field(default_factory=list)
    # client fencing (OSDMap.h blocklist role): "entity:nonce" (one
    # instance) or bare "entity" (every instance) -> expiry walltime
    new_blocklist: dict[str, float] = field(default_factory=dict)
    old_blocklist: list[str] = field(default_factory=list)
    new_crush: dict | None = None       # full crush dump when it changed

    # -- wire form (Incremental encode/decode, OSDMap.h:354) -------------
    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "new_up": {str(o): a for o, a in self.new_up.items()},
            "new_down": list(self.new_down),
            "new_weights": {str(o): w for o, w in self.new_weights.items()},
            "removed_osds": list(self.removed_osds),
            "new_pools": [p.to_dict() for p in self.new_pools],
            "removed_pools": list(self.removed_pools),
            "new_pg_temp": {
                f"{pid}.{ps}": list(v)
                for (pid, ps), v in self.new_pg_temp.items()
            },
            "new_primary_temp": {
                f"{pid}.{ps}": o
                for (pid, ps), o in self.new_primary_temp.items()
            },
            "new_pg_upmap_items": {
                f"{pid}.{ps}": [list(p) for p in pairs]
                for (pid, ps), pairs in self.new_pg_upmap_items.items()
            },
            "set_flags": list(self.set_flags),
            "unset_flags": list(self.unset_flags),
            "new_ec_profiles": {
                n: dict(p) for n, p in self.new_ec_profiles.items()
            },
            "removed_ec_profiles": list(self.removed_ec_profiles),
            "new_blocklist": {k: float(v)
                              for k, v in self.new_blocklist.items()},
            "old_blocklist": list(self.old_blocklist),
            "new_crush": self.new_crush,
        }

    @staticmethod
    def _pgid(s: str) -> tuple[int, int]:
        pid, _, ps = s.partition(".")
        return int(pid), int(ps)

    @classmethod
    def from_dict(cls, d: dict) -> "Incremental":
        return cls(
            epoch=int(d["epoch"]),
            new_up={int(o): a for o, a in d.get("new_up", {}).items()},
            new_down=[int(o) for o in d.get("new_down", ())],
            new_weights={
                int(o): int(w) for o, w in d.get("new_weights", {}).items()
            },
            new_pools=[
                PoolInfo.from_dict(p) for p in d.get("new_pools", ())
            ],
            removed_pools=[int(p) for p in d.get("removed_pools", ())],
            removed_osds=[int(o) for o in d.get("removed_osds", ())],
            new_pg_temp={
                cls._pgid(s): [int(o) for o in v]
                for s, v in d.get("new_pg_temp", {}).items()
            },
            new_primary_temp={
                cls._pgid(s): int(o)
                for s, o in d.get("new_primary_temp", {}).items()
            },
            new_pg_upmap_items={
                cls._pgid(s): [(int(a), int(b)) for a, b in pairs]
                for s, pairs in d.get("new_pg_upmap_items", {}).items()
            },
            set_flags=[str(f) for f in d.get("set_flags", ())],
            unset_flags=[str(f) for f in d.get("unset_flags", ())],
            new_ec_profiles={
                n: dict(p)
                for n, p in d.get("new_ec_profiles", {}).items()
            },
            removed_ec_profiles=list(d.get("removed_ec_profiles", ())),
            new_blocklist={
                str(k): float(v)
                for k, v in d.get("new_blocklist", {}).items()
            },
            old_blocklist=[str(k) for k in d.get("old_blocklist", ())],
            new_crush=d.get("new_crush"),
        )


class OSDMap:
    def __init__(self, crush: CrushMap | None = None):
        self.epoch = 0
        self.crush = crush or CrushMap()
        self.osds: dict[int, OSDInfo] = {}
        self.pools: dict[int, PoolInfo] = {}
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        self.primary_temp: dict[tuple[int, int], int] = {}
        self.pg_upmap_items: dict[tuple[int, int],
                                  list[tuple[int, int]]] = {}
        self.flags: set[str] = set()
        self.ec_profiles: dict[str, dict] = {}
        # fenced clients: "entity:nonce" or bare "entity" -> expiry
        # walltime (OSDMap.h blocklist role)
        self.blocklist: dict[str, float] = {}
        # never reused, even after pool deletion: a recycled id would
        # alias a dead pool's surviving shard objects into a new pool
        self.max_pool_id = 0
        # lazily-attached OSDMapMapping (epoch-cached bulk CRUSH rows)
        self._mapping = None

    # -- mutation via incrementals --------------------------------------
    def apply_incremental(self, inc: Incremental) -> None:
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != {self.epoch + 1}"
            )
        for osd, addr in inc.new_up.items():
            info = self.osds.setdefault(osd, OSDInfo())
            info.up, info.addr = True, addr
        for osd in inc.new_down:
            if osd in self.osds:
                self.osds[osd].up = False
        for osd, w in inc.new_weights.items():
            info = self.osds.setdefault(osd, OSDInfo())
            info.weight = w
            info.in_cluster = w > 0
        for osd in inc.removed_osds:
            self.osds.pop(osd, None)
        for pool in inc.new_pools:
            self.pools[pool.pool_id] = pool
            self.max_pool_id = max(self.max_pool_id, pool.pool_id)
        for pid in inc.removed_pools:
            self.pools.pop(pid, None)
            self.pg_temp = {
                k: v for k, v in self.pg_temp.items() if k[0] != pid
            }
            self.primary_temp = {
                k: v for k, v in self.primary_temp.items() if k[0] != pid
            }
            self.pg_upmap_items = {
                k: v for k, v in self.pg_upmap_items.items()
                if k[0] != pid
            }
        for pgid, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pgid] = list(osds)
            else:
                self.pg_temp.pop(pgid, None)
        for pgid, osd in inc.new_primary_temp.items():
            if osd == NO_OSD:
                self.primary_temp.pop(pgid, None)
            else:
                self.primary_temp[pgid] = osd
        for pgid, pairs in inc.new_pg_upmap_items.items():
            if pairs:
                self.pg_upmap_items[pgid] = [tuple(p) for p in pairs]
            else:
                self.pg_upmap_items.pop(pgid, None)
        self.flags |= set(inc.set_flags)
        self.flags -= set(inc.unset_flags)
        for name, profile in inc.new_ec_profiles.items():
            self.ec_profiles[name] = dict(profile)
        for name in inc.removed_ec_profiles:
            self.ec_profiles.pop(name, None)
        for ent, until in inc.new_blocklist.items():
            self.blocklist[ent] = float(until)
        for ent in inc.old_blocklist:
            self.blocklist.pop(ent, None)
        if inc.new_crush is not None:
            self.crush = CrushMap.from_dict(inc.new_crush)
        self.epoch = inc.epoch
        if self._mapping is not None:
            # carry the bulk-mapping cache forward: overlay-only epochs
            # (up/down, temps, upmaps, flags) keep every cached CRUSH
            # row; crush/weight/pool changes drop only what they touch
            self._mapping.note_incremental(inc)

    # -- queries ---------------------------------------------------------
    def is_up(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].up

    def reweight_vector(self) -> list[int]:
        n = max(self.osds, default=-1) + 1
        vec = [0] * n
        for osd, info in self.osds.items():
            vec[osd] = info.weight if info.in_cluster else 0
        return vec

    # -- placement pipeline ---------------------------------------------
    def mapping(self):
        """The map's OSDMapMapping (epoch-cached whole-PG-space CRUSH
        rows + vectorized up/acting table builders); created lazily so
        plain map construction/decode stays free."""
        if self._mapping is None:
            from ceph_tpu_torch.placement.mapping import OSDMapMapping

            self._mapping = OSDMapMapping(self)
        return self._mapping

    def pg_to_raw_osds(self, pool_id: int, ps: int) -> list[int]:
        """CRUSH evaluation (OSDMap.cc:2395 _pg_to_raw_osds) — a table
        lookup into the epoch-cached bulk mapping (bit-identical to the
        scalar walk, see placement/mapping.py)."""
        return self.mapping().raw_row(pool_id, ps)

    def _pg_to_raw_osds_scalar(self, pool_id: int, ps: int) -> list[int]:
        """The per-PG scalar CRUSH walk — the bit-identity oracle for
        the cached table path (property tests, bench.py --cfg11)."""
        pool = self.pools[pool_id]
        pps = pool.raw_pg_to_pps(ps)
        out = self.crush.do_rule(
            pool.crush_rule, pps, pool.size, self.reweight_vector()
        )
        return [NO_OSD if o == ITEM_NONE else o for o in out]

    def raw_to_up_osds(self, pool_id: int, raw: list[int]) -> list[int]:
        """Drop down/nonexistent OSDs (OSDMap.cc:2472): replicated pools
        compact the list; EC pools keep positional holes."""
        pool = self.pools[pool_id]
        if pool.pool_type == "erasure":
            return [
                o if o != NO_OSD and self.is_up(o) else NO_OSD for o in raw
            ]
        return [o for o in raw if o != NO_OSD and self.is_up(o)]

    def _apply_upmap(self, pool_id: int, ps: int,
                     raw: list[int]) -> list[int]:
        """pg_upmap_items remaps (OSDMap.cc:2425 _apply_upmap): each
        (from, to) pair replaces ``from`` in the raw set, positionally,
        when ``to`` is a live, in-cluster OSD not already present."""
        pairs = self.pg_upmap_items.get((pool_id, ps))
        if not pairs:
            return raw
        out = list(raw)
        for frm, to in pairs:
            if to in out or not self.is_up(to) \
                    or not self.osds[to].in_cluster:
                continue
            for i, o in enumerate(out):
                if o == frm:
                    out[i] = to
                    break
        return out

    def raw_row_to_up(self, pool_id: int, ps: int,
                      raw: list[int]) -> list[int]:
        """CRUSH row -> up set: ITEM_NONE normalization, upmap remap,
        down-filtering — shared by pg_to_up_acting and bulk-mapping
        consumers (the balancer) so the pipelines cannot drift."""
        raw = [NO_OSD if o == ITEM_NONE else o for o in raw]
        raw = self._apply_upmap(pool_id, ps, raw)
        return self.raw_to_up_osds(pool_id, raw)

    def pg_to_up_acting(self, pool_id: int, ps: int):
        """(up, up_primary, acting, acting_primary) with upmap then
        pg_temp / primary_temp overrides (OSDMap.cc _get_temp_osds)."""
        up = self.raw_row_to_up(pool_id, ps,
                                self.pg_to_raw_osds(pool_id, ps))
        acting = list(self.pg_temp.get((pool_id, ps), up))
        if not acting:
            acting = up
        primary = self.primary_temp.get((pool_id, ps))
        up_primary = next((o for o in up if o != NO_OSD), NO_OSD)
        acting_primary = (
            primary if primary is not None
            else next((o for o in acting if o != NO_OSD), NO_OSD)
        )
        return up, up_primary, acting, acting_primary

    # -- serialization ---------------------------------------------------
    def is_blocklisted(self, entity: str, nonce: int,
                       now: float) -> bool:
        """True when this client instance is fenced: an exact
        "entity:nonce" entry or a bare "entity" entry (all instances)
        that has not expired (OSDMap::is_blocklisted role)."""
        for key in (f"{entity}:{nonce}", entity):
            until = self.blocklist.get(key)
            if until is not None and until > now:
                return True
        return False

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "osds": {
                str(i): {
                    "up": o.up, "in": o.in_cluster,
                    "weight": o.weight, "addr": o.addr,
                }
                for i, o in self.osds.items()
            },
            "pools": {
                str(p.pool_id): p.to_dict() for p in self.pools.values()
            },
            "pg_temp": {
                f"{pid}.{ps}": v for (pid, ps), v in self.pg_temp.items()
            },
            "primary_temp": {
                f"{pid}.{ps}": o
                for (pid, ps), o in self.primary_temp.items()
            },
            "pg_upmap_items": {
                f"{pid}.{ps}": [list(p) for p in pairs]
                for (pid, ps), pairs in self.pg_upmap_items.items()
            },
            "flags": sorted(self.flags),
            "ec_profiles": {n: dict(p) for n, p in self.ec_profiles.items()},
            "blocklist": {k: float(v) for k, v in self.blocklist.items()},
            "max_pool_id": self.max_pool_id,
            "crush": self.crush.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OSDMap":
        m = cls(CrushMap.from_dict(d["crush"]))
        m.epoch = int(d["epoch"])
        for i, o in d.get("osds", {}).items():
            m.osds[int(i)] = OSDInfo(
                up=bool(o["up"]), in_cluster=bool(o["in"]),
                weight=int(o["weight"]), addr=o.get("addr", ""),
            )
        for pid, p in d.get("pools", {}).items():
            m.pools[int(pid)] = PoolInfo.from_dict(p)
        m.pg_temp = {
            Incremental._pgid(s): [int(o) for o in v]
            for s, v in d.get("pg_temp", {}).items()
        }
        m.primary_temp = {
            Incremental._pgid(s): int(o)
            for s, o in d.get("primary_temp", {}).items()
        }
        m.pg_upmap_items = {
            Incremental._pgid(s): [(int(a), int(b)) for a, b in pairs]
            for s, pairs in d.get("pg_upmap_items", {}).items()
        }
        m.flags = {str(f) for f in d.get("flags", ())}
        m.blocklist = {str(k): float(v)
                       for k, v in d.get("blocklist", {}).items()}
        m.ec_profiles = {
            n: dict(p) for n, p in d.get("ec_profiles", {}).items()
        }
        m.max_pool_id = max(
            int(d.get("max_pool_id", 0)), max(m.pools, default=0)
        )
        return m
