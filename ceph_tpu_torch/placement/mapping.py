"""OSDMapMapping: the online epoch-cached whole-PG-space mapping.

Counterpart of ceph_tpu/placement/mapping.py: the same module over the
port's imports.

The online analog of reference src/osd/OSDMapMapping.{h,cc}: after each
map change the full PG->up/acting table is derivable in one vectorized
pass per pool (placement.bulk.map_pgs_bulk) instead of per-PG Python
CRUSH walks.  This module owns the caching and the overlay application
so every consumer — OSDMap.pg_to_up_acting point lookups, OSD peering
rescans, the Objecter, the mgr balancer — reads the same table.

Two-level design, chosen so in-place overlay mutation (tests and tools
poke pg_temp/pg_upmap_items/osd up-state directly without an epoch
bump) can never serve stale placements:

1. The EXPENSIVE layer — raw CRUSH rows per pool — is cached.  Raw rows
   depend only on (crush tree identity, pool shape, reweight vector);
   none of the overlay dicts feed them.  Validity is signature-checked
   on access and the cache carries forward across incrementals that
   touch only up/down state, temps, upmaps, flags, or blocklists (the
   common case at scale), so an overlay-only epoch costs nothing.
2. The CHEAP layer — upmap remap, up-filtering, pg_temp/primary_temp —
   is applied live per lookup through the exact scalar pipeline
   (OSDMap.raw_row_to_up + the temp dicts), or vectorized over the
   whole pool by up_acting_tables() for bulk consumers (peering
   rescans, the balancer, the scale smoke) with sparse scalar fixups
   for overlaid PGs so the two paths cannot drift.

Bit-identity with the scalar walk is property-tested across randomized
maps (tests/test_osdmap_mapping.py) and gated in bench.py --cfg11.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ceph_tpu_torch.placement.bulk import _supported, map_pgs_bulk
from ceph_tpu_torch.placement.crush_map import ITEM_NONE

NO_OSD = -1


@dataclass
class PoolTables:
    """Dense up/acting tables for one pool at one observation point.

    ``up``/``acting`` are (pg_num, width) int32 padded with NO_OSD past
    each row's true length (``up_len``/``acting_len``); primaries are
    (pg_num,) int32.  ``lookup(ps)`` reproduces OSDMap.pg_to_up_acting
    bit-identically.  Tables are snapshots: they embed the overlay
    state at build time, which is exactly what the peering diff needs
    (compare the last completed scan's view against the current one).
    """

    pool_id: int
    pg_num: int
    up: np.ndarray
    up_len: np.ndarray
    up_primary: np.ndarray
    acting: np.ndarray
    acting_len: np.ndarray
    acting_primary: np.ndarray

    def lookup(self, ps: int):
        ul = int(self.up_len[ps])
        al = int(self.acting_len[ps])
        up = [int(o) for o in self.up[ps, :ul]]
        acting = [int(o) for o in self.acting[ps, :al]]
        return (up, int(self.up_primary[ps]),
                acting, int(self.acting_primary[ps]))

    def pgs_of(self, osd_id: int) -> np.ndarray:
        """PG ids whose up or acting set contains ``osd_id`` — the
        vectorized version of the peering loop's ``mine`` test."""
        mine = (np.any(self.up == osd_id, axis=1)
                | np.any(self.acting == osd_id, axis=1))
        return np.flatnonzero(mine)

    def diff(self, prev: "PoolTables") -> np.ndarray:
        """PG ids whose (up, up_primary, acting, acting_primary)
        changed between ``prev`` and this table — one array compare
        for the whole pool instead of a per-PG walk."""
        n = min(self.pg_num, prev.pg_num)
        d = _rows_differ(self.up[:n], prev.up[:n])
        d |= _rows_differ(self.acting[:n], prev.acting[:n])
        d |= self.up_primary[:n] != prev.up_primary[:n]
        d |= self.acting_primary[:n] != prev.acting_primary[:n]
        changed = list(np.flatnonzero(d))
        # pg_num moved (split/merge): every PG outside the overlap is new
        changed.extend(range(n, self.pg_num))
        return np.asarray(changed, np.int64)


def _rows_differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row inequality across possibly different widths (padding is
    NO_OSD, so extra columns only matter where they hold real ids)."""
    w = min(a.shape[1], b.shape[1])
    d = np.any(a[:, :w] != b[:, :w], axis=1)
    if a.shape[1] > w:
        d |= np.any(a[:, w:] != NO_OSD, axis=1)
    if b.shape[1] > w:
        d |= np.any(b[:, w:] != NO_OSD, axis=1)
    return d


class OSDMapMapping:
    """Per-OSDMap cache of raw CRUSH rows + vectorized table builders.

    Obtained via ``OSDMap.mapping()``; invalidation is automatic: the
    cache revalidates its signature (crush object identity, pool
    shapes, reweight vector) whenever the map's epoch moves, and
    ``OSDMap.apply_incremental`` calls ``note_incremental`` so carry-
    forward happens at the one point the map is known consistent.
    In-place mutation of weights/crush WITHOUT an epoch bump (nothing
    in the tree does this today) requires an explicit
    ``invalidate()``.
    """

    def __init__(self, osdmap):
        self._m = osdmap
        self._crush = None              # strong ref: identity check
        self._reweights: tuple = ()
        self._checked_epoch: int | None = None
        # pool_id -> (pool_sig, (pg_num, size) int32 raw rows, lens)
        self._raw: dict[int, tuple] = {}
        self.rebuilds = 0               # pools (re)built, for tests/bench

    # -- validity ---------------------------------------------------------
    def invalidate(self) -> None:
        self._raw.clear()
        self._checked_epoch = None

    def note_incremental(self, inc) -> None:
        """Carry-forward hook (called by OSDMap.apply_incremental after
        the epoch bump).  Drops only what the incremental can have
        changed; overlay-only epochs keep every cached row."""
        for pid in inc.removed_pools:
            self._raw.pop(pid, None)
        for pool in inc.new_pools:
            # replaced PoolInfo: the signature check would also catch a
            # shape change lazily, but dropping now frees the old table
            self._raw.pop(pool.pool_id, None)
        self._ensure()

    def _ensure(self) -> None:
        """Revalidate the global signature when the epoch moved (or on
        first use).  Raw rows depend only on the crush tree and the
        reweight vector; epoch-gating the O(osds) vector rebuild keeps
        point lookups cheap."""
        m = self._m
        if (self._checked_epoch == m.epoch and m.crush is self._crush):
            return
        rw = tuple(m.reweight_vector())
        if m.crush is not self._crush or rw != self._reweights:
            self._raw.clear()
            self._crush = m.crush
            self._reweights = rw
        self._checked_epoch = m.epoch

    @staticmethod
    def _pool_sig(pool) -> tuple:
        return (pool.pg_num, pool.pgp_num, pool.size, pool.crush_rule,
                pool.pool_type)

    # -- raw layer --------------------------------------------------------
    def raw_rows(self, pool_id: int):
        """(rows, lens) for the whole pool: rows is (pg_num, size)
        int32 ITEM_NONE-padded, lens[ps] is the true do_rule row
        length (firstn rows compact, indep rows keep holes)."""
        self._ensure()
        m = self._m
        pool = m.pools[pool_id]
        sig = self._pool_sig(pool)
        cached = self._raw.get(pool_id)
        if cached is not None and cached[0] == sig:
            return cached[1], cached[2]
        rows, lens = self._build_pool(pool)
        self._raw[pool_id] = (sig, rows, lens)
        self.rebuilds += 1
        return rows, lens

    def _build_pool(self, pool):
        m = self._m
        xs = [pool.raw_pg_to_pps(ps) for ps in range(pool.pg_num)]
        reweights = list(self._reweights)
        rule = m.crush.rules[pool.crush_rule]
        if _supported(m.crush, rule):
            rows = map_pgs_bulk(m.crush, rule, xs, pool.size, reweights)
            # firstn rows never hold interior ITEM_NONE: the non-pad
            # count IS the scalar row length
            lens = (rows != ITEM_NONE).sum(axis=1).astype(np.int32)
            return rows, lens
        # scalar fallback (indep/EC rules, exotic buckets): still cached,
        # so repeated epochs and bulk consumers pay the walk once
        rows = np.full((pool.pg_num, pool.size), ITEM_NONE, np.int32)
        lens = np.zeros(pool.pg_num, np.int32)
        for ps, x in enumerate(xs):
            row = m.crush.do_rule(rule, int(x), pool.size, reweights)
            rows[ps, :len(row)] = row
            lens[ps] = len(row)
        return rows, lens

    def raw_row(self, pool_id: int, ps: int) -> list[int]:
        """One pool's raw CRUSH row as pg_to_raw_osds returns it
        (ITEM_NONE normalized to NO_OSD, true scalar length)."""
        rows, lens = self.raw_rows(pool_id)
        row = rows[ps, :int(lens[ps])]
        return [NO_OSD if o == ITEM_NONE else int(o) for o in row]

    # -- vectorized overlay layer ----------------------------------------
    def up_acting_tables(self, pool_id: int) -> PoolTables:
        """Build the pool's full up/acting tables in one numpy pass:
        vectorized up-filtering over the cached raw rows, sparse scalar
        fixups for the few PGs with upmap/pg_temp/primary_temp entries
        (reusing the exact scalar pipeline keeps them bit-identical)."""
        m = self._m
        pool = m.pools[pool_id]
        raw, lens = self.raw_rows(pool_id)
        pgn, width = raw.shape
        pos = np.arange(width)[None, :]
        inlen = pos < lens[:, None]
        rows = np.where(raw == ITEM_NONE, NO_OSD, raw).astype(np.int32)

        # vectorized is_up: id -> up flag (absent ids are never up)
        max_osd = max(m.osds, default=-1)
        upv = np.zeros(max_osd + 2, bool)
        for o, info in m.osds.items():
            if o >= 0:
                upv[o] = info.up
        safe = np.clip(rows, 0, max_osd + 1)
        alive = inlen & (rows >= 0) & (rows <= max_osd) & upv[safe]

        if pool.pool_type == "erasure":
            up_tab = np.where(alive, rows, NO_OSD)
            up_tab = np.where(inlen, up_tab, NO_OSD)
            up_len = lens.astype(np.int32, copy=True)
        else:
            # replicated compaction: survivors left, stable order
            order = np.argsort(~alive, axis=1, kind="stable")
            up_tab = np.take_along_axis(
                np.where(alive, rows, NO_OSD), order, axis=1)
            up_len = alive.sum(axis=1).astype(np.int32)

        # sparse upmap fixups through the scalar pipeline
        for (pid, ps), _pairs in m.pg_upmap_items.items():
            if pid != pool_id or not (0 <= ps < pgn):
                continue
            row = m.raw_row_to_up(
                pool_id, ps, [int(o) for o in raw[ps, :int(lens[ps])]])
            up_tab[ps, :] = NO_OSD
            up_tab[ps, :len(row)] = row
            up_len[ps] = len(row)

        up_primary = _first_osd(up_tab)

        # acting = up unless pg_temp overrides (empty temp falls back)
        temps = [((pid, ps), v) for (pid, ps), v in m.pg_temp.items()
                 if pid == pool_id and 0 <= ps < pgn and v]
        act_w = max([width] + [len(v) for _, v in temps])
        if act_w > width:
            act_tab = np.full((pgn, act_w), NO_OSD, np.int32)
            act_tab[:, :width] = up_tab
        else:
            act_tab = up_tab.copy()
        act_len = up_len.copy()
        for (_, ps), v in temps:
            act_tab[ps, :] = NO_OSD
            act_tab[ps, :len(v)] = v
            act_len[ps] = len(v)
        act_primary = _first_osd(act_tab)
        for (pid, ps), o in m.primary_temp.items():
            if pid == pool_id and 0 <= ps < pgn:
                act_primary[ps] = o
        return PoolTables(pool_id, pgn, up_tab, up_len, up_primary,
                          act_tab, act_len, act_primary)


def _first_osd(tab: np.ndarray) -> np.ndarray:
    """First non-hole id per row, NO_OSD for all-hole rows — the
    vectorized primary selection."""
    has = tab != NO_OSD
    any_has = has.any(axis=1)
    first = np.argmax(has, axis=1)
    vals = tab[np.arange(tab.shape[0]), first]
    return np.where(any_has, vals, NO_OSD).astype(np.int32)
