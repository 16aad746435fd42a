"""Placement groups: per-PG state, peering, and recovery planning.

Counterpart of ceph_tpu/osd/pg.py: the same module over the
port's imports.

The role of reference src/osd/PG.{h,cc} + PeeringState.{h,cc}: each PG
tracks its interval (epoch + acting/up sets), runs peering on the primary
(Initial -> Peering -> Active, the boost::statechart machine of
PeeringState.h:556 collapsed to explicit async states), and computes what
needs recovery.

Peering is LOG-BASED (PGLog.h / pg_log_entry_t, osd_types.h:4038): every
acting member reports its retained log window; the authoritative log is
the one with the max (epoch, seq) head (the max-last-update choice of
PeeringState::find_best_info); per-peer missing sets are computed from
which entry seqs each peer has applied; peers whose own log carries
entries ABOVE the authoritative head or conflicting with it are divergent
and rewound (their touched objects re-recovered from authoritative
copies — the whole-object form of rollback, osd_types.h:4244
can_rollback_to). A peer whose log head predates the authoritative tail
no longer connects and falls back to BACKFILL: the full object-inventory
comparison (the log-recovery-vs-backfill split of
doc/dev/osd_internals/log_based_pg.rst).

Object -> PG mapping: ``ps = ceph_str_hash_rjenkins(name) % pg_num``
(reference pg_pool_t::hash / ceph_str_hash, src/common/ceph_hash.cc).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.osd.pg_log import (
    LogEntry,
    OP_DELETE,
    OP_MODIFY,
    head_of,
    latest_per_object,
)
from ceph_tpu_torch.placement.hashing import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd.osd_map import NO_OSD, PoolInfo

log = Dout("peering")


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """The reference's ceph_stable_mod (common/ceph_hash): modulo that
    is STABLE under pg_num growth — an object's ps either stays put or
    moves to exactly one child (ps + 2^k), never elsewhere.  This is
    what makes PG splitting a local parent->child partition."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def pg_num_mask(pg_num: int) -> int:
    return (1 << max(pg_num - 1, 0).bit_length()) - 1


def object_to_ps(name: str, pg_num: int) -> int:
    return ceph_stable_mod(ceph_str_hash_rjenkins(name), pg_num,
                           pg_num_mask(pg_num))


def split_parent(ps: int, old_pg_num: int) -> int:
    """The parent a child ps splits FROM under the stable-mod family:
    clear high bits until the ps existed at old_pg_num."""
    while ps >= old_pg_num:
        ps &= ~(1 << (ps.bit_length() - 1))
    return ps


@dataclass(frozen=True)
class PGId:
    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


# PG states (subset of the reference's state names)
STATE_INITIAL = "initial"
STATE_PEERING = "peering"
STATE_ACTIVE = "active"
STATE_RECOVERING = "active+recovering"
STATE_REPLICA = "replica"
STATE_INCOMPLETE = "incomplete"


@dataclass
class PeerInfo:
    """One shard's peering reply (the MOSDPGNotify info analog): its
    retained log window + tail; ``objects`` (full inventory) is only
    populated on the backfill path."""
    shard: int
    osd: int
    log: dict[int, LogEntry] = field(default_factory=dict)
    tail: int = 0
    objects: dict[str, int] | None = None   # name -> version (backfill)
    # EC shard collections the OSD actually HOLDS for this PG (None =
    # pre-upgrade peer that did not report).  One log per OSD per PG
    # means a member remapped to a different position presents a
    # complete log for a position it never stored — only collection
    # presence tells planned motion apart from an applied history.
    held: list[int] | None = None

    @property
    def head(self) -> tuple[int, int]:
        return head_of(self.log)


@dataclass
class MissingSet:
    """Recovery plan for one interval (the PeeringState missing-sets +
    MissingLoc outcome)."""
    # shard -> {oid: authoritative LogEntry} to recover on that shard
    by_shard: dict[int, dict[str, LogEntry]] = field(default_factory=dict)
    # oid -> shards that hold the current version (recovery sources)
    sources: dict[str, set[int]] = field(default_factory=dict)
    # shards that need full-inventory backfill instead of log recovery
    backfill: set[int] = field(default_factory=set)
    # the AUTHORITATIVE history this interval converges to (for EC,
    # already filtered to reconstructable entries) — the activation
    # merge window must be exactly this, so a rewound entry is removed
    # from every member's log rather than re-adopted
    auth_log: dict[int, LogEntry] = field(default_factory=dict)
    auth_tail: int = 0

    def total(self) -> int:
        return sum(len(v) for v in self.by_shard.values())


class PG:
    def __init__(self, pgid: PGId, pool: PoolInfo, whoami: int):
        self.pgid = pgid
        self.pool = pool
        self.whoami = whoami
        self.state = STATE_INITIAL
        self.epoch = 0                  # interval start epoch
        self.acting: list[int] = []
        self.up: list[int] = []
        self.primary = NO_OSD
        self.waiting_for_active: list = []   # queued client ops
        self.peer_infos: dict[int, PeerInfo] = {}   # shard -> info
        # osd -> PeerInfo announced by a NON-acting holder of this PG
        # (a stray after a wholesale remap); consulted by peering as
        # an extra authoritative-log/recovery source
        self.stray_sources: dict[int, PeerInfo] = {}
        self.missing = MissingSet()
        self.peering_task: asyncio.Task | None = None
        self.snaptrim_task: asyncio.Task | None = None
        self.snaptrim_again = False
        self.last_scrub: dict | None = None
        self.backend = None             # set by the daemon per interval
        self.ec_k = 0                   # EC data-chunk count (0 = replicated)
        self.log_seq = 0                # next entry seq (primary allocates)
        self.appended_since_trim = 0
        # reqid -> (seq, obj_version): answers client replays from
        # history (rebuilt from the merged log at activation, so it
        # survives primary failover)
        self.reqid_index: dict[str, tuple[int, int]] = {}
        # reqid -> (oid, obj_version) allocated THIS interval but not
        # (yet) fully committed: a same-interval resend must settle the
        # first attempt (heal its shard gaps) instead of re-executing
        self.attempted_reqids: dict[str, tuple[str, int]] = {}
        # serializes log maintenance (activation merge vs trim) so their
        # read-modify-write cycles cannot interleave and regress the tail
        self.log_lock = DLock("pg-log")
        # per-object op locks: replicated-pool mutations, the snap
        # trimmer, and scrub read object state, build a transaction, and
        # await replication — interleaving two such cycles on one OBJECT
        # loses updates (version bumps, SnapSet edits). Object-granular
        # (not PG-wide) so a scrub's network round-trips never stall
        # client IO to other objects.
        self._obj_locks: dict[str, tuple[asyncio.Lock, int]] = {}

    # -- interval handling -------------------------------------------------
    @property
    def is_primary(self) -> bool:
        return self.primary == self.whoami

    @property
    def is_ec(self) -> bool:
        return self.pool.pool_type == "erasure"

    def acting_shard_of(self, osd: int) -> int:
        """Shard index this osd holds (EC: positional; replicated: rank)."""
        return self.acting.index(osd)

    def same_interval(self, acting: list[int], up: list[int],
                      primary: int) -> bool:
        return (acting == self.acting and up == self.up
                and primary == self.primary)

    def start_interval(self, epoch: int, acting: list[int], up: list[int],
                       primary: int) -> None:
        """New interval (PeeringState::start_peering_interval,
        reference PeeringState.cc:547): reset peering state."""
        self.epoch = epoch
        self.acting = list(acting)
        self.up = list(up)
        self.primary = primary
        self.peer_infos = {}
        self.missing = MissingSet()
        # attempted (allocated, possibly partially committed) reqids are
        # interval-scoped: across an interval change the merged pg log
        # is the only truth about what survived
        self.attempted_reqids = {}
        if self.peering_task is not None:
            self.peering_task.cancel()
            self.peering_task = None
        self.state = (STATE_PEERING if self.is_primary else STATE_REPLICA)
        log.dout(10, "pg %s interval e%d acting %s primary %d role %s",
                 self.pgid, epoch, acting, primary,
                 "primary" if self.is_primary else "replica")

    def obj_lock(self, name: str):
        """Refcounted per-object mutation lock (guard form)."""
        pg = self

        class _Guard:
            @staticmethod
            def _unref():
                lock, refs = pg._obj_locks[name]
                if refs <= 1:
                    del pg._obj_locks[name]
                else:
                    pg._obj_locks[name] = (lock, refs - 1)

            async def __aenter__(self):
                lock, refs = pg._obj_locks.get(name, (asyncio.Lock(), 0))
                pg._obj_locks[name] = (lock, refs + 1)
                self._lock = lock
                try:
                    await lock.acquire()
                except BaseException:
                    # cancelled while waiting: drop our refcount or the
                    # table entry leaks forever
                    self._unref()
                    raise
                return lock

            async def __aexit__(self, *exc):
                self._lock.release()
                self._unref()
                return False

        return _Guard()

    # -- log bookkeeping ----------------------------------------------------
    def next_entry(self, epoch: int, oid: str, op: str, obj_version: int,
                   prior_version: int = 0, reqid: str = "") -> LogEntry:
        """Primary-side seq allocation for a new mutation's log entry.
        NOTE: allocation does NOT register the reqid for replay dedup —
        only a fully-acked commit may (register_reqid); an op that fails
        after allocation must be re-executable, not falsely acked from
        history."""
        self.log_seq += 1
        self.appended_since_trim += 1
        if reqid:
            self.attempted_reqids[reqid] = (oid, obj_version)
            if len(self.attempted_reqids) > 8192:
                self.attempted_reqids.clear()   # interval-scoped scratch
        return LogEntry(self.log_seq, epoch, oid, op, obj_version,
                        prior_version, reqid)

    def register_reqid(self, reqid: str, seq: int,
                       obj_version: int) -> None:
        """Record a COMMITTED mutation for replay dedup."""
        self.reqid_index[reqid] = (seq, obj_version)
        if len(self.reqid_index) > 4096:
            # bounded like the log itself: a replay older than the
            # retained window re-executes (reference has the same
            # log-length dedup horizon)
            for rid in sorted(self.reqid_index,
                              key=lambda r: self.reqid_index[r][0]
                              )[:1024]:
                del self.reqid_index[rid]

    def rebuild_reqid_index(self, entries: dict[int, LogEntry]) -> None:
        # seq order so a reqid appearing on several entries (e.g. a
        # writefull's remove+write pair) resolves to the final one
        self.reqid_index = {
            entries[s].reqid: (s, entries[s].obj_version)
            for s in sorted(entries) if entries[s].reqid
        }

    # -- peering bookkeeping (primary) -------------------------------------
    STRAY_SHARD_BASE = -100     # virtual shard ids for stray sources

    @classmethod
    def stray_shard(cls, osd: int) -> int:
        return cls.STRAY_SHARD_BASE - osd

    def shard_osd(self, shard: int) -> int:
        """Resolve a shard id (acting position OR stray virtual id) to
        its OSD."""
        if 0 <= shard < len(self.acting):
            return self.acting[shard]
        if shard <= self.STRAY_SHARD_BASE:
            return self.STRAY_SHARD_BASE - shard
        return NO_OSD

    def query_peers(self) -> list[tuple[int, int]]:
        """(shard, osd) pairs peering may query: acting members plus
        announced stray holders (reference: prior-set members)."""
        return self.acting_peers() + [
            (info.shard, info.osd)
            for info in self.stray_sources.values()
        ]

    def acting_peers(self) -> list[tuple[int, int]]:
        """(shard, osd) pairs for every live acting member but us."""
        return [
            (shard, osd) for shard, osd in enumerate(self.acting)
            if osd != NO_OSD and osd != self.whoami
        ]

    def record_info(self, info: PeerInfo) -> None:
        self.peer_infos[info.shard] = info

    def all_infos_in(self) -> bool:
        want = {shard for shard, _ in self.acting_peers()}
        return want <= set(self.peer_infos)

    def authoritative_log(self) -> tuple[int, dict[int, LogEntry], int]:
        """(shard, entries, tail) of the authoritative log: the max
        (epoch, seq) head wins — across a primary failover the entries a
        dead primary logged but never committed to min_size carry an
        OLDER epoch than the new interval's writes, so the live branch
        wins and the stale branch is rewound (find_best_info role)."""
        best_shard, best_head = -1, (-1, -1)
        for shard, info in self.peer_infos.items():
            if info.head > best_head:
                best_head = info.head
                best_shard = shard
        info = self.peer_infos[best_shard]
        return best_shard, info.log, info.tail

    def compute_missing(self) -> MissingSet:
        """Set arithmetic over log windows (O(retained entries), never
        O(objects)): for each acting shard, the authoritative entries it
        has not applied are its missing set; entries it applied that the
        authoritative log does not contain are divergent and rewound.
        Shards whose head predates the authoritative tail get backfill."""
        _, auth_log, auth_tail = self.authoritative_log()
        ms = MissingSet()

        def applied(info: PeerInfo, entry: LogEntry) -> bool:
            """A peer applied an entry if it retains it (same seq AND
            epoch — a dead branch may have reused the seq in an older
            epoch) or already trimmed past it (trim only advances over
            applied entries)."""
            mine = info.log.get(entry.seq)
            if mine is not None:
                return mine.epoch == entry.epoch
            return entry.seq <= info.tail

        if self.ec_k:
            # EC reconstructability filter (the can_rollback_to /
            # min-last-update role of the reference's EC peering): a
            # mutation applied by fewer than k shards cannot be read
            # back — keeping it authoritative would leave the object
            # permanently unreadable. Such an entry was never acked
            # (strict commit needs every live shard), so rewinding it to
            # the prior state is safe, and dropping it from the
            # authoritative window makes the activation merge REMOVE it
            # from the shards that did apply it.
            auth_log = dict(auth_log)
            for seq in sorted(auth_log, reverse=True):
                e = auth_log[seq]
                if e.op == OP_DELETE:
                    continue            # deletes need no reconstruction
                appliers = sum(
                    1 for info in self.peer_infos.values()
                    if applied(info, e)
                )
                if appliers < self.ec_k:
                    del auth_log[seq]
        auth_latest = latest_per_object(auth_log)
        # post-split logs are full parent COPIES: entries for objects
        # that hash to a sibling PG are inert history, not missing
        # data — recovering them here would pull objects this PG does
        # not own (loud, wasted rounds while members process the new
        # map at different times)
        auth_latest = {
            oid: e for oid, e in auth_latest.items()
            if object_to_ps(oid, self.pool.pg_num) == self.pgid.ps
        }
        ms.auth_log = auth_log
        ms.auth_tail = auth_tail

        # recovery sources: shards holding the current state of an oid
        # (delete entries included — a delete can leave a whiteout whose
        # SnapSet and clones must still be recoverable)
        for oid, entry in auth_latest.items():
            ms.sources[oid] = {
                shard for shard, info in self.peer_infos.items()
                if applied(info, entry)
            }

        for shard, osd in enumerate(self.acting):
            if osd == NO_OSD:
                continue
            info = self.peer_infos.get(shard)
            if info is None:
                ms.backfill.add(shard)
                continue
            if info.head[1] < auth_tail:
                # log gap: entries this peer missed were trimmed away —
                # only a full inventory comparison can find its holes
                ms.backfill.add(shard)
                continue
            if info.head == (0, 0) and not info.log and auth_latest:
                # brand-new member (remapped in with no history at
                # all): this is PLANNED MOTION, not failure repair —
                # inventory comparison (the backfill path) moves the
                # data, paced and reserved as the backfill class,
                # instead of replaying the entire authoritative log
                # entry by entry as if redundancy had been lost
                ms.backfill.add(shard)
                continue
            if self.ec_k and info.held is not None \
                    and shard not in info.held and auth_latest:
                # position permutation: the OSD stayed in the acting
                # set but at a DIFFERENT EC position.  Its (per-OSD)
                # log claims every entry applied, yet the collection
                # for the new position was never written — the shard
                # is a backfill destination, and the data still sits
                # fully redundant in the old-position collections.
                ms.backfill.add(shard)
                continue
            need: dict[str, LogEntry] = {}
            for oid, entry in auth_latest.items():
                if not applied(info, entry):
                    need[oid] = entry
            # divergent: applied entries the authoritative branch lacks
            # (never client-acked — commit requires every live acting
            # member, so an entry absent from the max-head log reached
            # no one the client heard from). Rewind to the prior state.
            for seq, entry in info.log.items():
                auth_e = auth_log.get(seq)
                if (auth_e is not None
                        and auth_e.epoch == entry.epoch) or \
                        seq <= auth_tail:
                    continue
                if entry.oid in need:
                    continue
                auth_e = auth_latest.get(entry.oid)
                if auth_e is not None:
                    need[entry.oid] = auth_e
                elif entry.prior_version == 0:
                    # object born in the divergent branch: remove it
                    need[entry.oid] = LogEntry(0, 0, entry.oid,
                                               OP_DELETE, 0)
                else:
                    # recover the pre-divergence object from any shard
                    # that never saw the divergent write
                    need[entry.oid] = LogEntry(0, 0, entry.oid, OP_MODIFY,
                                               entry.prior_version)
                    ms.sources.setdefault(entry.oid, set()).update(
                        s for s, i2 in self.peer_infos.items()
                        if not applied(i2, entry)
                    )
            if need:
                ms.by_shard[shard] = need
        self.missing = ms
        return ms
