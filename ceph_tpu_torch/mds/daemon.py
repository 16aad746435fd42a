"""MDS-lite: the CephFS metadata server on RADOS objects.

Counterpart of ceph_tpu/mds/daemon.py: the same module over the
port's imports.

The essentials of reference src/mds (MDSRank.h:133, MDCache.cc,
Server.cc, MDLog.h:61) at -lite scale:

- The file NAMESPACE lives in RADOS omaps: directory inode ino has a
  dirfrag object ``<ino:x>.dir`` in the metadata pool whose omap maps
  child name -> dentry. Inodes are EMBEDDED in their primary dentry
  (the reference's primary-link inode embedding): type, mode, size,
  mtime, layout.
- Every metadata mutation is JOURNALED first (MDLog/LogEvent role): one
  frame appended to the ``mds_journal`` object, then applied to the
  dirfrag omaps. Replay on startup re-applies whatever a crash left
  unapplied (entries are idempotent); the journal is compacted once
  everything is known applied, persisting the ino allocator watermark
  (InoTable role).
- Clients send metadata requests over the messenger (Server.cc
  handle_client_request); FILE DATA never passes through the MDS —
  clients stripe it straight to the data pool (the defining CephFS
  property). Lookup/readdir replies carry a lease TTL (the caps/lease
  model reduced to read-caching: mutations are always MDS round-trips).

File data layout (client side, reference file layout semantics):
``<ino:x>.<blockno:08x>`` objects of ``block_size`` bytes.
"""

from __future__ import annotations

import asyncio
import secrets
import struct
import time

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, Rados, RadosError
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy

log = Dout("mds")

ROOT_INO = 1
JOURNAL_OID = "mds_journal"
TABLE_OID = "mds_inotable"
ANCHOR_OID = "mds_anchortab"
SUBTREE_OID = "mds_subtree_map"
# Cross-rank rename commit records (witness-lite slave-commit log):
# omap keys "commit:<token>" / "abort:<token>" (token = per-attempt
# random hex) on one shared object, mutated ONLY through the atomic
# cls rename_wal methods (services/cls.py) so the commit/abort race
# has a single winner.  The DESTINATION claims "commit" in the same
# apply that links the dentry; the SOURCE claims "abort" when
# resolving an ambiguous timeout.  The marker — not the destination
# dirfrag's current state — is what timeout resolution and replay
# repair key off: a dst dentry later unlinked or renamed away must
# still count as COMMITTED.
RENAME_LOG_OID = "mds_rename_log"
ECANCELED = -125
_FRAME = struct.Struct("<I")
# rank r allocates inos from r * RANK_INO_BASE (per-rank InoTable
# partitions; reference preallocates per-rank ino ranges)
RANK_INO_BASE = 1 << 40
EBUSY = -16
EXDEV = -18
EDQUOT = -122
EREMOTE_RANK = -66          # client retries at reply["redirect_rank"]

# errno-style codes shared with the client
ENOENT = -2
EEXIST = -17
ENOTDIR = -20
EISDIR = -21
ENOTEMPTY = -39
ELOOP = -40
EINVAL = -22
EPERM = -1
EROFS = -30


def dirfrag_oid(ino: int) -> str:
    return f"{ino:x}.dir"


def snap_dirfrag_oid(ino: int, snapid: int) -> str:
    return f"{ino:x}.dir.snap.{snapid}"


# -- directory fragmentation (reference CDir::split/merge CDir.cc:994,
# 1096 and MDCache::adjust_dir_fragments MDCache.cc:11187) --------------
# Dentries are partitioned over FRAGMENTS of the 32-bit rjenkins hash
# space (the reference hashes dentry names with ceph_str_hash for the
# same purpose).  The fragtree — the leaf list of (bits, value) pairs,
# where a leaf covers names whose hash's top `bits` bits equal `value`
# — rides a "fragtree" xattr on the BASE dirfrag object <ino>.dir.  The
# base object always exists for a live directory and keeps the metadata
# xattrs (parent, past_snaps); with the trivial tree [(0, 0)] it also
# holds the dentries (the unfragmented layout every pre-frag test and
# tool knows).  A split moves entries into <ino>.dir.<bits>_<value:x>
# sibling objects; snapshot COW copies stay single-object (frozen views
# are read-only, so one omap is the simpler correct layout).  Splits
# and merges are journaled ("fragment" entries) and idempotent under
# crash replay.

ROOT_FRAG = (0, 0)
MAX_FRAG_BITS = 8


def frag_oid(ino: int, bits: int, value: int) -> str:
    if bits == 0:
        return dirfrag_oid(ino)
    return f"{ino:x}.dir.{bits}_{value:x}"


def frag_contains(bits: int, value: int, h: int) -> bool:
    return bits == 0 or (h >> (32 - bits)) == value


def frag_for(tree: list[tuple[int, int]], name: str) -> tuple[int, int]:
    """The fragtree leaf covering ``name`` (fragtree_t::operator[])."""
    from ceph_tpu_torch.placement.hashing import ceph_str_hash_rjenkins

    h = ceph_str_hash_rjenkins(name)
    for b, v in tree:
        if frag_contains(b, v, h):
            return (b, v)
    return ROOT_FRAG        # malformed tree: base object fallback


async def fragtree_of(meta, dino: int) -> list[tuple[int, int]]:
    """Read a directory's fragtree (trivial when the xattr or the base
    object is absent — the OSD returns ENOENT for both).  Any other
    error propagates: silently defaulting on e.g. EIO would route a
    write into the base object of a fragmented directory, where no
    lookup would ever find it again.  Module-level so offline tools
    (cephfs-data-scan) share the exact routing the daemon uses."""
    try:
        raw = await meta.get_xattr(dirfrag_oid(dino), "fragtree")
    except RadosError as e:
        if e.rc != ENOENT:
            raise
        return [ROOT_FRAG]
    try:
        tree = [(int(b), int(v)) for b, v in decode(raw)]
        return tree or [ROOT_FRAG]
    except (ValueError, TypeError):
        return [ROOT_FRAG]


async def frag_oid_for_name(meta, dino: int, name: str) -> str:
    """The object holding (or destined to hold) ``name``'s dentry.
    (For the trivial tree frag_for returns ROOT_FRAG and frag_oid maps
    it to the base object — no special case needed.)"""
    tree = await fragtree_of(meta, dino)
    return frag_oid(dino, *frag_for(tree, name))


SNAPTABLE_OID = "mds_snaptable"
QUOTATABLE_OID = "mds_quotatab"


def block_oid(ino: int, blockno: int) -> str:
    return f"{ino:x}.{blockno:08x}"


def backtrace_oid(ino: int) -> str:
    """Per-file backtrace object in the DATA pool (the reference
    stores backtrace xattrs on object 0; a sidecar here keeps
    'block 0 absent' meaning 'no data flushed yet')."""
    return f"{ino:x}.bt"


class MDSError(Exception):
    def __init__(self, rc: int, msg: str = "",
                 missing_dentry: bool = False,
                 redirect_rank: int | None = None):
        super().__init__(f"rc={rc} {msg}")
        self.rc = rc
        # distinguishes "the NAME is absent in an existing directory"
        # (create may proceed) from "the directory itself is absent"
        self.missing_dentry = missing_dentry
        # EREMOTE_RANK: the rank the client should retry at
        self.redirect_rank = redirect_rank


def _dentry(ino: int, dtype: str, mode: int, size: int = 0) -> dict:
    now = time.time()
    return {"ino": ino, "type": dtype, "mode": mode, "size": size,
            "mtime": now, "ctime": now}


class MDSDaemon:
    def __init__(self, name: str, monmap: dict[str, str],
                 conf: ConfigProxy | None = None,
                 addr: str | None = None,
                 meta_pool: str = "cephfs_meta",
                 data_pool: str = "cephfs_data",
                 block_size: int = 1 << 22,
                 fs_name: str = "cephfs"):
        self.name = name
        self.entity = f"mds.{name}"
        self.fs_name = fs_name
        self._beacon_task = None
        self._last_state: str | None = None
        self._rados_dispatch = None
        self.conf = conf or ConfigProxy()
        self.addr = addr or f"local://{self.entity}"
        self.meta_pool = meta_pool
        self.data_pool = data_pool
        self.block_size = block_size
        # the MDS is itself a RADOS client of the metadata/data pools
        self.rados = Rados(monmap, self.conf, name=f"client.{self.entity}")
        self.meta: IoCtx | None = None
        self.data: IoCtx | None = None
        self.msgr = Messenger(self.entity, self.conf)
        self.msgr.set_policy("client", Policy.stateless_server())
        self.msgr.set_dispatcher(self)
        self.next_ino = ROOT_INO + 1
        self.journal_len = 0
        self._mutate = DLock("mds-mutate")  # per-rank serialization
        self.lease_ttl = 2.0
        # multi-active: this daemon's rank (assigned by the MDSMonitor)
        # and the subtree delegation map (dir ino -> authoritative rank;
        # the Migrator/subtree-auth role, reference Migrator.h:50)
        self.rank = 0
        self._subtrees: dict[int, int] = {}
        self._auth_cache: dict[int, int] = {}  # dir ino -> auth rank
        self._subtrees_loaded = 0.0            # refresh throttle stamp
        # rank-to-rank requests (cross-rank rename import): this MDS
        # acts as a CLIENT of the peer rank over the same wire ops
        self._peer_pending: dict[int, "asyncio.Future"] = {}
        self._peer_tid = 0
        # open cross-rank rename intents (token -> intent entry):
        # survive journal compaction, resolved by replay repair
        self._open_intents: dict[str, dict] = {}
        # (parent, name) pairs pinned by an in-flight cross-rank
        # rename (mutations on them get EBUSY — the xlock role)
        self._busy_names: set[tuple[int, str]] = set()
        # directory quotas (reference client/mds vxattr quotas,
        # quota.h quota_info_t): dir ino -> {max_bytes, max_files};
        # usage is accounted lazily per quota root (first enforcement
        # walks the subtree once, then increments ride each op — the
        # rstat propagation role, without the per-ancestor journaling)
        self.quotas: dict[int, dict] = {}
        self._qusage: dict[int, dict] = {}
        # file write caps (Locker.cc/Capability.h reduced to the
        # -lite slice: ONE exclusive buffered-write cap per file ino,
        # granted at open, recalled when anyone else opens the file).
        # Volatile by design — an MDS restart drops grants, like the
        # reference before client reconnect replays them.
        # client sessions (SessionMap role): stable sid -> info; fed
        # by session opens, trimmed on reset, listable/evictable via
        # the admin socket.  Monotonic ids — id(conn) values recycle
        # after GC and a stale sid could evict the wrong client
        self._sessions: dict[int, dict] = {}
        self._next_sid = 0
        self._caps: dict[int, dict] = {}       # ino -> {conn, holder}
        self._cap_waiters: dict[int, list] = {}   # ino -> [futures]
        # forward-scrub damage table (DamageTable.h role): findings
        # survive until explicitly acked (damage rm)
        self._damage: list[dict] = []
        self._damage_seq = 0
        # balancer (MDBalancer.h:33 role): decaying per-directory
        # request popularity (DecayCounter semantics, one shared
        # lazy-decay stamp for the whole map)
        self._pop: dict[int, float] = {}
        self._pop_stamp = time.monotonic()
        self._balance_task = None
        # per-frag entry counts ((ino, bits, value) -> n): lazily
        # initialized, incrementally maintained, drive split/merge
        # (the CDir::fnode fragstat role)
        self._frag_counts: dict[tuple[int, int, int], int] = {}
        # per-ino fragtree cache (CInode dirfragtree role); cleared
        # with _auth_cache and on local split/merge/removal
        self._ftree_cache: dict[int, list[tuple[int, int]]] = {}

    # -- lifecycle ---------------------------------------------------------
    async def start(self, timeout: float = 20.0) -> None:
        fp.apply_conf(self.conf)
        await self.rados.connect(timeout)
        self.meta = await self.rados.open_ioctx(self.meta_pool)
        self.data = await self.rados.open_ioctx(self.data_pool)
        self.snaps: dict[int, dict] = {}
        await self._load_snaptable()
        await self._load_quotatable()
        await self._load_subtrees()
        await self._load_table()
        await self._replay_journal()
        # ensure the root dirfrag exists
        try:
            await self.meta.operate(dirfrag_oid(ROOT_INO),
                                    ObjectOperation().create())
        except RadosError as e:
            if e.rc != EEXIST:
                raise
        await self.msgr.bind(self.addr)
        # intercept beacon acks on the rados mon session (chained
        # dispatcher, the CephFS-client pattern)
        self._rados_dispatch = self.rados.ms_dispatch
        self.rados.msgr.set_dispatcher(self)
        self._beacon_task = asyncio.create_task(self._beacon_loop())
        if self.conf["mds_bal_interval"] > 0:
            self._balance_task = asyncio.create_task(
                self._balance_loop())
        run_dir = self.conf["admin_socket_dir"]
        if run_dir:
            from ceph_tpu_torch.common.admin_socket import AdminSocket

            sock = AdminSocket(self.entity)
            sock.register("status", lambda: {
                "entity": self.entity, "fs": self.fs_name,
                "state": self._last_state or "booting",
                "next_ino": self.next_ino,
                "journal_len": self.journal_len,
            }, "mds state")
            sock.register("config show", self.conf.show,
                          "live configuration")
            sock.register("session ls", self.session_ls,
                          "live client sessions + cap counts")
            sock.register("session evict", self.session_evict,
                          "session evict <id>: revoke caps + close")
            sock.register("scrub start", self.scrub_start,
                          "forward scrub: walk + validate metadata "
                          "(repair=true fixes what it can)")
            sock.register("damage ls", self.damage_ls,
                          "damage table entries")
            sock.register("damage rm", self.damage_rm,
                          "damage rm <id>: ack one entry")
            from ceph_tpu_torch.common.log import recent_lines
            sock.register("log dump", recent_lines,
                          "recent log ring (crash context)")
            fp.register_admin_commands(sock)
            await sock.start(run_dir)
            self.admin_socket = sock
        else:
            self.admin_socket = None
        log.dout(1, "%s: up at %s (meta=%s data=%s)", self.entity,
                 self.msgr.my_addr, self.meta_pool, self.data_pool)

    async def _beacon_loop(self) -> None:
        """MMDSBeacon: announce (name, addr, fs) to the monitor so the
        FSMap tracks this daemon and clients can discover the active
        MDS (reference Beacon.cc)."""
        interval = self.conf["mds_beacon_interval"]
        while True:
            conn = self.rados.monc.conn
            if conn is not None and not conn.is_closed:
                try:
                    conn.send_message(Message("mds_beacon", {
                        "name": self.name,
                        "addr": str(self.msgr.my_addr),
                        "fs": self.fs_name,
                        "load": round(self.my_load(), 3),
                    }))
                except ConnectionError:
                    pass
            await asyncio.sleep(interval)

    async def shutdown(self) -> None:
        if getattr(self, "admin_socket", None) is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        if self._beacon_task is not None:
            self._beacon_task.cancel()
            self._beacon_task = None
        if self._balance_task is not None:
            self._balance_task.cancel()
            self._balance_task = None
        async with self._mutate:
            await self._compact_journal()
        await self.rados.shutdown()
        await self.msgr.shutdown()

    # -- journal (MDLog) ---------------------------------------------------
    async def _load_snaptable(self) -> None:
        try:
            omap = await self.meta.get_omap(SNAPTABLE_OID)
        except RadosError as e:
            if e.rc != ENOENT:
                raise
            omap = {}
        self.snaps = {int(k): decode(v) for k, v in omap.items()}
        self._apply_snapc()

    async def _load_quotatable(self) -> None:
        try:
            omap = await self.meta.get_omap(QUOTATABLE_OID)
        except RadosError as e:
            if e.rc != ENOENT:
                raise
            omap = {}
        new = {int(k): decode(v) for k, v in omap.items()}
        if new != self.quotas:
            self.quotas = new
            self._qusage.clear()

    def _apply_snapc(self) -> None:
        """Keep the MDS's own data-pool writes (purges) COW-correct
        under the live snap set."""
        ids = sorted(self.snaps)
        self.data.set_snap_context(max(ids, default=0), ids)

    def _snapc_wire(self) -> dict:
        ids = sorted(self.snaps)
        return {"seq": max(ids, default=0), "snaps": ids}

    @property
    def _journal_oid(self) -> str:
        # per-rank journals: two actives must never interleave frames
        # or compact each other's unapplied entries
        return (JOURNAL_OID if self.rank == 0
                else f"{JOURNAL_OID}.{self.rank}")

    @property
    def _table_key(self) -> str:
        return ("next_ino" if self.rank == 0
                else f"next_ino.{self.rank}")

    def _ino_floor(self) -> int:
        return (ROOT_INO + 1 if self.rank == 0
                else self.rank * RANK_INO_BASE + 1)

    async def _load_table(self) -> None:
        self.next_ino = self._ino_floor()
        try:
            raw = await self.meta.get_xattr(TABLE_OID, self._table_key)
            self.next_ino = max(self.next_ino, int(raw))
        except RadosError as e:
            if e.rc != ENOENT:
                raise

    async def _load_subtrees(self) -> None:
        try:
            omap = await self.meta.get_omap(SUBTREE_OID)
        except RadosError as e:
            if e.rc != ENOENT:
                raise
            omap = {}
        self._subtrees = {int(k): int(v) for k, v in omap.items()}
        self._auth_cache.clear()
        self._ftree_cache.clear()
        self._subtrees_loaded = time.monotonic()
        # quota knowledge rides the same refresh cadence: a rank that
        # just imported a realm root must enforce its quota
        await self._load_quotatable()

    async def _replay_journal(self) -> None:
        """Re-apply journaled mutations a crash may have left unapplied
        (idempotent omap writes; MDLog replay role)."""
        try:
            raw = await self.meta.read(self._journal_oid)
        except RadosError as e:
            if e.rc == ENOENT:
                return
            raise
        pos = 0
        entries = []
        while pos + _FRAME.size <= len(raw):
            (n,) = _FRAME.unpack_from(raw, pos)
            pos += _FRAME.size
            if pos + n > len(raw):
                break                    # torn tail
            try:
                entries.append(decode(raw[pos:pos + n]))
            except (ValueError, TypeError):
                break
            pos += n
        lo = self._ino_floor()
        hi = (self.rank + 1) * RANK_INO_BASE if self.rank \
            else RANK_INO_BASE
        for e in entries:
            ino = int(e.get("ino", 0))
            # only inos from OUR partition move the watermark: a journal
            # entry touching a foreign rank's inode (e.g. an unlink
            # after an export round trip) must not teleport this rank's
            # allocator into that partition (duplicate ino allocation)
            if lo <= ino < hi and ino >= self.next_ino:
                self.next_ino = ino + 1
            try:
                await self._apply(e)
            except (RadosError, MDSError) as err:
                log.derr("%s: journal replay of %s failed: %s",
                         self.entity, e.get("op"), err)
        # dangling cross-rank rename intents are only COLLECTED here;
        # resolution waits for _resync (post rank assignment) — a
        # freshly booting daemon replays with the DEFAULT rank and
        # must not abort a live rank's in-flight renames
        self._open_intents = {}
        for e in entries:
            op = e.get("op")
            token = str(e.get("token", ""))
            if op in ("rename_export_intent", "link_export_intent",
                      "unlink_remote_intent",
                      "promote_export_intent", "repoint_intent"):
                self._open_intents[token] = e
            elif op in ("rename_export_finish",
                        "rename_export_abort",
                        "link_export_finish", "link_export_abort",
                        "unlink_remote_finish",
                        "unlink_remote_abort",
                        "promote_export_finish",
                        "promote_export_abort",
                        "repoint_finish", "repoint_abort"):
                self._open_intents.pop(token, None)
        if entries:
            await self._compact_journal()

    async def _repair_rename_intents(self) -> None:
        """Resolve dangling cross-rank rename intents (run from
        _resync, once THIS daemon's rank assignment is known): the
        atomic COMMIT MARKER decides — not the destination dirfrag's
        current state, which later unlinks/renames at the still-live
        destination rank could flip.  Committed: complete the source
        unlink.  Not committed: the abort-unless-committed claim wins
        the race against a still-queued import, roll back."""
        import json as _json

        for token, e in list(self._open_intents.items()):
            op = str(e.get("op"))
            ino = int(e.get("ino", 0))
            committed = await self._rename_resolve_abort(token)
            if not committed:
                abort_op = {"rename_export_intent":
                            "rename_export_abort",
                            "link_export_intent": "link_export_abort",
                            "unlink_remote_intent":
                            "unlink_remote_abort",
                            "promote_export_intent":
                            "promote_export_abort",
                            "repoint_intent": "repoint_abort"}[op]
                await self._journal({"op": abort_op, "ino": ino,
                                     **{k: e[k] for k in
                                        ("src_parent", "src_name")
                                        if k in e},
                                     "token": token})
                continue
            if op == "rename_export_intent":
                fin = {"op": "rename_export_finish",
                       "src_parent": int(e["src_parent"]),
                       "src_name": str(e["src_name"]), "ino": ino,
                       "token": token}
            elif op == "link_export_intent":
                # the destination materialized the remote name before
                # the crash: rebuild the finish from CURRENT primary
                # state (it was never incremented — the finish is what
                # increments, and a journaled finish clears the intent)
                pp, pn = int(e["pp"]), str(e["pn"])
                primary = dict(await self._get_dentry(pp, pn))
                primary["nlink"] = int(primary.get("nlink", 1)) + 1
                rec = await self._anchor_get(ino)
                base = rec or {"primary": [pp, pn], "remotes": []}
                fin = {"op": "link_export_finish", "pp": pp, "pn": pn,
                       "ino": ino, "primary_dentry": primary,
                       "anchor": await self._anchor_next(ino, {
                           "primary": base["primary"],
                           "remotes": list(base["remotes"])
                           + [[int(e["parent"]),
                               str(e["name"])]]}),
                       "token": token}
            elif op == "promote_export_intent":
                # the remote's rank adopted the primary before the
                # crash: drop our old primary NAME (never the data)
                fin = {"op": "promote_export_finish",
                       "parent": int(e["parent"]),
                       "name": str(e["name"]), "ino": ino,
                       "token": token}
            elif op == "repoint_intent":
                # the primary's rank repointed the anchor before the
                # crash: complete the name move
                fin = {"op": "repoint_finish",
                       "src_parent": int(e["src_parent"]),
                       "src_name": str(e["src_name"]),
                       "dst_parent": int(e["dst_parent"]),
                       "dst_name": str(e["dst_name"]), "ino": ino,
                       "dentry": dict(e["dentry"]), "token": token,
                       "pre": e.get("pre"),
                       "purge_ino": int(e.get("purge_ino", 0)),
                       "purge_size": int(e.get("purge_size", 0))}
            else:                       # unlink_remote_intent
                fin = {"op": "unlink_remote_finish",
                       "parent": int(e["parent"]),
                       "name": str(e["name"]), "ino": ino,
                       "token": token}
            await self._journal(fin)
            await self._apply(fin)
            await self._rename_clear(token)
            log.dout(1, "%s: completed dangling %s (token %s)",
                     self.entity, op, token)
        # sweep long-dead markers (aborts whose import never arrived,
        # commits re-created by a destination replay)
        try:
            await self.meta.exec(
                RENAME_LOG_OID, "rename_wal", "gc",
                _json.dumps({"max_age": 3600.0}).encode())
        except RadosError:
            pass

    async def _journal(self, entry: dict) -> None:
        if fp.ACTIVE:
            await fp.fire("mds.journal_flush")
        payload = encode(entry)
        await self.meta.append(self._journal_oid,
                               _FRAME.pack(len(payload)) + payload)
        self.journal_len += 1
        op = entry.get("op")
        if op in ("rename_export_intent", "link_export_intent",
                  "unlink_remote_intent", "promote_export_intent",
                  "repoint_intent"):
            self._open_intents[str(entry.get("token", ""))] = entry
        elif op in ("rename_export_finish", "rename_export_abort",
                    "link_export_finish", "link_export_abort",
                    "unlink_remote_finish", "unlink_remote_abort",
                    "promote_export_finish", "promote_export_abort",
                    "repoint_finish", "repoint_abort"):
            self._open_intents.pop(str(entry.get("token", "")), None)

    async def _maybe_compact(self) -> None:
        """Roll the journal when it has grown past the apply window
        (every mutation is applied synchronously, so anything beyond
        open intents is dead weight)."""
        if self.journal_len >= 256:
            await self._compact_journal()

    async def _compact_journal(self) -> None:
        """Everything is applied synchronously under the mutate lock, so
        compaction persists the ino watermark and resets the log (the
        journal-expire + InoTable save) — EXCEPT open cross-rank rename
        intents, which are rewritten into the fresh log: destroying a
        dangling intent would disarm the replay repair it exists for."""
        if self.meta is None:
            return
        await self.meta.operate(TABLE_OID, ObjectOperation()
                                .create()
                                .set_xattr(self._table_key,
                                           str(self.next_ino).encode()))
        keep = b""
        for e in self._open_intents.values():
            raw = encode(e)
            keep += _FRAME.pack(len(raw)) + raw
        try:
            await self.meta.operate(self._journal_oid,
                                    ObjectOperation().write_full(keep))
        except RadosError:
            pass
        self.journal_len = len(self._open_intents)

    # -- dirfrag helpers ---------------------------------------------------
    async def _fragtree(self, dino: int,
                        refresh: bool = False) -> list[tuple[int, int]]:
        """Per-ino fragtree cache (the CInode dirfragtree role):
        invalidated on local split/merge/removal and wherever the
        auth map changes (an importing rank must re-learn trees the
        exporter reshaped).  ``refresh`` forces a re-read — the read
        paths use it to close the lock-free race with a concurrent
        split/merge."""
        if not refresh:
            t = self._ftree_cache.get(dino)
            if t is not None:
                return t
        t = await fragtree_of(self.meta, dino)
        if len(self._ftree_cache) > 65536:
            self._ftree_cache.clear()
        self._ftree_cache[dino] = t
        return t

    async def _dir_all(self, dino: int) -> dict[str, bytes]:
        """Union of all live dirfrag omaps (the readdir/scrub/empty-
        check view).  Raises RadosError ENOENT exactly when the
        directory's base object is gone (same contract the single-
        object layout had).  A frag ENOENT mid-walk means a concurrent
        split/merge retired the object after we read the tree: re-read
        the tree and restart (bounded)."""
        for attempt in range(3):
            tree = await self._fragtree(dino, refresh=attempt > 0)
            if tree == [ROOT_FRAG]:
                return await self.meta.get_omap(dirfrag_oid(dino))
            out: dict[str, bytes] = {}
            stale = False
            for b, v in tree:
                try:
                    out.update(await self.meta.get_omap(
                        frag_oid(dino, b, v)))
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                    stale = True
                    break
            if not stale:
                return out
        # tree still names a missing frag object: a crashed split's
        # hole (scrub's territory) — serve what exists
        out = {}
        for b, v in tree:
            try:
                out.update(await self.meta.get_omap(
                    frag_oid(dino, b, v)))
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
        return out

    async def _get_dentry(self, parent: int, name: str,
                          snapid: int = 0) -> dict:
        if snapid:
            kv = await self._snap_view(parent, snapid, [name])
        else:
            kv = None
            for attempt in range(3):
                tree = await self._fragtree(parent,
                                            refresh=attempt > 0)
                trivial = tree == [ROOT_FRAG]
                oid = frag_oid(parent, *frag_for(tree, name))
                try:
                    kv = await self.meta.get_omap(oid, [name])
                    break
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                    if trivial:
                        raise MDSError(ENOENT, f"no dir {parent:x}")
                    # fragmented dir: ENOENT here usually means a
                    # concurrent split/merge retired this frag after
                    # the (cached) tree read — retry with a fresh
                    # tree; if it persists, the name is absent (the
                    # base object, our liveness witness, just served
                    # the fragtree)
                    kv = {}
        if name not in kv and not snapid:
            # name miss through a CACHED tree: a split/merge since the
            # cache fill may have moved the name to a sibling frag that
            # still exists (no ENOENT to trip the retry above) — one
            # forced re-read before declaring the name absent
            fresh = await self._fragtree(parent, refresh=True)
            if frag_for(fresh, name) != frag_for(tree, name):
                oid = frag_oid(parent, *frag_for(fresh, name))
                try:
                    kv = await self.meta.get_omap(oid, [name])
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                    kv = {}
        if name not in kv:
            raise MDSError(ENOENT, f"{name!r} not in {parent:x}",
                           missing_dentry=True)
        return decode(kv[name])

    async def _snap_view(self, dino: int, snapid: int,
                         names: list[str] | None = None) -> dict:
        """A directory's omap AS OF a snapshot: the frozen COW copy when
        one exists (the dirfrag diverged since the snap), else the live
        dirfrag (unchanged since — reference SnapRealm resolution).
        Frozen copies are single-object; the live fallback routes
        through the fragtree."""
        try:
            return await self.meta.get_omap(
                snap_dirfrag_oid(dino, snapid), names)
        except RadosError as e:
            if e.rc != ENOENT:
                raise
        try:
            if names is None:
                return await self._dir_all(dino)
            tree = await self._fragtree(dino)
            if tree == [ROOT_FRAG]:
                return await self.meta.get_omap(dirfrag_oid(dino),
                                                names)
            out: dict[str, bytes] = {}
            groups: dict[tuple[int, int], list[str]] = {}
            for n in names:
                groups.setdefault(frag_for(tree, n), []).append(n)
            for (b, v), ns in groups.items():
                try:
                    out.update(await self.meta.get_omap(
                        frag_oid(dino, b, v), ns))
                except RadosError as e2:
                    if e2.rc != ENOENT:
                        raise
            return out
        except RadosError as e:
            raise MDSError(ENOENT, f"no dir {dino:x}") \
                if e.rc == ENOENT else e

    async def _set_dentry(self, parent: int, name: str,
                          dentry: dict) -> None:
        # writing into a directory OUTSIDE this rank's subtrees (a
        # cross-rank rename destination import, replay of a foreign
        # chain): the owning rank may have split/merged the tree
        # without our invalidation hooks firing — force a re-read so
        # the dentry lands in a live frag, not a retired one
        foreign = (await self._auth_rank(parent)) != self.rank
        tree = await self._fragtree(parent, refresh=foreign)
        b, v = frag_for(tree, name)
        oid = frag_oid(parent, b, v)
        # counts track ENTRIES, not operations: an overwrite (setattr,
        # journal-replay re-apply) must not move the split trigger
        try:
            existed = name in await self.meta.get_omap(oid, [name])
        except RadosError as e:
            if e.rc != ENOENT:
                raise
            existed = False
        await self.meta.operate(oid, ObjectOperation()
                                .create()
                                .omap_set({name: encode(dentry)}))
        if not existed:
            await self._frag_note_add(parent, b, v)

    # -- dirfrag split/merge (CDir.cc:994 split / :1096 merge) -------------
    async def _frag_count(self, dino: int, b: int, v: int) -> int:
        """Cached entry count of one frag (initialized by one omap
        read, then maintained incrementally — the reference keeps the
        same count in CDir::fnode fragstat)."""
        key = (dino, b, v)
        c = self._frag_counts.get(key)
        if c is None:
            try:
                c = len(await self.meta.get_omap(frag_oid(dino, b, v)))
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                c = 0
            self._frag_counts[key] = c
        return c

    async def _frag_note_add(self, dino: int, b: int, v: int) -> None:
        c = await self._frag_count(dino, b, v)
        self._frag_counts[(dino, b, v)] = c = c + 1
        split_bits = int(self.conf["mds_bal_split_bits"])
        if c > int(self.conf["mds_bal_split_size"]) \
                and b + split_bits <= MAX_FRAG_BITS:
            entry = {"op": "fragment", "ino": dino, "bits": b,
                     "value": v, "nbits": split_bits}
            await self._journal(entry)
            await self._apply(entry)

    async def _frag_note_rm(self, dino: int, b: int, v: int) -> None:
        key = (dino, b, v)
        if key in self._frag_counts:
            self._frag_counts[key] = max(0, self._frag_counts[key] - 1)
        if b == 0:
            return
        # merge check: this frag and its sibling together below the
        # merge threshold -> fold back into the parent frag
        sib = (b, v ^ 1)
        tree = await self._fragtree(dino)
        if (b, v) not in tree or sib not in tree:
            return                    # sibling further split: no merge
        total = await self._frag_count(dino, b, v) \
            + await self._frag_count(dino, *sib)
        if total < int(self.conf["mds_bal_merge_size"]):
            entry = {"op": "fragment", "ino": dino, "bits": b - 1,
                     "value": v >> 1, "nbits": -1}
            await self._journal(entry)
            await self._apply(entry)

    async def _apply_fragment(self, dino: int, b: int, v: int,
                              nb: int) -> None:
        """Idempotent split (nb>0: frag (b,v) -> 2^nb children) or
        merge (nb<0: children of (b,v) -> (b,v)).  Journal-replayable:
        a crash between any two steps re-runs to the same state, and a
        completed entry's re-apply only re-runs the source cleanup."""
        from ceph_tpu_torch.placement.hashing import ceph_str_hash_rjenkins

        tree = await self._fragtree(dino)
        if nb > 0:
            children = [(b + nb, (v << nb) + i) for i in range(1 << nb)]
            if (b, v) not in tree:
                # already applied; finish the (idempotent) source
                # cleanup a crash may have cut off
                await self._frag_cleanup(dino, b, v)
                return
            try:
                kv = await self.meta.get_omap(frag_oid(dino, b, v))
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                kv = {}
            parts: dict[tuple[int, int], dict] = {c: {} for c in children}
            shift = 32 - (b + nb)
            for name, raw in kv.items():
                h = ceph_str_hash_rjenkins(name)
                parts[(b + nb, h >> shift)][name] = raw
            for c, ckv in parts.items():
                op = ObjectOperation().create()
                if ckv:
                    op.omap_set(ckv)
                await self.meta.operate(frag_oid(dino, *c), op)
            newtree = sorted([t for t in tree if t != (b, v)]
                             + children)
            await self.meta.operate(
                dirfrag_oid(dino), ObjectOperation().create().set_xattr(
                    "fragtree", encode([list(t) for t in newtree])))
            await self._frag_cleanup(dino, b, v, keys=list(kv))
        else:
            children = [(b + 1, (v << 1) + i) for i in (0, 1)]
            if not all(c in tree for c in children):
                for c in children:       # completed: re-run cleanup
                    if c not in tree:
                        await self._frag_cleanup(dino, *c)
                return
            union: dict[str, bytes] = {}
            for c in children:
                try:
                    union.update(await self.meta.get_omap(
                        frag_oid(dino, *c)))
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
            op = ObjectOperation().create()
            if union:
                op.omap_set(union)
            await self.meta.operate(frag_oid(dino, b, v), op)
            newtree = sorted([t for t in tree if t not in children]
                             + [(b, v)])
            if newtree == [ROOT_FRAG]:
                newtree = []             # trivial tree: drop the xattr
            await self.meta.operate(
                dirfrag_oid(dino), ObjectOperation().create().set_xattr(
                    "fragtree", encode([list(t) for t in newtree])))
            for c in children:
                await self._frag_cleanup(dino, *c)
        # stale counters and the cached tree die with the old layout
        for key in [k for k in self._frag_counts if k[0] == dino]:
            del self._frag_counts[key]
        self._ftree_cache.pop(dino, None)

    async def _frag_cleanup(self, dino: int, b: int, v: int,
                            keys: list[str] | None = None) -> None:
        """Remove a retired source frag.  The base object (frag 0/0)
        is never removed — it carries the fragtree/parent xattrs — its
        omap entries are cleared instead."""
        if (b, v) == ROOT_FRAG:
            if keys is None:
                try:
                    keys = list(await self.meta.get_omap(
                        dirfrag_oid(dino)))
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                    return
            if keys:
                try:
                    await self.meta.operate(
                        dirfrag_oid(dino),
                        ObjectOperation().omap_rm(keys))
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
            return
        try:
            await self.meta.remove(frag_oid(dino, b, v))
        except RadosError as e:
            if e.rc != ENOENT:
                raise

    async def _remove_dir_objects(self, ino: int) -> None:
        """Remove every object of a dying directory (rmdir / replaced-
        empty-dir purge): all fragtree leaves, then the base."""
        for b, v in await self._fragtree(ino):
            if (b, v) != ROOT_FRAG:
                await self._frag_cleanup(ino, b, v)
        try:
            await self.meta.remove(dirfrag_oid(ino))
        except RadosError as e:
            if e.rc != ENOENT:
                raise
        for key in [k for k in self._frag_counts if k[0] == ino]:
            del self._frag_counts[key]
        self._ftree_cache.pop(ino, None)

    # -- snap realms (COW; reference src/mds/SnapRealm.h) ------------------
    # mksnap records ONLY the realm (snapid, root ino) — O(1).  The cost
    # moves to the first post-snap mutation of each dirfrag: _cow_freeze
    # copies the pre-mutation omap to the snap suffix exactly once
    # (exclusive create), and snapshot reads resolve frozen-else-live
    # (_snap_view).  A directory renamed out of a realm keeps its
    # membership through a "past_snaps" xattr (the realm past_parents
    # role), merged along the ancestry walk.
    async def _parent_chain(self, dino: int) -> list[int]:
        chain = [dino]
        cur = dino
        hops = 0
        while cur != ROOT_INO and hops < 4096:
            try:
                raw = await self.meta.get_xattr(dirfrag_oid(cur),
                                                "parent")
            except RadosError:
                break
            cur = int(raw)
            chain.append(cur)
            hops += 1
        return chain

    async def _covering_snaps(self, dino: int) -> list[int]:
        """Live snapids whose realm covers directory ``dino``: realm
        root on the ancestry chain, or sticky past_snaps membership
        recorded on any chain member at rename time."""
        if not self.snaps:
            return []
        chain = await self._parent_chain(dino)
        chain_set = set(chain)
        covered = {sid for sid, info in self.snaps.items()
                   if int(info["ino"]) in chain_set}
        remaining = set(self.snaps) - covered
        if remaining:
            for link in chain:
                if not remaining:
                    break
                try:
                    raw = await self.meta.get_xattr(
                        dirfrag_oid(link), "past_snaps")
                except RadosError:
                    continue
                sticky = {int(s) for s in decode(raw)}
                covered |= sticky & remaining
                remaining -= sticky
        return sorted(covered)

    async def _cow_freeze(self, dino: int) -> None:
        """Copy ``dino``'s live dirfrag to every covering snapshot that
        has no frozen copy yet — called BEFORE any mutation of that
        dirfrag.  Idempotent (exclusive create: the first, pre-mutation
        freeze wins), so journal replay re-running a mutation cannot
        re-freeze post-mutation state."""
        if not self.snaps:
            return
        for snapid in await self._covering_snaps(dino):
            oid = snap_dirfrag_oid(dino, snapid)
            try:
                await self.meta.stat(oid)
                continue                      # already frozen
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
            try:
                kv = await self._dir_all(dino)
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                return                        # no dirfrag to freeze
            frozen: dict[str, bytes] = {}
            for dname, raw in kv.items():
                de = decode(raw)
                if de.get("remote"):
                    # hard-link stubs carry no inode attrs; freeze the
                    # inode resolved AT THE SNAPID — any post-snap attr
                    # change froze the primary's dirfrag first, so the
                    # snap-view resolution returns as-of-snap attrs
                    try:
                        de = dict(await self._resolve_remote(de,
                                                             snapid))
                        de.pop("remote", None)
                    except MDSError:
                        pass                  # racing unlink: keep stub
                frozen[dname] = encode(de)
            op = ObjectOperation().create(exclusive=True)
            if frozen:
                op.omap_set(frozen)
            try:
                await self.meta.operate(oid, op)
            except RadosError as e:
                if e.rc != EEXIST:
                    raise

    # -- mutation application (idempotent; journal replay re-runs these) --
    async def _rm_dentry(self, parent: int, name: str) -> None:
        """Remove one dentry, tolerating an absent dirfrag (journal
        replay re-applies removals idempotently)."""
        tree = await self._fragtree(parent)
        b, v = frag_for(tree, name)
        oid = frag_oid(parent, b, v)
        try:
            existed = name in await self.meta.get_omap(oid, [name])
            if existed:
                await self.meta.operate(
                    oid, ObjectOperation().omap_rm([name]))
        except RadosError as err:
            if err.rc != ENOENT:
                raise
            return
        if existed:
            await self._frag_note_rm(parent, b, v)

    async def _apply(self, e: dict) -> None:
        op = e["op"]
        # COW-freeze every dirfrag this op mutates BEFORE mutating it
        # (snapshot views then resolve frozen-else-live)
        for key in ("parent", "src_parent", "dst_parent", "pp", "np"):
            if key in e:
                await self._cow_freeze(int(e[key]))
        if op == "rmdir":
            await self._cow_freeze(int(e["ino"]))       # doomed dirfrag
        if op == "rename" and int(e.get("purge_dir_ino", 0)):
            await self._cow_freeze(int(e["purge_dir_ino"]))
        if op == "fragment":
            await self._apply_fragment(int(e["ino"]), int(e["bits"]),
                                       int(e["value"]),
                                       int(e["nbits"]))
        elif op in ("mkdir", "create"):
            dentry = dict(e["dentry"])
            await self._set_dentry(int(e["parent"]), str(e["name"]),
                                   dentry)
            if op == "create":
                await self._write_backtrace(int(e["ino"]),
                                            int(e["parent"]),
                                            str(e["name"]), dentry)
            if op == "mkdir":
                # the dirfrag carries a parent back-pointer so rename
                # can walk ancestors (cycle detection)
                await self.meta.operate(
                    dirfrag_oid(int(e["ino"])),
                    ObjectOperation().create().set_xattr(
                        "parent", str(int(e["parent"])).encode()
                    ),
                )
        elif op == "unlink":
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
            await self._purge_file(int(e["ino"]), int(e.get("size", 0)))
        elif op == "rmdir":
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
            await self._remove_dir_objects(int(e["ino"]))
            await self._quota_drop(int(e["ino"]))
        elif op == "rename":
            dentry = dict(e["dentry"])
            await self._rm_dentry(int(e["src_parent"]),
                                  str(e["src_name"]))
            await self._set_dentry(int(e["dst_parent"]),
                                   str(e["dst_name"]), dentry)
            if dentry.get("type") in ("file", "symlink") \
                    and not dentry.get("remote"):
                await self._write_backtrace(int(dentry["ino"]),
                                            int(e["dst_parent"]),
                                            str(e["dst_name"]),
                                            dentry)
            if dentry.get("type") == "dir":
                # moved directory: ancestry chains changed
                self._auth_cache.clear()
                self._ftree_cache.clear()
                # refresh its parent back-pointer
                op_x = ObjectOperation().create().set_xattr(
                    "parent", str(int(e["dst_parent"])).encode()
                )
                merged = {int(s) for s in e.get("past_snaps", ())}
                if merged:
                    # sticky realm membership (SnapRealm past_parents)
                    try:
                        raw = await self.meta.get_xattr(
                            dirfrag_oid(int(dentry["ino"])),
                            "past_snaps")
                        merged |= {int(s) for s in decode(raw)}
                    except RadosError:
                        pass
                    op_x.set_xattr("past_snaps",
                                   encode(sorted(merged)))
                await self.meta.operate(
                    dirfrag_oid(int(dentry["ino"])), op_x)
            if int(e.get("purge_ino", 0)):
                await self._purge_file(int(e["purge_ino"]),
                                       int(e.get("purge_size", 0)))
            if int(e.get("purge_dir_ino", 0)):
                # a replaced empty directory leaves its dirfrags behind
                await self._remove_dir_objects(int(e["purge_dir_ino"]))
                await self._quota_drop(int(e["purge_dir_ino"]))
            if int(e.get("anchor_ino", 0)):
                await self._anchor_put(int(e["anchor_ino"]),
                                       e.get("anchor"))
        elif op == "import_dentry":
            # cross-rank rename, destination half.  The ATOMIC commit
            # claim gates the link — in the live path AND on journal
            # replay: a crash after journaling but before apply leaves
            # the claim unmade, the source's timeout wins the abort,
            # and the replayed entry must then link NOTHING (or the
            # file would exist under both names).  The marker is
            # durable even if the dentry is later unlinked/renamed —
            # it is what timeout resolution and replay repair consult.
            ok = True
            if e.get("token"):
                ok = await self._rename_mark_commit(str(e["token"]))
            if ok:
                if e.get("pre"):
                    await self._apply(dict(e["pre"]))
                await self._set_dentry(int(e["parent"]),
                                       str(e["name"]),
                                       dict(e["dentry"]))
                de_imp = dict(e["dentry"])
                if de_imp.get("type") in ("file", "symlink") \
                        and not de_imp.get("remote"):
                    await self._write_backtrace(int(de_imp["ino"]),
                                                int(e["parent"]),
                                                str(e["name"]),
                                                de_imp)
                if dict(e["dentry"]).get("type") == "dir":
                    # imported directory: its ancestry chain now runs
                    # through THIS rank's territory — refresh the
                    # back-pointer and drop stale auth resolutions
                    await self.meta.operate(
                        dirfrag_oid(int(e["ino"])),
                        ObjectOperation().create().set_xattr(
                            "parent", str(int(e["parent"])).encode()
                        ),
                    )
                    self._auth_cache.clear()
                    self._ftree_cache.clear()
                if int(e.get("anchor_ino", 0)):
                    # hardlinked primary imported from another rank:
                    # the anchor's primary pointer follows the inode
                    # under the same commit claim (versioned write —
                    # replay-safe from either rank's journal)
                    await self._anchor_put(int(e["anchor_ino"]),
                                           e.get("anchor"))
                if int(e.get("purge_dir_ino", 0)):
                    await self._remove_dir_objects(
                        int(e["purge_dir_ino"]))
                if int(e.get("purge_ino", 0)):
                    await self._purge_file(int(e["purge_ino"]),
                                           int(e.get("purge_size",
                                                     0)))
        elif op == "rename_export_finish":
            # cross-rank rename, source half: drop the exported name
            # only — the inode lives on under the destination rank
            await self._rm_dentry(int(e["src_parent"]),
                                  str(e["src_name"]))
            # an exported DIRECTORY's descendants now resolve through
            # the destination's chain; cached auths are stale
            self._auth_cache.clear()
            self._ftree_cache.clear()
            self._quota_invalidate()
        elif op in ("rename_export_intent", "rename_export_abort",
                    "link_export_intent", "link_export_abort",
                    "unlink_remote_intent", "unlink_remote_abort",
                    "promote_export_intent", "promote_export_abort",
                    "repoint_intent", "repoint_abort"):
            pass          # journal markers; resolved by replay repair
        elif op == "repoint_remote":
            # remote-name rename, primary-rank half (claim-gated):
            # the anchor's remotes list swaps the old name for the new
            ok = True
            if e.get("token"):
                ok = await self._rename_mark_commit(str(e["token"]))
            if ok:
                await self._anchor_put(int(e["ino"]),
                                       dict(e["anchor"]))
        elif op == "repoint_finish":
            # remote-name rename, name half: the replaced destination
            # (if any) tears down FIRST — it rides inside this entry
            # so an aborted repoint never unlinked it
            if e.get("pre"):
                await self._apply(dict(e["pre"]))
            await self._rm_dentry(int(e["src_parent"]),
                                  str(e["src_name"]))
            await self._set_dentry(int(e["dst_parent"]),
                                   str(e["dst_name"]),
                                   dict(e["dentry"]))
            if int(e.get("purge_ino", 0)):
                await self._purge_file(int(e["purge_ino"]),
                                       int(e.get("purge_size", 0)))
        elif op == "import_link":
            # cross-rank link, destination half: the commit claim
            # gates the remote dentry exactly like import_dentry
            ok = True
            if e.get("token"):
                ok = await self._rename_mark_commit(str(e["token"]))
            if ok:
                await self._set_dentry(int(e["parent"]),
                                       str(e["name"]),
                                       dict(e["remote_dentry"]))
        elif op == "link_export_finish":
            # cross-rank link, primary half: nlink + anchor land only
            # after the destination's commit is known (idempotent
            # absolute writes on replay)
            await self._set_dentry(int(e["pp"]), str(e["pn"]),
                                   dict(e["primary_dentry"]))
            await self._anchor_put(int(e["ino"]), dict(e["anchor"]))
        elif op == "update_primary":
            # cross-rank remote-unlink, primary half (claim-gated)
            ok = True
            if e.get("token"):
                ok = await self._rename_mark_commit(str(e["token"]))
            if ok:
                await self._set_dentry(int(e["pp"]), str(e["pn"]),
                                       dict(e["primary_dentry"]))
                await self._anchor_put(int(e["ino"]), e.get("anchor"))
        elif op == "unlink_remote_finish":
            # cross-rank remote-unlink, name half: drop the remote
            # dentry only — the primary's rank already adjusted
            # nlink/anchor under the commit claim
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
        elif op == "import_promoted":
            # cross-rank promotion, remote-name half (claim-gated):
            # the remote dentry becomes the inode's primary and the
            # anchor moves with it
            ok = True
            if e.get("token"):
                ok = await self._rename_mark_commit(str(e["token"]))
            if ok:
                await self._set_dentry(int(e["parent"]),
                                       str(e["name"]),
                                       dict(e["primary_dentry"]))
                await self._anchor_put(int(e["ino"]), e.get("anchor"))
                # a stale backtrace would let data-scan resurrect the
                # deleted old primary name (promote_link parity)
                await self._write_backtrace(int(e["ino"]),
                                            int(e["parent"]),
                                            str(e["name"]),
                                            dict(e["primary_dentry"]))
        elif op == "promote_export_finish":
            # cross-rank promotion, old-primary half: drop the NAME
            # only — the inode lives on under the promoted primary
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
        elif op == "setattr":
            await self._set_dentry(int(e["parent"]), str(e["name"]),
                                   dict(e["dentry"]))
        elif op == "setquota":
            ino = int(e["ino"])
            q = {"max_bytes": int(e["max_bytes"]),
                 "max_files": int(e["max_files"])}
            if not q["max_bytes"] and not q["max_files"]:
                # create() first: clearing against a never-created
                # table object must be a no-op, and the clear must
                # reach the TABLE even when this rank's cache is
                # stale (a realm root imported from another rank)
                await self.meta.operate(
                    QUOTATABLE_OID, ObjectOperation().create()
                    .omap_rm([str(ino)]))
                self.quotas.pop(ino, None)
                self._qusage.pop(ino, None)
            else:
                await self.meta.operate(
                    QUOTATABLE_OID, ObjectOperation().create()
                    .omap_set({str(ino): encode(q)}))
                self.quotas[ino] = q
        elif op == "mksnap":
            await self.meta.operate(SNAPTABLE_OID, ObjectOperation()
                                    .create().omap_set({
                                        str(int(e["snapid"])):
                                        encode(dict(e["info"])),
                                    }))
            self.snaps[int(e["snapid"])] = dict(e["info"])
            self._apply_snapc()
        elif op == "rmsnap":
            # cleanup lives HERE so journal replay after a crash
            # re-runs it (idempotent: removals tolerate ENOENT); the
            # walk follows the snapshot VIEW (frozen-else-live), so a
            # directory renamed out of the subtree after mksnap is
            # still reachable through its frozen parent, and dirfrags
            # that never diverged have nothing to remove
            snapid = int(e["snapid"])
            queue = [int(e["ino"])]
            seen = set()
            while queue:
                dino = queue.pop()
                if dino in seen:
                    continue
                seen.add(dino)
                try:
                    kv = await self._snap_view(dino, snapid)
                except MDSError:
                    kv = {}
                for raw in kv.values():
                    de = decode(raw)
                    if de.get("type") == "dir":
                        queue.append(int(de["ino"]))
                try:
                    await self.meta.remove(
                        snap_dirfrag_oid(dino, snapid))
                except RadosError as err:
                    if err.rc != ENOENT:
                        raise
            try:
                await self.data.selfmanaged_snap_remove(snapid)
            except (RadosError, KeyError, ValueError):
                pass              # already trimmed on a replay
            try:
                await self.meta.operate(
                    SNAPTABLE_OID,
                    ObjectOperation().omap_rm([str(snapid)]),
                )
            except RadosError as err:
                if err.rc != ENOENT:
                    raise
            self.snaps.pop(snapid, None)
            self._apply_snapc()
        elif op == "link":
            await self._set_dentry(int(e["parent"]), str(e["name"]),
                                   dict(e["remote_dentry"]))
            await self._set_dentry(int(e["pp"]), str(e["pn"]),
                                   dict(e["primary_dentry"]))
            await self._anchor_put(int(e["ino"]), dict(e["anchor"]))
        elif op == "unlink_remote":
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
            await self._set_dentry(int(e["pp"]), str(e["pn"]),
                                   dict(e["primary_dentry"]))
            await self._anchor_put(int(e["ino"]), e.get("anchor"))
            await self._write_backtrace(int(e["ino"]), int(e["pp"]),
                                        str(e["pn"]),
                                        dict(e["primary_dentry"]))
        elif op == "promote_link":
            await self._rm_dentry(int(e["parent"]),
                                  str(e["name"]))
            await self._set_dentry(int(e["np"]), str(e["nn"]),
                                   dict(e["primary_dentry"]))
            await self._anchor_put(int(e["ino"]), e.get("anchor"))
            # the primary dentry moved: a stale backtrace would let a
            # data-scan inject resurrect the DELETED old name
            await self._write_backtrace(int(e["ino"]), int(e["np"]),
                                        str(e["nn"]),
                                        dict(e["primary_dentry"]))

    async def _purge_file(self, ino: int, size: int) -> None:
        """Delete a file's data objects (the PurgeQueue role, inline)."""
        if ino <= 0:
            return
        nblocks = max(1, -(-size // self.block_size))
        for b in range(nblocks):
            try:
                await self.data.remove(block_oid(ino, b))
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
        try:
            await self.data.remove(backtrace_oid(ino))
        except RadosError as e:
            if e.rc != ENOENT:
                raise

    # -- hard links (remote dentries + the reference's anchortable) -------
    # The inode stays EMBEDDED in one primary dentry; other names are
    # remote dentries {"remote": True, "ino": N}.  While nlink > 1 the
    # anchortable omap maps ino -> {"primary": [p, n], "remotes":
    # [[p, n], ...]} so remotes resolve and unlink can promote
    # (reference src/mds/AnchorTable-era design, kept as server state).
    async def _anchor_get_raw(self, ino: int) -> dict | None:
        """The stored record, tombstones included (version source)."""
        try:
            kv = await self.meta.get_omap(ANCHOR_OID, [str(ino)])
        except RadosError as e:
            if e.rc == ENOENT:
                return None
            raise
        return decode(kv[str(ino)]) if str(ino) in kv else None

    async def _anchor_get(self, ino: int) -> dict | None:
        rec = await self._anchor_get_raw(ino)
        return None if rec is None or rec.get("dead") else rec

    async def _anchor_next(self, ino: int,
                           new: dict | None) -> dict:
        """The next anchor state, version-stamped at PLAN time so a
        journal replay re-applies exactly the version it applied live.
        Anchors are written from MORE THAN ONE rank's journal (the
        primary moves ranks on cross-rank promotion), so replay-
        ordering cannot come from one journal's sequence — it comes
        from the record version: _anchor_put keeps the newest write,
        and deletion is a versioned TOMBSTONE (the version must keep
        counting across delete/recreate cycles, so the raw stored
        record — dead or live — is the version source)."""
        raw = await self._anchor_get_raw(ino)
        v = (int(raw.get("v", 0)) if raw else 0) + 1
        if new is None:
            return {"dead": True, "v": v}
        return {**new, "v": v}

    async def _anchor_put(self, ino: int, rec: dict | None) -> None:
        raw = await self._anchor_get_raw(ino)
        cur_v = int(raw.get("v", 0)) if raw else 0
        if rec is None:
            rec = {"dead": True, "v": cur_v + 1}
        elif "v" not in rec:
            rec = {**rec, "v": cur_v + 1}     # unplanned (scrub) write
        elif int(rec["v"]) <= cur_v:
            return        # stale replayed write: a newer state landed
        await self.meta.operate(
            ANCHOR_OID, ObjectOperation().create()
            .omap_set({str(ino): encode(rec)}))

    async def _primary_of(self, ino: int,
                          rec: dict | None = None,
                          snapid: int = 0) -> tuple[int, str, dict]:
        if rec is None:
            rec = await self._anchor_get(ino)
        if rec is None:
            raise MDSError(ENOENT, f"no anchor for {ino:x}")
        pp, pn = int(rec["primary"][0]), str(rec["primary"][1])
        return pp, pn, await self._get_dentry(pp, pn, snapid)

    async def _resolve_remote(self, dentry: dict,
                              snapid: int = 0) -> dict:
        """A remote dentry's visible attrs are the primary's inode.
        With ``snapid``, the primary resolves through the snap view
        (frozen-else-live): any post-snap attr change froze the
        primary's dirfrag first, so the attrs are as-of-snap.  The
        anchor pointer itself is live — a -lite approximation; frozen
        dirfrags store stubs pre-resolved so this path only serves
        not-yet-diverged directories."""
        if not dentry.get("remote"):
            return dentry
        _, _, primary = await self._primary_of(int(dentry["ino"]),
                                               snapid=snapid)
        return {**primary, "remote": True}

    async def _plan_unlink_guard(self, dentry: dict) -> None:
        """_unlink_plan mutates the primary dentry (remote drop) or
        promotes the first remote IN PLACE; decline when that dirfrag
        belongs to another rank — cross-rank link teardown must funnel
        through the update_primary protocol, not a foreign omap
        write."""
        ino = int(dentry.get("ino", 0))
        if dentry.get("remote"):
            rec = await self._anchor_get(ino)
            if rec is not None and await self._auth_rank(
                    int(rec["primary"][0])) != self.rank:
                raise MDSError(
                    EXDEV, "replaces one name of a cross-rank link; "
                    "unlink it first")
        elif int(dentry.get("nlink", 1)) > 1:
            rec = await self._anchor_get(ino)
            if rec is not None and rec["remotes"] and \
                    await self._auth_rank(
                        int(rec["remotes"][0][0])) != self.rank:
                raise MDSError(
                    EXDEV, "would promote a foreign remote; "
                    "remove the remote name first")

    async def _unlink_plan(self, parent: int, name: str,
                           dentry: dict) -> dict:
        """The journal entry that removes one name of a file, hardlink-
        aware: remotes decrement, a linked primary promotes a remote to
        carry the inode, and only the LAST name purges data."""
        ino = int(dentry["ino"])
        if dentry.get("remote"):
            rec = await self._anchor_get(ino)
            pp, pn, primary = await self._primary_of(ino, rec)
            # the primary may be pinned by an in-flight two-phase
            # protocol (cross-rank rename/repoint): mutating nlink or
            # the anchor under it would clobber that protocol's
            # absolute writes
            self._guard_busy((pp, pn))
            primary = dict(primary)
            nl = int(primary.get("nlink", 1)) - 1
            primary["nlink"] = nl
            remotes = [r for r in rec["remotes"]
                       if [int(r[0]), str(r[1])] != [parent, name]]
            new_rec = await self._anchor_next(
                ino, None if nl <= 1 else
                {"primary": [pp, pn], "remotes": remotes})
            return {"op": "unlink_remote", "parent": parent,
                    "name": name, "ino": ino, "pp": pp, "pn": pn,
                    "primary_dentry": primary, "anchor": new_rec}
        nl = int(dentry.get("nlink", 1))
        if nl > 1:
            rec = await self._anchor_get(ino)
            np, nn = int(rec["remotes"][0][0]), str(rec["remotes"][0][1])
            self._guard_busy((np, nn))    # same pin rule as above
            promoted = dict(dentry)
            promoted["nlink"] = nl - 1
            new_rec = await self._anchor_next(
                ino, None if nl - 1 <= 1 else
                {"primary": [np, nn],
                 "remotes": rec["remotes"][1:]})
            return {"op": "promote_link", "parent": parent,
                    "name": name, "ino": ino, "np": np, "nn": nn,
                    "primary_dentry": promoted, "anchor": new_rec}
        return {"op": "unlink", "parent": parent, "name": name,
                "ino": ino, "size": int(dentry.get("size", 0))}

    # -- request handling (Server.cc handle_client_request) ---------------
    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    def ms_handle_reset(self, conn: Connection) -> None:
        for sid, s in list(self._sessions.items()):
            if s["conn"] is conn:
                self._sessions.pop(sid, None)
        # a dead client's caps must not stall later recalls for the
        # full timeout: drop its grants and wake any waiters
        for ino, holder in list(self._caps.items()):
            if holder["conn"] is conn:
                self._caps.pop(ino, None)
                self._cap_resolve(ino)
        if self._rados_dispatch is not None:
            self.rados.ms_handle_reset(conn)

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        if msg.type == "mds_takeover":
            # promotion after a failover: our table/journal view dates
            # from boot — re-sync (at the ASSIGNED rank) before serving
            # mutations, or inos the failed active allocated could be
            # handed out again
            self.rank = int(msg.data.get("rank", self.rank))
            asyncio.get_running_loop().create_task(self._resync())
            return
        if msg.type == "mds_beacon_ack":
            # backup resync trigger: acks report our fsmap state, so a
            # standby->active transition (and our assigned rank) is
            # seen even when the leader's one-shot notify was lost
            state = str(msg.data.get("state", ""))
            rank = int(msg.data.get("rank", self.rank))
            if state == "up:active" and (
                    self._last_state == "up:standby"
                    or (rank >= 0 and rank != self.rank)):
                if rank >= 0:
                    self.rank = rank
                asyncio.get_running_loop().create_task(self._resync())
            self._last_state = state
            return
        if msg.type == "cap_release":
            # fire-and-forget release from a recalled client (the
            # request-path release_cap covers the clean-close case)
            ino = int(msg.data.get("ino", 0))
            holder = self._caps.get(ino)
            if holder is not None and holder["conn"] is conn:
                # only the CURRENT holder's release frees waiters; a
                # late release from an already-revoked holder must
                # not wake recalls aimed at the new grant
                self._caps.pop(ino, None)
                self._cap_resolve(ino)
            return
        if msg.type == "mds_reply" and \
                int(msg.data.get("tid", -1)) in self._peer_pending:
            fut = self._peer_pending.pop(int(msg.data["tid"]))
            if not fut.done():
                fut.set_result(msg.data)
            return
        if msg.type != "mds_request":
            if self._rados_dispatch is not None:
                # mon/rados traffic rides our shared dispatcher hook
                await self._rados_dispatch(conn, msg)
            else:
                log.dout(10, "%s: ignoring %s", self.entity, msg.type)
            return
        asyncio.get_running_loop().create_task(
            self._handle_request(conn, msg.data)
        )

    async def _resync(self) -> None:
        async with self._mutate:
            await self._load_snaptable()
            await self._load_quotatable()
            await self._load_subtrees()
            await self._load_table()
            await self._replay_journal()
            await self._repair_rename_intents()
        log.dout(1, "%s: resynced for takeover (rank=%d next_ino=%d)",
                 self.entity, self.rank, self.next_ino)

    async def _auth_rank(self, dino: int) -> int:
        """The rank authoritative for directory ``dino``: the nearest
        subtree-map entry on its ancestry chain, default rank 0 (the
        CDir subtree-auth resolution).  Memoized — invalidated on map
        reload, export, and directory renames (which change chains)."""
        return (await self._auth_rank_ex(dino))[0]

    async def _auth_rank_ex(self, dino: int) -> tuple[int, bool]:
        """(auth rank, explicit): ``explicit`` is False when resolution
        fell through to the rank-0 default — the caller may want to
        refresh the map before trusting it (a fresh export toward us
        looks exactly like that)."""
        if not self._subtrees and self.rank == 0:
            return 0, True
        hit = self._auth_cache.get(dino)
        if hit is not None:
            return hit, True
        rank, explicit = 0, False
        for link in await self._parent_chain(dino):
            r = self._subtrees.get(link)
            if r is not None:
                rank, explicit = r, True
                break
        if explicit or (rank == self.rank == 0):
            # defaulted results are cacheable for rank 0 (it IS the
            # default); other ranks must keep re-deriving them so a
            # fresh export toward them is noticed (refresh trigger)
            if len(self._auth_cache) > 65536:
                self._auth_cache.clear()
                self._ftree_cache.clear()
            self._auth_cache[dino] = rank
        return rank, explicit

    async def _check_auth(self, d: dict, op: str) -> int:
        """Serve only requests for directories this rank is
        authoritative over; others get a redirect the client follows
        (the reference forwards between MDSs; -lite redirects).
        Returns the directory ino the request was routed by."""
        # rename routes by its SOURCE parent (the rank that owns the
        # dentry being moved); its handler separately declines
        # cross-rank destinations with EXDEV
        dino = int(d.get("src_parent",
                         d.get("parent", d.get("ino", ROOT_INO))))
        if op in ("session", "get_load", "subtree_refresh",
                  "snap_refresh"):
            return dino
        auth, explicit = await self._auth_rank_ex(dino)
        if auth != self.rank and (
                not explicit
                or d.get("refresh_subtrees")
                or time.monotonic() - self._subtrees_loaded > 1.0):
            # maybe our map is stale (a fresh export toward us looks
            # like a default-fallback miss, and a ping-ponging client
            # sends refresh_subtrees): refresh — but when an explicit
            # entry already explains the redirect, throttle; redirecting
            # is the NORMAL case for rank 0 (clients start there) and an
            # omap read per op would tax the hot path
            await self._load_subtrees()
            auth = await self._auth_rank(dino)
        if auth != self.rank:
            raise MDSError(EREMOTE_RANK,
                           f"dir {dino:x} is served by rank {auth}",
                           redirect_rank=auth)
        return dino

    async def _handle_request(self, conn: Connection, d: dict) -> None:
        tid = d.get("tid", 0)
        op = str(d.get("op", ""))
        try:
            handler = getattr(self, f"_req_{op}", None)
            if handler is None:
                raise MDSError(EINVAL, f"unknown mds op {op!r}")
            d["_conn"] = conn       # cap ops key grants on the session
            dino = await self._check_auth(d, op)
            if op not in ("session", "get_load", "export_dir",
                          "subtree_refresh", "snap_refresh"):
                # balancer popularity: the directory the auth check
                # routed by (exports are administrative, not load)
                self._note_pop(dino)
            if op in ("lookup", "readdir", "session", "lssnap",
                      "rename", "link", "unlink", "setattr",
                      "get_load", "open_file", "release_cap",
                      "subtree_refresh", "snap_refresh"):
                # reads need no lock; rename/link/unlink/setattr
                # manage their own (each must release the mutate lock
                # across a cross-rank peer RPC); cap ops await client
                # recalls and touch only the volatile cap table
                result = await handler(d)
            else:
                async with self._mutate:
                    # authority may have moved (a balancer export)
                    # while this op queued on the lock: re-check, or
                    # the mutation would land in a foreign dirfrag
                    await self._check_auth(d, op)
                    result = await handler(d)
                    await self._maybe_compact()
            reply = {"tid": tid, "rc": 0, **result}
            # every reply carries the live snapc: clients must COW
            # data writes under new snaps without a dedicated fetch
            reply.setdefault("snapc", self._snapc_wire())
        except MDSError as e:
            reply = {"tid": tid, "rc": e.rc, "err": str(e)}
            if e.redirect_rank is not None:
                reply["redirect_rank"] = e.redirect_rank
        except RadosError as e:
            reply = {"tid": tid, "rc": e.rc, "err": str(e)}
        try:
            conn.send_message(Message("mds_reply", reply))
        except ConnectionError:
            pass

    # -- ops ---------------------------------------------------------------
    async def _req_session(self, d: dict) -> dict:
        """Session open: hand the client the layout it needs for direct
        data IO (the mdsmap + file-layout handshake)."""
        conn = d.get("_conn")
        if conn is not None and not any(
                s["conn"] is conn for s in self._sessions.values()):
            self._next_sid += 1
            self._sessions[self._next_sid] = {
                "conn": conn,
                "client": conn.peer_name or conn.peer_addr,
                "opened": time.time(),
            }
        return {"root": ROOT_INO, "data_pool": self.data_pool,
                "block_size": self.block_size,
                "lease": self.lease_ttl}

    async def _req_lookup(self, d: dict) -> dict:
        snapid = int(d.get("snapid", 0))
        dentry = await self._get_dentry(int(d["parent"]),
                                        str(d["name"]), snapid)
        if dentry.get("remote"):
            try:
                dentry = await self._resolve_remote(dentry, snapid)
            except MDSError:
                if not snapid:
                    raise          # snap stub mid-unlink: serve as-is
        if dentry.get("type") == "file" \
                and int(dentry["ino"]) in self._caps:
            # a write cap is out on this file: readers use this (it
            # rides the cached dentry) to decide whether an open
            # needs the recall round-trip
            dentry = {**dentry, "cap_held": True}
        return {"dentry": dentry, "lease": self.lease_ttl,
                "snapc": self._snapc_wire()}

    async def _req_fragment(self, d: dict) -> dict:
        """Manual dirfrag split/merge (the 'ceph tell mds.N dirfrag
        split / merge' surface, reference MDSRank command_dirfrag_split
        / command_dirfrag_merge).  nbits > 0 splits leaf (bits, value)
        into 2^nbits children; nbits == -1 merges (bits, value)'s two
        children back."""
        ino = int(d["ino"])
        b, v = int(d.get("bits", 0)), int(d.get("value", 0))
        nb = int(d.get("nbits", 1))
        try:
            await self.meta.stat(dirfrag_oid(ino))
        except RadosError as e:
            raise MDSError(ENOENT, f"no dir {ino:x}") \
                if e.rc == ENOENT else e
        tree = await self._fragtree(ino)
        if nb > 0:
            if b + nb > MAX_FRAG_BITS:
                raise MDSError(EINVAL,
                               f"split past {MAX_FRAG_BITS} bits")
            if (b, v) not in tree:
                raise MDSError(EINVAL, f"no leaf {b}_{v:x} in the "
                               "fragtree")
        elif nb == -1:
            kids = [(b + 1, (v << 1) + i) for i in (0, 1)]
            if not all(c in tree for c in kids):
                raise MDSError(EINVAL,
                               f"{b}_{v:x} has no mergeable children")
        else:
            raise MDSError(EINVAL, f"bad nbits {nb}")
        entry = {"op": "fragment", "ino": ino, "bits": b, "value": v,
                 "nbits": nb}
        await self._journal(entry)
        await self._apply(entry)
        return {"fragtree": [list(t) for t in
                             await self._fragtree(ino)]}

    async def _req_readdir(self, d: dict) -> dict:
        ino = int(d["ino"])
        snapid = int(d.get("snapid", 0))
        if snapid:
            kv = await self._snap_view(ino, snapid)
        else:
            try:
                kv = await self._dir_all(ino)
            except RadosError as e:
                raise MDSError(ENOENT, f"no dir {ino:x}") \
                    if e.rc == ENOENT else e
        entries = {name: decode(raw) for name, raw in kv.items()}
        for name, de in entries.items():
            if de.get("remote"):
                try:
                    entries[name] = await self._resolve_remote(de,
                                                               snapid)
                except MDSError:
                    pass        # racing unlink: show the raw entry
        return {"entries": entries, "lease": self.lease_ttl}

    async def _alloc_ino(self) -> int:
        ino = self.next_ino
        self.next_ino += 1
        return ino

    async def _ensure_absent(self, parent: int, name: str) -> None:
        try:
            await self._get_dentry(parent, name)
        except MDSError as e:
            if e.missing_dentry:
                return
            raise
        raise MDSError(EEXIST, f"{name!r} exists")

    async def _req_mkdir(self, d: dict) -> dict:
        parent, name = int(d["parent"]), str(d["name"])
        self._guard_busy((parent, name))
        await self._ensure_absent(parent, name)
        qroots = await self._quota_check(parent, add_files=1)
        ino = await self._alloc_ino()
        dentry = _dentry(ino, "dir", int(d.get("mode", 0o755)))
        entry = {"op": "mkdir", "parent": parent, "name": name,
                 "ino": ino, "dentry": dentry}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_charge(qroots, files=1)
        return {"dentry": dentry}

    def _cap_grant_if_free(self, ino: int, conn) -> bool:
        """Grant the write cap when uncontended (no recall, no wait —
        safe under the mutate lock).  The reference likewise issues
        caps in the open/create reply; the contended case falls back
        to the client's open_file request, which can wait."""
        holder = self._caps.get(ino)
        if holder is not None and not holder["conn"].is_closed \
                and holder["conn"] is not conn:
            return False
        self._caps[ino] = {"conn": conn, "holder": ""}
        return True

    async def _req_create(self, d: dict) -> dict:
        parent, name = int(d["parent"]), str(d["name"])
        self._guard_busy((parent, name))
        try:
            existing = await self._get_dentry(parent, name)
            if d.get("exclusive"):
                raise MDSError(EEXIST, f"{name!r} exists")
            if existing["type"] == "dir":
                raise MDSError(EISDIR, name)
            if existing["type"] == "symlink":
                # the MDS cannot follow (resolution is client-side):
                # answering with the link dentry would let the client
                # write data blocks under the LINK's inode.  The client
                # re-resolves and retries at the target (a race with a
                # concurrent symlink creation lands here).
                raise MDSError(ELOOP, f"{name!r} is a symlink")
            out = {"dentry": await self._resolve_remote(existing)}
            if d.get("want_cap") and self._cap_grant_if_free(
                    int(existing["ino"]), d.get("_conn")):
                out["cap"] = "w"
            return out
        except MDSError as e:
            if not e.missing_dentry:
                raise
        qroots = await self._quota_check(parent, add_files=1)
        ino = await self._alloc_ino()
        dentry = _dentry(ino, "file", int(d.get("mode", 0o644)))
        entry = {"op": "create", "parent": parent, "name": name,
                 "ino": ino, "dentry": dentry}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_charge(qroots, files=1)
        out = {"dentry": dentry}
        if d.get("want_cap") and self._cap_grant_if_free(
                ino, d.get("_conn")):
            out["cap"] = "w"
        return out

    async def _req_symlink(self, d: dict) -> dict:
        """Server::handle_client_symlink: a dentry of type symlink
        whose target string rides the embedded inode."""
        parent, name = int(d["parent"]), str(d["name"])
        self._guard_busy((parent, name))
        try:
            await self._get_dentry(parent, name)
            raise MDSError(EEXIST, f"{name!r} exists")
        except MDSError as e:
            if not e.missing_dentry:
                raise
        qroots = await self._quota_check(parent, add_files=1)
        ino = await self._alloc_ino()
        dentry = _dentry(ino, "symlink", 0o777)
        dentry["target"] = str(d.get("target", ""))
        entry = {"op": "create", "parent": parent, "name": name,
                 "ino": ino, "dentry": dentry}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_charge(qroots, files=1)
        return {"dentry": dentry}

    async def _walk_subtree(self, ino: int) -> list[int]:
        """Directory inos of the subtree rooted at ``ino`` (BFS; -lite
        scale walks eagerly like the reference's snaprealm open)."""
        out, queue = [], [ino]
        while queue:
            cur = queue.pop()
            out.append(cur)
            try:
                kv = await self._dir_all(cur)
            except RadosError as e:
                if e.rc == ENOENT:
                    continue
                raise
            for raw in kv.values():
                de = decode(raw)
                if de.get("type") == "dir":
                    queue.append(int(de["ino"]))
        return out

    async def _req_mksnap(self, d: dict) -> dict:
        """Snapshot of the subtree at dir ``ino`` (Server::mksnap) as a
        COW SNAP REALM (reference SnapRealm.h): O(1) regardless of
        subtree size — just a snapid + realm record.  Metadata diverges
        lazily (_cow_freeze on first mutation per dirfrag); file data =
        RADOS self-managed snap, COWed by every client's snapc."""
        ino, name = int(d["ino"]), str(d["name"])
        if any(i["name"] == name and int(i["ino"]) == ino
               for i in self.snaps.values()):
            raise MDSError(EEXIST, f"snap {name!r} exists")
        await self._load_subtrees()      # a stale map must not skip a
        realm_ranks = set()              # rank owning realm territory
        for s, r in self._subtrees.items():
            if r != self.rank and (s == ino
                                   or await self._is_ancestor(ino, s)):
                realm_ranks.add(r)
        snapid = await self.data.selfmanaged_snap_create()
        entry = {"op": "mksnap", "snapid": snapid,
                 "info": {"name": name, "ino": ino,
                          "created": time.time()}}
        await self._journal(entry)
        await self._apply(entry)
        if realm_ranks:
            # the realm SPANS delegated subtrees (round-3 weak #5):
            # every owning rank must ADOPT the snapid (reload the
            # shared snaptable into its snapc) before mksnap returns,
            # or its next mutation under the realm would skip the COW
            # freeze.  Adoption is required, not best-effort — a rank
            # that cannot adopt fails the mksnap and the snap rolls
            # back (a restarting rank reloads the table at boot).
            failed = None
            for r in sorted(realm_ranks):
                try:
                    await self._require_snap_adoption(r)
                except MDSError as e:
                    failed = (r, str(e))
                    break
            if failed is not None:
                rollback = {"op": "rmsnap", "snapid": snapid,
                            "ino": ino}
                await self._journal(rollback)
                await self._apply(rollback)
                raise MDSError(
                    EXDEV, f"rank {failed[0]} could not adopt the "
                    f"snapshot ({failed[1]}); mksnap rolled back")
        return {"snapid": snapid, "snapc": self._snapc_wire()}

    async def _require_snap_adoption(self, rank: int) -> None:
        """Required snaptable-adoption push (shared by mksnap on
        spanning realms and export-under-snapshot): the peer rank must
        reload the shared snaptable NOW, or its next mutation under
        the realm would skip the COW freeze.  Raises on any failure —
        adoption is required, never best-effort."""
        reply = await self._peer_request(rank, {"op": "snap_refresh"},
                                         timeout=5.0)
        if int(reply.get("rc", -1)) != 0:
            raise MDSError(EXDEV, str(reply.get("err", "refused")))

    async def _req_snap_refresh(self, d: dict) -> dict:
        """Peer push after mksnap/rmsnap on a realm that spans our
        territory: adopt the shared snaptable NOW so the very next
        mutation COW-freezes under the new snap."""
        await self._load_snaptable()
        return {}

    async def _req_export_dir(self, d: dict) -> dict:
        """Delegate the subtree at dir ``ino`` to another active rank
        (the Migrator.h:50 subtree export, journal-coordinated: every
        mutation this rank made is applied + compacted before the map
        entry commits, so the importing rank starts from durable
        state — the -lite design keeps no dirty MDS cache to migrate).
        """
        ino, rank = int(d["ino"]), int(d["rank"])
        if rank < 0 or rank > 64:
            raise MDSError(EINVAL, f"bad rank {rank}")
        if rank != self.rank and not await self._rank_is_active(rank):
            # a typo'd rank would blackhole the subtree: every client
            # op would redirect to a rank nobody holds
            raise MDSError(EINVAL, f"rank {rank} has no active mds")
        try:
            await self.meta.stat(dirfrag_oid(ino))
        except RadosError as e:
            raise MDSError(ENOENT, f"no dir {ino:x}") \
                if e.rc == ENOENT else e
        if rank != self.rank and await self._covering_snaps(ino):
            # exporting under a LIVE snapshot (formerly declined): the
            # importing rank must adopt the shared snaptable BEFORE
            # authority moves, or its first post-import mutation under
            # the realm would skip the COW freeze — the same required-
            # adoption push mksnap uses for realms that already span
            # ranks (round-4 snaptable adoption; MExportDir + snap
            # realm open in the reference Migrator)
            try:
                await self._require_snap_adoption(rank)
            except MDSError as e:
                raise MDSError(
                    EXDEV, f"rank {rank} could not adopt the live "
                    f"snapshot ({e}); export declined")
        for bp, bn in self._busy_names:
            # a cross-rank rename in flight under the subtree holds
            # only its name pins across the peer RPC; exporting now
            # would let its finish half journal into a foreign dirfrag
            if bp == ino or await self._is_ancestor(ino, bp):
                raise MDSError(
                    EBUSY, f"cross-rank rename in flight under "
                    f"{ino:x} ({bp:x}/{bn})")
        await self._check_no_boundary_anchors(ino)
        for q in self.quotas:
            if q != ino and await self._is_ancestor(q, ino):
                # accounting is single-rank (the setquota EXDEV
                # mirror): a realm must not span the delegation
                raise MDSError(
                    EXDEV, f"subtree lies inside quota realm {q:x}; "
                    "clear the quota or export the realm root")
        # force-revoke EVERY cap this rank granted (no waiting — the
        # holder's flush needs the very lock this export holds): the
        # client flushes on receiving the recall and its setattr
        # follows the post-export redirect.  Conservative (all caps,
        # not just the subtree's) but exports are rare
        for cap_ino in list(self._caps):
            holder = self._caps.pop(cap_ino)
            self._cap_resolve(cap_ino)
            if not holder["conn"].is_closed:
                try:
                    holder["conn"].send_message(
                        Message("cap_recall", {"ino": cap_ino}))
                except ConnectionError:
                    pass
        await self._compact_journal()
        # an entry is only redundant when it matches what the PARENT
        # chain already resolves to; "back to rank 0" under a delegated
        # ancestor needs an explicit {ino: 0} override, not a removal
        parent_auth = 0
        for link in (await self._parent_chain(ino))[1:]:
            r = self._subtrees.get(link)
            if r is not None:
                parent_auth = r
                break
        if rank == parent_auth:
            if ino in self._subtrees:
                await self.meta.operate(
                    SUBTREE_OID, ObjectOperation().omap_rm([str(ino)]))
                self._subtrees.pop(ino, None)
        else:
            await self.meta.operate(
                SUBTREE_OID, ObjectOperation().create()
                .omap_set({str(ino): str(rank).encode()}))
            self._subtrees[ino] = rank
        self._auth_cache.clear()
        self._ftree_cache.clear()
        self._quota_invalidate()
        # the subtree's popularity belongs to the importing rank now —
        # stale pops would inflate my_load (and the balancer's "need")
        # with load this rank no longer serves
        if rank != self.rank:
            for dino in list(self._pop):
                if dino == ino or await self._is_ancestor(ino, dino):
                    self._pop.pop(dino, None)
        # PUSH the new map to every other active rank (MExportDirNotify
        # role): peers adopt the delegation immediately instead of
        # discovering it on their next redirect miss (round-3 weak #5:
        # propagation was refresh-on-redirect only).  Best-effort —
        # redirect-refresh remains the safety net for missed pushes.
        await self._push_subtree_update()
        log.dout(1, "%s: exported dir %x to rank %d", self.entity,
                 ino, rank)
        return {"rank": rank}

    async def _push_subtree_update(self) -> None:
        try:
            r = await self.rados.mon_command("mds stat")
        except (IOError, ConnectionError):
            return
        if r.get("rc") != 0:
            return
        actives = (r["data"]["filesystems"]
                   .get(self.fs_name, {}).get("actives", ()))
        peers = [int(a["rank"]) for a in actives
                 if int(a["rank"]) != self.rank]
        if not peers:
            return
        replies = await asyncio.gather(
            *(self._peer_request(p, {"op": "subtree_refresh"},
                                 timeout=2.0) for p in peers),
            return_exceptions=True)
        for p, rep in zip(peers, replies):
            if isinstance(rep, BaseException):
                log.dout(5, "%s: subtree push to rank %d missed: %s",
                         self.entity, p, rep)

    async def _req_subtree_refresh(self, d: dict) -> dict:
        """Peer push after an export: adopt the shared subtree map NOW
        (throttle bypassed) so the very next client op routes by the
        new delegation."""
        await self._load_subtrees()
        self._auth_cache.clear()
        self._ftree_cache.clear()
        return {}

    # -- client sessions (SessionMap / session evict) ----------------------
    def session_ls(self) -> list[dict]:
        """Live client sessions with the caps each one holds."""
        out = []
        for sid, s in sorted(self._sessions.items()):
            if s["conn"].is_closed:
                continue
            out.append({
                "id": sid, "client": s["client"],
                "opened": s["opened"],
                "num_caps": sum(1 for h in self._caps.values()
                                if h["conn"] is s["conn"]),
            })
        return out

    async def session_evict(self, sid, blocklist=False) -> dict:
        """Evict one client (Server::kill_session): revoke its caps
        (waking any pending recalls) and close its connection — the
        laggy/misbehaving-client remedy.  ``blocklist`` additionally
        fences the client INSTANCE at the OSDs via the OSDMap
        blocklist (the reference evicts this way by default: caps
        alone cannot stop direct RADOS data writes already in
        flight)."""
        s = self._sessions.pop(int(sid), None)
        if s is None:
            return {"evicted": False}
        conn = s["conn"]
        blocked = False
        if blocklist and conn.peer_name:
            # fence BEFORE releasing caps (which wakes recall waiters
            # and grants a new writer), then wait for the fencing
            # epoch to publish — the reference's
            # wait_for_latest_osdmap step after a blocklist.  OSDs
            # still apply the map asynchronously; because ops carry
            # the sender's epoch and OSDs refuse ops newer than their
            # map, a new holder that has the fencing epoch cannot
            # race the evictee on an OSD that has not seen it.
            ent = f"{conn.peer_name}:{conn.peer_nonce}"
            try:
                r = await self.rados.mon_command(
                    "osd blocklist", action="add", entity=ent)
                blocked = r.get("rc") == 0
                if blocked:
                    await self._wait_blocklist_published(ent)
            except (RadosError, ConnectionError, OSError):
                pass          # eviction still proceeds unfenced
        for ino, holder in list(self._caps.items()):
            if holder["conn"] is conn:
                self._caps.pop(ino, None)
                self._cap_resolve(ino)
        conn.mark_down()      # hard close, no replay (kill_session)
        log.dout(1, "%s: evicted client session %s%s", self.entity,
                 s["client"], " (blocklisted)" if blocked else "")
        return {"evicted": True, "client": s["client"],
                "blocklisted": blocked}

    async def _wait_blocklist_published(self, ent: str,
                                        timeout: float = 5.0) -> None:
        """Poll the mon until the fencing entry is visible in the
        published map (bounded; eviction proceeds either way)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                r = await self.rados.mon_command("osd blocklist ls")
            except (RadosError, ConnectionError, OSError):
                return
            if r.get("rc") == 0 and ent in r["data"]["blocklist"]:
                return
            await asyncio.sleep(0.05)

    async def _write_backtrace(self, ino: int, parent: int,
                               name: str,
                               dentry: dict | None = None) -> None:
        """File backtrace sidecar in the DATA pool (the reference
        writes parent/name backtrace xattrs on object 0):
        cephfs-data-scan rebuilds dentries from these when the
        metadata pool is lost.  Symlinks record their target too —
        they have no data objects, so the sidecar is their ONLY
        recoverable trace.  Best effort: data-plane trouble must not
        fail the metadata op."""
        if self.data is None:
            return
        bt = {"parent": parent, "name": name}
        if dentry is not None:
            bt["type"] = dentry.get("type", "file")
            if dentry.get("type") == "symlink":
                bt["target"] = dentry.get("target", "")
        try:
            await self.data.operate(
                backtrace_oid(ino),
                ObjectOperation().create().set_xattr(
                    "backtrace", encode(bt)))
        except RadosError:
            pass

    # -- forward scrub (MDCache scrub + DamageTable roles) -----------------
    def _note_damage(self, dtype: str, ino: int, **info) -> None:
        """Append unless an identical finding (ignoring id/repaired)
        is already tabled — re-scrubbing an unrepaired defect must
        not grow the table (the reference DamageTable dedupes)."""
        sig = {k: v for k, v in info.items() if k != "repaired"}
        for d in self._damage:
            if d["damage_type"] == dtype and d["ino"] == ino \
                    and {k: v for k, v in d.items()
                         if k not in ("id", "damage_type", "ino",
                                      "repaired")} == sig:
                return
        self._damage_seq += 1
        self._damage.append({"id": self._damage_seq,
                             "damage_type": dtype, "ino": ino,
                             **info})

    def damage_ls(self) -> list[dict]:
        return list(self._damage)

    def damage_rm(self, id) -> dict:
        n = len(self._damage)
        self._damage = [d for d in self._damage
                        if d["id"] != int(id)]
        return {"removed": n - len(self._damage)}

    async def scrub_start(self, path: str = "/",
                          repair=False) -> dict:
        """Forward scrub (`ceph tell mds scrub start` role): walk the
        namespace under ``path`` within THIS rank's authority and
        validate the metadata invariants the -lite design maintains —
        dirfrag parent back-pointers match the containing directory,
        child dirfrags exist, remote dentries resolve through a
        consistent anchortable record, and quota-table records/usage
        match a fresh subtree recount.  ``repair=true`` fixes what is
        mechanically fixable (back-pointers, usage cache, records for
        dead dirs); everything found lands in the damage table."""
        repair = repair in (True, "true", "1", 1)
        async with self._mutate:
            return await self._scrub_locked(path, repair)

    async def _scrub_locked(self, path: str, repair: bool) -> dict:
        root = ROOT_INO
        if path not in ("", "/"):
            for part in path.strip("/").split("/"):
                d = await self._get_dentry(root, part)
                if d.get("type") != "dir":
                    raise MDSError(EINVAL,
                                   f"{path!r}: not a directory")
                root = int(d["ino"])
        checked = dirs = 0
        found: list[dict] = []

        def note(dtype: str, ino: int, **info):
            self._note_damage(dtype, ino, **info)
            found.append({"damage_type": dtype, "ino": ino, **info})

        subtree = await self._walk_subtree(root)
        for dino in subtree:
            if await self._auth_rank(dino) != self.rank:
                continue             # a peer rank scrubs its own
            try:
                kv = await self._dir_all(dino)
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                continue
            dirs += 1
            tree = await self._fragtree(dino)
            if tree != [ROOT_FRAG]:
                # every fragtree leaf must have its object (a crashed
                # split's journal replay normally rebuilds these; a
                # lost journal leaves the hole for scrub)
                for fb, fv in tree:
                    try:
                        await self.meta.stat(frag_oid(dino, fb, fv))
                    except RadosError as e:
                        if e.rc != ENOENT:
                            raise
                        note("missing_dirfrag_fragment", dino,
                             frag=f"{fb}_{fv:x}", repaired=repair)
                        if repair:
                            await self.meta.operate(
                                frag_oid(dino, fb, fv),
                                ObjectOperation().create())
            for name, raw in kv.items():
                de = decode(raw)
                checked += 1
                if de.get("type") == "dir":
                    await self._scrub_dir_child(dino, name, de,
                                                repair, note)
                elif de.get("remote"):
                    await self._scrub_remote(dino, name, de,
                                             repair, note)
        await self._scrub_quotas(set(subtree), repair, note)
        return {"scrubbed_dirs": dirs, "checked_dentries": checked,
                "damage": found, "repaired": repair}

    async def _scrub_dir_child(self, parent: int, name: str,
                               de: dict, repair: bool,
                               note) -> None:
        """Child dirfrag must exist and its parent back-pointer must
        name the dirfrag that holds its dentry (the backtrace
        invariant renames maintain)."""
        cino = int(de["ino"])
        corrupt = False
        try:
            raw = await self.meta.get_xattr(dirfrag_oid(cino),
                                            "parent")
            back = int(raw)
        except RadosError as e:
            if e.rc != ENOENT:
                raise
            back = None
        except (ValueError, TypeError):
            # garbage in the xattr is exactly the corruption class
            # scrub exists to find — table it, never abort the walk
            back, corrupt = None, True
        if corrupt:
            note("corrupt_backtrace", cino, parent=parent,
                 name=name, repaired=repair)
            if repair:
                await self.meta.operate(
                    dirfrag_oid(cino),
                    ObjectOperation().set_xattr(
                        "parent", str(parent).encode()))
            return
        if back is None:
            note("missing_dirfrag_or_backtrace", cino,
                 parent=parent, name=name,
                 repaired=repair)
            if repair:
                await self.meta.operate(
                    dirfrag_oid(cino),
                    ObjectOperation().create().set_xattr(
                        "parent", str(parent).encode()))
        elif back != parent:
            note("bad_backtrace", cino, parent=parent, name=name,
                 points_at=back, repaired=repair)
            if repair:
                await self.meta.operate(
                    dirfrag_oid(cino),
                    ObjectOperation().set_xattr(
                        "parent", str(parent).encode()))

    async def _scrub_remote(self, parent: int, name: str, de: dict,
                            repair: bool, note) -> None:
        """A remote dentry must resolve through its anchortable
        record, and the record's primary dentry must really exist
        (the reference scrub's remote-link pass)."""
        ino = int(de["ino"])
        rec = await self._anchor_get(ino)
        listed = rec is not None and (
            [parent, name] in [list(r) for r in
                               rec.get("remotes", ())])
        primary_ok = False
        if rec is not None and rec.get("primary"):
            pp, pn = rec["primary"]
            try:
                pd = await self._get_dentry(int(pp), str(pn))
                primary_ok = int(pd.get("ino", 0)) == ino                     and not pd.get("remote")
            except MDSError:
                primary_ok = False
        if rec is not None and primary_ok and not listed:
            # primary fine, this name just fell off the listing: the
            # LEAST destructive repair is to restore the listing
            note("unlisted_remote", ino, parent=parent, name=name,
                 repaired=repair)
            if repair:
                rec.setdefault("remotes", []).append([parent, name])
                rec.pop("v", None)      # live repair: bump past stored
                await self._anchor_put(ino, rec)
            return
        if rec is not None and listed and not primary_ok:
            # the PRIMARY is the casualty, not this name: deleting a
            # working remote would orphan the data — promote it
            note("dead_primary", ino, parent=parent, name=name,
                 repaired=repair)
            if repair:
                size = await self._size_from_data(ino)
                promoted = _dentry(ino, "file", 0o644, size)
                await self._set_dentry(parent, name, promoted)
                # the promoted name is the backtraced home now — a
                # stale sidecar would let data-scan resurrect the
                # dead primary's old name
                await self._write_backtrace(ino, parent, name,
                                            promoted)
                rec["primary"] = [parent, name]
                rec["remotes"] = [
                    r for r in rec.get("remotes", ())
                    if list(r) != [parent, name]]
                rec.pop("v", None)      # live repair: bump past stored
                if rec["remotes"]:
                    await self._anchor_put(ino, rec)
                else:
                    await self._anchor_put(ino, None)
            return
        if rec is None or (not listed and not primary_ok):
            # no anchor record at all, or a record that neither lists
            # this name nor backs a live primary: nothing resolvable
            # remains behind the remote — it is dead weight
            note("dangling_remote", ino, parent=parent, name=name,
                 anchored=rec is not None, repaired=repair)
            if repair:
                await self._rm_dentry(parent, name)

    async def _size_from_data(self, ino: int) -> int:
        """Recover a file's size from its data blocks (repair-path
        only: O(pool listing))."""
        best = 0
        prefix = f"{ino:x}."
        for oid in await self.data.list_objects():
            if not oid.startswith(prefix) or oid.endswith(".bt"):
                continue
            try:
                block = int(oid[len(prefix):], 16)
            except ValueError:
                continue
            st = await self.data.stat(oid)
            best = max(best, block * self.block_size
                       + int(st.get("size", 0)))
        return best

    async def _scrub_quotas(self, subtree: set[int], repair: bool,
                            note) -> None:
        """Quota records must point at live directories and cached
        usage must match a fresh recount (rstat consistency).  Only
        realms inside the scrubbed subtree are touched — a scoped
        scrub must not mutate state it was not asked to visit.
        Exception: a record for a DEAD directory is checked from any
        scope that could never walk to it anyway."""
        for qino, lim in list(self.quotas.items()):
            if await self._auth_rank(qino) != self.rank:
                continue
            if qino not in subtree and ROOT_INO not in subtree:
                continue
            try:
                await self.meta.stat(dirfrag_oid(qino))
                alive = True
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                alive = False
            if not alive:
                note("quota_record_for_dead_dir", qino,
                     limits=dict(lim), repaired=repair)
                if repair:
                    await self._quota_drop(qino)
                continue
            cached = self._qusage.get(qino)
            fresh = await self._compute_usage(qino)
            if cached is not None and cached != fresh:
                note("quota_usage_drift", qino, cached=dict(cached),
                     actual=dict(fresh), repaired=repair)
                if repair:
                    self._qusage[qino] = fresh

    # -- balancer (MDBalancer.h:33 + MHeartbeat load exchange) -------------
    def _decay_pops(self) -> None:
        """Lazy exponential decay of the whole popularity map
        (DecayCounter role with a single shared stamp)."""
        now = time.monotonic()
        half = self.conf["mds_decay_halflife"]
        dt = now - self._pop_stamp
        if dt < half / 8:
            return
        f = 0.5 ** (dt / half)
        self._pop = {i: p * f for i, p in self._pop.items()
                     if p * f > 0.01}
        self._pop_stamp = now

    def _note_pop(self, dino: int) -> None:
        self._decay_pops()
        self._pop[dino] = self._pop.get(dino, 0.0) + 1.0

    def my_load(self) -> float:
        """This rank's decayed request load (mds_load_t role)."""
        self._decay_pops()
        return sum(self._pop.values())

    async def _req_get_load(self, d: dict) -> dict:
        """Rank-to-rank load exchange (the MHeartbeat role: the
        balancing rank polls instead of every rank broadcasting)."""
        return {"load": self.my_load()}

    # -- directory quotas (quota_info_t + rstat accounting, -lite) ---------
    async def _quota_drop(self, ino: int) -> None:
        """A quota'd directory was removed (rmdir / replaced-empty-dir
        purge): its record must die with it, or the table leaks an
        entry the realm-split export check iterates forever."""
        if ino not in self.quotas:
            return
        await self.meta.operate(
            QUOTATABLE_OID,
            ObjectOperation().create().omap_rm([str(ino)]))
        self.quotas.pop(ino, None)
        self._qusage.pop(ino, None)

    async def _quota_roots(self, dino: int) -> list[int]:
        """Quota realms covering directory ``dino`` (every ancestor
        with a quota record, itself included)."""
        if not self.quotas:
            return []
        return [link for link in await self._parent_chain(dino)
                if link in self.quotas]

    async def _quota_usage(self, qino: int) -> dict:
        """Cached {bytes, files} under quota root ``qino``; first use
        walks the subtree (files + dirs count as entries, like
        rfiles+rsubdirs), then per-op increments keep it current."""
        u = self._qusage.get(qino)
        if u is not None:
            return u
        u = await self._compute_usage(qino)
        self._qusage[qino] = u
        return u

    async def _compute_usage(self, qino: int) -> dict:
        total = files = 0
        for dino in await self._walk_subtree(qino):
            try:
                kv = await self._dir_all(dino)
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
                continue
            for raw in kv.values():
                de = decode(raw)
                files += 1
                if de.get("type") == "file" \
                        and not de.get("remote"):
                    total += int(de.get("size", 0))
        return {"bytes": total, "files": files}

    async def _quota_check(self, dino: int, add_files: int = 0,
                           add_bytes: int = 0,
                           roots: list[int] | None = None
                           ) -> list[int]:
        """EDQUOT when the op would push any covering realm over its
        limit; returns the realms so the caller can charge them after
        the apply.  ``roots``: check these realms instead of dino's
        full chain (renames charge only the NET-GAINING realms)."""
        if roots is None:
            roots = await self._quota_roots(dino)
        for q in roots:
            lim = self.quotas[q]
            u = await self._quota_usage(q)
            if add_files > 0 and int(lim.get("max_files", 0)) \
                    and u["files"] + add_files > lim["max_files"]:
                raise MDSError(EDQUOT,
                               f"quota max_files exceeded on {q:x}")
            if add_bytes > 0 and int(lim.get("max_bytes", 0)) \
                    and u["bytes"] + add_bytes > lim["max_bytes"]:
                raise MDSError(EDQUOT,
                               f"quota max_bytes exceeded on {q:x}")
        return roots

    def _quota_charge(self, roots: list[int], files: int = 0,
                      nbytes: int = 0) -> None:
        for q in roots:
            u = self._qusage.get(q)
            if u is not None:
                u["files"] += files
                u["bytes"] += nbytes

    def _quota_invalidate(self) -> None:
        """Renames/imports/exports move whole subtrees between realms:
        recount lazily instead of computing subtree deltas."""
        self._qusage.clear()

    async def _req_setquota(self, d: dict) -> dict:
        """Set/clear a directory quota (the client setfattr
        ceph.quota.* surface)."""
        ino = int(d["ino"])
        try:
            await self.meta.stat(dirfrag_oid(ino))
        except RadosError as e:
            raise MDSError(ENOENT, f"no dir {ino:x}") \
                if e.rc == ENOENT else e
        max_bytes = max(0, int(d.get("max_bytes", 0)))
        max_files = max(0, int(d.get("max_files", 0)))
        for s, r in self._subtrees.items():
            if r != self.rank and await self._is_ancestor(ino, s):
                raise MDSError(
                    EXDEV, f"subtree {s:x} inside the quota realm is "
                    f"delegated to rank {r}; quota accounting is "
                    "single-rank")
        entry = {"op": "setquota", "ino": ino,
                 "max_bytes": max_bytes, "max_files": max_files}
        await self._journal(entry)
        await self._apply(entry)
        return {"quota": self.quotas.get(ino,
                                         {"max_bytes": 0,
                                          "max_files": 0})}

    async def _req_getquota(self, d: dict) -> dict:
        ino = int(d["ino"])
        q = self.quotas.get(ino)
        if q is None:
            # usage is still answered (uncached walk): resize
            # --no-shrink and `subvolume info` need it regardless of
            # whether a limit is currently set
            return {"quota": {"max_bytes": 0, "max_files": 0},
                    "usage": await self._compute_usage(ino)}
        return {"quota": q, "usage": await self._quota_usage(ino)}

    # -- file write caps (Locker/Capability, the -lite slice) --------------
    async def _cap_recall(self, ino: int,
                          timeout: float = 3.0) -> None:
        """Ask the holder to flush + release; force-revoke on timeout
        or a dead connection (the reference's laggy-client cap
        revocation)."""
        holder = self._caps.get(ino)
        if holder is None:
            return
        conn = holder["conn"]
        if not conn.is_closed:
            fut = asyncio.get_running_loop().create_future()
            waiters = self._cap_waiters.setdefault(ino, [])
            waiters.append(fut)
            try:
                conn.send_message(Message("cap_recall", {"ino": ino}))
                await asyncio.wait_for(fut, timeout)
            except (ConnectionError, asyncio.TimeoutError):
                pass
            finally:
                # remove only OUR future; a concurrent recall of the
                # same ino keeps its own (single-slot clobbering made
                # the second opener burn the full timeout)
                if fut in self._cap_waiters.get(ino, ()):
                    self._cap_waiters[ino].remove(fut)
                if not self._cap_waiters.get(ino):
                    self._cap_waiters.pop(ino, None)
        if self._caps.get(ino) is holder:
            # pop only the grant WE recalled: the table may already
            # carry a fresh grant made while this recall waited
            self._caps.pop(ino, None)

    def _cap_resolve(self, ino: int) -> None:
        for fut in self._cap_waiters.pop(ino, ()):
            if not fut.done():
                fut.set_result(None)

    async def _req_open_file(self, d: dict) -> dict:
        """Open-time cap negotiation: a WRITE open takes the file's
        exclusive buffered-write cap (recalling any other holder
        first); a READ open just recalls — the holder's buffered bytes
        and size must be flushed before the reader looks."""
        parent, name = int(d["parent"]), str(d["name"])
        conn = d.get("_conn")

        async def fresh() -> dict:
            # reply attrs must be the PRIMARY's (a remote stub has no
            # size), post-flush when a recall just happened
            de = await self._get_dentry(parent, name)
            return (await self._resolve_remote(de)
                    if de.get("remote") else de)

        dentry = await self._get_dentry(parent, name)
        if dentry["type"] != "file":
            raise MDSError(EISDIR, name)
        ino = int(dentry["ino"])    # remote stub shares the link ino
        if not d.get("write"):
            holder = self._caps.get(ino)
            if holder is not None and holder["conn"] is not conn:
                await self._cap_recall(ino)
            return {"cap": "r", "dentry": await fresh()}
        for _ in range(8):        # bounded: each pass evicts a holder
            holder = self._caps.get(ino)
            if holder is None or holder["conn"].is_closed \
                    or holder["conn"] is conn:
                self._caps[ino] = {"conn": conn,
                                   "holder": str(d.get("who", ""))}
                return {"cap": "w", "dentry": await fresh()}
            await self._cap_recall(ino)
        raise MDSError(EBUSY, f"cap on {ino:x} cannot be claimed")

    async def _req_release_cap(self, d: dict) -> dict:
        ino = int(d.get("ino", 0))
        holder = self._caps.get(ino)
        if holder is not None and holder["conn"] is d.get("_conn"):
            self._caps.pop(ino, None)
            self._cap_resolve(ino)
        return {}

    async def _balance_loop(self) -> None:
        interval = self.conf["mds_bal_interval"]
        while True:
            await asyncio.sleep(interval)
            try:
                await self.balance_once()
            except (MDSError, RadosError, ConnectionError, OSError):
                pass              # transient peer/mon trouble: next tick

    async def balance_once(self) -> dict | None:
        """One balancer pass (MDBalancer::tick + prep_rebalance): poll
        the other actives' loads; when this rank carries more than its
        share of the decayed request load, export the subtree whose
        aggregated popularity best matches the excess to the
        least-loaded rank.  Returns {ino, rank, load} on export."""
        r = await self.rados.mon_command("mds stat")
        if r.get("rc") != 0:
            return None
        actives = (r["data"]["filesystems"]
                   .get(self.fs_name, {}).get("actives", ()))
        if len(actives) < 2:
            return None
        peers = [int(a["rank"]) for a in actives
                 if int(a["rank"]) != self.rank]
        replies = await asyncio.gather(
            *(self._peer_request(r, {"op": "get_load"}, timeout=5.0)
              for r in peers), return_exceptions=True)
        loads: dict[int, float] = {self.rank: self.my_load()}
        for rank, rep in zip(peers, replies):
            if isinstance(rep, BaseException) or rep.get("rc") != 0:
                return None   # a blind rebalance could thrash: skip
            loads[rank] = float(rep.get("load", 0.0))
        if not any(int(a["rank"]) == self.rank for a in actives):
            return None
        mean = sum(loads.values()) / len(loads)
        need = loads[self.rank] - mean
        if need < max(self.conf["mds_bal_min_start"],
                      mean * self.conf["mds_bal_min_rebalance"]):
            return None
        target = min((r for r in loads if r != self.rank),
                     key=lambda r: (loads[r], r))
        return await self._export_for_balance(need, target)

    async def _export_for_balance(self, need: float,
                                  target: int) -> dict | None:
        """Aggregate per-directory popularity up the ancestry (within
        this rank's authority) and export the subtree whose load is
        closest to ``need``.  Candidates that cannot export (live
        snapshot realm, boundary anchors, a concurrent rename) are
        skipped, not fatal."""
        self._decay_pops()
        agg: dict[int, float] = {}
        for dino, p in list(self._pop.items()):
            for link in await self._parent_chain(dino):
                if await self._auth_rank(link) != self.rank:
                    break         # left our territory
                agg[link] = agg.get(link, 0.0) + p
        # strict improvement only: moving load L changes this rank's
        # deviation from need to |need - L|, so 0 < L < 2*need shrinks
        # it — and the < bound is the anti-ping-pong hysteresis (once
        # balanced, re-exporting the same subtree can't improve)
        cands = [(i, load) for i, load in agg.items()
                 if i != ROOT_INO and need * 0.25 <= load < need * 2]
        cands.sort(key=lambda kv: (abs(kv[1] - need), kv[0]))
        for ino, load in cands:
            try:
                async with self._mutate:
                    await self._req_export_dir(
                        {"ino": ino, "rank": target})
            except (MDSError, RadosError):
                continue          # snaps/anchors/rename races: next
            log.dout(1, "%s: balancer exported %x (load %.1f) to "
                     "rank %d", self.entity, ino, load, target)
            return {"ino": ino, "rank": target, "load": load}
        return None

    async def _active_entry(self, rank: int) -> dict | None:
        """This fs's fsmap entry for an active ``rank``, or None."""
        try:
            r = await self.rados.mon_command("mds stat")
        except (ConnectionError, OSError):
            return None
        if r.get("rc") != 0:
            return None
        for a in (r["data"]["filesystems"]
                  .get(self.fs_name, {}).get("actives", ())):
            if int(a.get("rank", -1)) == rank:
                return a
        return None

    async def _rank_addr(self, rank: int) -> str:
        a = await self._active_entry(rank)
        if a is None:
            raise MDSError(EXDEV, f"rank {rank} has no active mds")
        return str(a["addr"])

    # -- cross-rank rename commit log (atomic cls rename_wal ops) ----------
    async def _rename_mark_commit(self, token: str) -> bool:
        """Atomically claim the commit marker; False when the source
        already claimed abort.  Errors other than the abort verdict
        propagate — a transient read failure must retry, not silently
        decide the race."""
        import json as _json

        try:
            await self.meta.exec(
                RENAME_LOG_OID, "rename_wal", "commit",
                _json.dumps({"token": token}).encode())
            return True
        except RadosError as e:
            if e.rc == ECANCELED:
                return False
            raise

    async def _rename_resolve_abort(self, token: str) -> bool:
        """Atomically: claim the abort marker unless the commit marker
        exists.  Returns True when the rename COMMITTED."""
        import json as _json

        out = await self.meta.exec(
            RENAME_LOG_OID, "rename_wal", "abort",
            _json.dumps({"token": token}).encode())
        return bool(_json.loads(out)["committed"])

    async def _rename_marker_state(self, token: str) -> dict:
        import json as _json

        out = await self.meta.exec(
            RENAME_LOG_OID, "rename_wal", "get",
            _json.dumps({"token": token}).encode())
        return _json.loads(out)

    async def _rename_clear(self, token: str) -> None:
        import json as _json

        try:
            await self.meta.exec(
                RENAME_LOG_OID, "rename_wal", "clear",
                _json.dumps({"token": token}).encode())
        except RadosError:
            pass                      # gc sweeps leaks

    async def _peer_request(self, rank: int, payload: dict,
                            timeout: float = 10.0) -> dict:
        """One request to a peer active rank (slave-request role,
        reference MMDSSlaveRequest): same wire op surface a client
        uses, awaited by tid.  The timeout also breaks the theoretical
        deadlock of two opposite-direction cross-rank renames each
        holding its own rank's mutate lock."""
        addr = await self._rank_addr(rank)
        self._peer_tid += 1
        tid = self._peer_tid
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._peer_pending[tid] = fut
        try:
            await self.msgr.send_to(
                addr, Message("mds_request", {**payload, "tid": tid}),
                f"mds-rank{rank}",
            )
            return await asyncio.wait_for(fut, timeout)
        except (ConnectionError, asyncio.TimeoutError) as e:
            raise MDSError(EXDEV,
                           f"rank {rank} unreachable: {e!r}") from None
        finally:
            self._peer_pending.pop(tid, None)

    async def _rank_is_active(self, rank: int) -> bool:
        return await self._active_entry(rank) is not None

    async def _check_no_boundary_anchors(self, ino: int) -> None:
        """Hard links whose names straddle the export boundary would
        put the primary and remotes under different authorities (the
        same hazard the EXDEV link guard prevents going forward)."""
        try:
            omap = await self.meta.get_omap(ANCHOR_OID)
        except RadosError as e:
            if e.rc == ENOENT:
                return
            raise
        for raw in omap.values():
            rec = decode(raw)
            if rec.get("dead"):
                continue          # versioned tombstone, not a link
            names = [rec["primary"]] + list(rec.get("remotes", ()))
            inside = []
            for p, _ in names:
                p = int(p)
                inside.append(p == ino
                              or await self._is_ancestor(ino, p))
            if any(inside) and not all(inside):
                raise MDSError(
                    EBUSY, "a hard link spans the export boundary; "
                    "unlink it first")

    async def _req_rmsnap(self, d: dict) -> dict:
        ino, name = int(d["ino"]), str(d["name"])
        snapid = next((sid for sid, i in self.snaps.items()
                       if i["name"] == name and int(i["ino"]) == ino),
                      None)
        if snapid is None:
            raise MDSError(ENOENT, f"no snap {name!r}")
        entry = {"op": "rmsnap", "snapid": snapid, "ino": ino}
        await self._journal(entry)
        await self._apply(entry)
        # drop the dead snapid from spanning ranks' snapc too (best-
        # effort: a stale entry only costs wasted freezes, never
        # correctness; boot reload heals it)
        for s, r in self._subtrees.items():
            if r != self.rank and (s == ino
                                   or await self._is_ancestor(ino, s)):
                try:
                    await self._peer_request(
                        r, {"op": "snap_refresh"}, timeout=2.0)
                except MDSError:
                    pass
        return {"snapc": self._snapc_wire()}

    async def _req_lssnap(self, d: dict) -> dict:
        ino = int(d["ino"])
        return {"snaps": {
            i["name"]: {"snapid": sid, "created": i["created"]}
            for sid, i in self.snaps.items() if int(i["ino"]) == ino
        }, "snapc": self._snapc_wire()}

    async def _req_link(self, d: dict) -> dict:
        """Hard link (Server::handle_client_link): a REMOTE dentry at
        (parent, name) referencing the primary's inode.  Routed by the
        SOURCE parent, so the primary's rank runs this; a foreign
        destination parent runs the witness-lite export protocol
        (an import_link peer request gated by the atomic commit
        marker), keeping every anchor write on the primary's rank."""
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["parent"]), str(d["name"])
        async with self._mutate:
            # authority may have moved while this op queued on the
            # lock (a balancer export): re-check, as the locked
            # handler branch does for other mutations
            await self._check_auth(d, "link")
            self._guard_busy((sp, sn), (dp, dn))
            dentry = await self._get_dentry(sp, sn)
            if dentry.get("remote"):
                # keep link chains flat: always link to the primary
                sp, sn, dentry = await self._primary_of(
                    int(dentry["ino"]))
                if await self._auth_rank(sp) != self.rank:
                    raise MDSError(
                        EXDEV, "link through a foreign primary; "
                        "link from the primary name instead")
                # the primary name itself may be pinned by another
                # in-flight cross-rank link/unlink
                self._guard_busy((sp, sn))
            if dentry["type"] != "file":
                raise MDSError(EPERM, "hard links are file-only")
            ino = int(dentry["ino"])
            primary = dict(dentry)
            primary["nlink"] = int(dentry.get("nlink", 1)) + 1
            rec = await self._anchor_get(ino)
            base = rec or {"primary": [sp, sn], "remotes": []}
            anchor = await self._anchor_next(ino, {
                "primary": base["primary"],
                "remotes": list(base["remotes"]) + [[dp, dn]],
            })
            dst_rank = await self._auth_rank(dp)
            if dst_rank == self.rank:
                await self._ensure_absent(dp, dn)
                qroots = await self._quota_check(dp, add_files=1)
                entry = {"op": "link", "parent": dp, "name": dn,
                         "ino": ino,
                         "remote_dentry": {"type": "file",
                                           "remote": True,
                                           "ino": ino},
                         "pp": sp, "pn": sn,
                         "primary_dentry": primary, "anchor": anchor}
                await self._journal(entry)
                await self._apply(entry)
                self._quota_charge(qroots, files=1)
                await self._maybe_compact()
                return {"dentry": {**primary, "remote": True}}
            # cross-rank: intent first, RPC without the lock
            token = secrets.token_hex(8)
            await self._journal({
                "op": "link_export_intent", "pp": sp, "pn": sn,
                "parent": dp, "name": dn, "ino": ino,
                "token": token})
            self._busy_names.add((sp, sn))
        try:
            return await self._link_cross_rank_finish(
                sp, sn, dp, dn, ino, primary, anchor, dst_rank, token)
        finally:
            self._busy_names.discard((sp, sn))

    async def _link_cross_rank_finish(self, sp, sn, dp, dn, ino,
                                      primary, anchor, dst_rank,
                                      token) -> dict:
        await self._two_phase_finish(
            dst_rank,
            {"op": "import_link", "parent": dp, "name": dn,
             "remote_dentry": {"type": "file", "remote": True,
                               "ino": ino},
             "token": token},
            token,
            {"op": "link_export_abort", "ino": ino, "token": token},
            {"op": "link_export_finish", "pp": sp, "pn": sn,
             "ino": ino, "primary_dentry": primary,
             "anchor": anchor, "token": token},
            "destination rank unreachable; link rolled back")
        return {"dentry": {**primary, "remote": True}}

    async def _req_import_link(self, d: dict) -> dict:
        """Cross-rank link, DESTINATION half: materialize the remote
        dentry in a directory this rank serves, gated by the commit
        marker exactly like import_dentry."""
        dp, dn = int(d["parent"]), str(d["name"])
        token = str(d.get("token", ""))
        try:
            dst = await self._get_dentry(dp, dn)
            if int(dst.get("ino", 0)) == \
                    int(dict(d["remote_dentry"])["ino"]) \
                    and dst.get("remote") and token and \
                    (await self._rename_marker_state(token)
                     ).get("committed"):
                # a RETRY of this very request (token committed);
                # a fresh link() to an occupied name is EEXIST like
                # the same-rank path — treating it as done would
                # double-count nlink at the primary's finish
                return {"dentry": dst}
            raise MDSError(EEXIST, dn)
        except MDSError as e:
            if not e.missing_dentry:
                raise
        qroots = await self._quota_check(dp, add_files=1)
        entry = {"op": "import_link", "parent": dp, "name": dn,
                 "ino": int(dict(d["remote_dentry"])["ino"]),
                 "remote_dentry": dict(d["remote_dentry"]),
                 "token": token}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_charge(qroots, files=1)
        if token:
            state = await self._rename_marker_state(token)
            if not state.get("committed"):
                raise MDSError(EXDEV,
                               "link aborted by the source rank")
        return {"dentry": dict(d["remote_dentry"])}

    async def _req_unlink(self, d: dict) -> dict:
        """Unlink — self-managed locking: a remote dentry whose
        primary lives on another rank runs the witness-lite
        update_primary protocol (nlink/anchor mutate on the primary's
        rank, name removal here), releasing the lock across the RPC."""
        parent, name = int(d["parent"]), str(d["name"])
        cross = None
        async with self._mutate:
            # re-check: a balancer export may have moved authority
            # while this op queued on the lock
            await self._check_auth(d, "unlink")
            self._guard_busy((parent, name))
            dentry = await self._get_dentry(parent, name)
            if dentry["type"] == "dir":
                raise MDSError(EISDIR, name)
            ino = int(dentry["ino"])
            if dentry.get("remote"):
                rec = await self._anchor_get(ino)
                if rec is not None:
                    pp, pn = int(rec["primary"][0]), \
                        str(rec["primary"][1])
                    prim_rank = await self._auth_rank(pp)
                    if prim_rank != self.rank:
                        token = secrets.token_hex(8)
                        await self._journal({
                            "op": "unlink_remote_intent",
                            "parent": parent, "name": name,
                            "ino": ino, "pp": pp, "pn": pn,
                            "token": token})
                        self._busy_names.add((parent, name))
                        cross = (token, prim_rank, pp)
            elif int(dentry.get("nlink", 1)) > 1:
                # unlinking a PRIMARY whose first remote lives on a
                # foreign rank: the promotion (primary dentry + anchor
                # move to the remote's rank) runs the witness-lite
                # two-phase protocol instead of declining (round-3
                # weak #5 closed for the direct-unlink case)
                rec = await self._anchor_get(ino)
                if rec is not None and rec["remotes"]:
                    np, nn = int(rec["remotes"][0][0]), \
                        str(rec["remotes"][0][1])
                    rem_rank = await self._auth_rank(np)
                    if rem_rank != self.rank:
                        nl = int(dentry.get("nlink", 1))
                        promoted = dict(dentry)
                        promoted["nlink"] = nl - 1
                        promoted.pop("remote", None)
                        new_rec = await self._anchor_next(
                            ino, None if nl - 1 <= 1 else
                            {"primary": [np, nn],
                             "remotes": rec["remotes"][1:]})
                        token = secrets.token_hex(8)
                        await self._journal({
                            "op": "promote_export_intent",
                            "parent": parent, "name": name,
                            "ino": ino, "np": np, "nn": nn,
                            "token": token})
                        self._busy_names.add((parent, name))
                        cross = ("promote", token, rem_rank, np, nn,
                                 promoted, new_rec)
            if cross is None:
                await self._plan_unlink_guard(dentry)
                entry = await self._unlink_plan(parent, name, dentry)
                await self._journal(entry)
                await self._apply(entry)
                if entry["op"] == "promote_link":
                    # the primary dentry (and its bytes) moved into
                    # the promoted remote's directory: realms crossed
                    self._quota_invalidate()
                else:
                    self._quota_charge(
                        await self._quota_roots(parent), files=-1,
                        nbytes=-(int(entry.get("size", 0))
                                 if entry["op"] == "unlink" else 0))
                await self._maybe_compact()
                return {"ino": ino}
        if cross[0] == "promote":
            _, token, rem_rank, np, nn, promoted, new_rec = cross
            try:
                return await self._promote_export_cross(
                    parent, name, ino, rem_rank, np, nn, promoted,
                    new_rec, token)
            finally:
                self._busy_names.discard((parent, name))
        token, prim_rank, pp = cross
        try:
            return await self._unlink_remote_cross(
                parent, name, ino, pp, prim_rank, token)
        finally:
            self._busy_names.discard((parent, name))

    async def _promote_export_cross(self, parent: int, name: str,
                                    ino: int, rem_rank: int, np: int,
                                    nn: str, promoted: dict,
                                    new_rec, token: str) -> dict:
        """Cross-rank link promotion: the remote's rank adopts the
        primary dentry + anchor under the commit claim; this rank's
        finish drops the old primary NAME only (the inode lives on
        under the new primary — no purge)."""
        await self._two_phase_finish(
            rem_rank,
            {"op": "import_promoted", "parent": np, "name": nn,
             "ino": ino, "primary_dentry": promoted,
             "anchor": new_rec, "token": token},
            token,
            {"op": "promote_export_abort", "ino": ino,
             "token": token},
            {"op": "promote_export_finish", "parent": parent,
             "name": name, "ino": ino, "token": token},
            "remote rank unreachable; unlink rolled back")
        # the primary (and its bytes) moved into the remote's realm
        self._quota_invalidate()
        return {"ino": ino}

    async def _req_import_promoted(self, d: dict) -> dict:
        """Peer half of the cross-rank promotion (routed by the remote
        name's parent, so _check_auth enforces OUR authority): replace
        the remote dentry with the promoted primary, adopt the anchor.
        Claim-gated exactly like import_dentry/import_link."""
        np, nn = int(d["parent"]), str(d["name"])
        token = str(d.get("token", ""))
        try:
            cur = await self._get_dentry(np, nn)
        except MDSError as e:
            if not e.missing_dentry:
                raise
            raise MDSError(ENOENT, f"remote name {nn!r} vanished")
        if int(cur.get("ino", 0)) != int(d["ino"]):
            raise MDSError(EINVAL,
                           "dentry no longer names the expected inode")
        if not cur.get("remote"):
            return {"dentry": cur}      # retried import: already done
        entry = {"op": "import_promoted", "parent": np, "name": nn,
                 "ino": int(d["ino"]),
                 "primary_dentry": dict(d["primary_dentry"]),
                 "anchor": d.get("anchor"), "token": token}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_invalidate()
        if token:
            state = await self._rename_marker_state(token)
            if not state.get("committed"):
                raise MDSError(EXDEV,
                               "promotion aborted by the source rank")
        return {"dentry": dict(d["primary_dentry"])}

    async def _unlink_remote_cross(self, parent: int, name: str,
                                   ino: int, pp: int, prim_rank: int,
                                   token: str) -> dict:
        await self._two_phase_finish(
            prim_rank,
            {"op": "update_primary", "parent": pp, "ino": ino,
             "drop_remote": [parent, name], "token": token},
            token,
            {"op": "unlink_remote_abort", "ino": ino,
             "token": token},
            {"op": "unlink_remote_finish", "parent": parent,
             "name": name, "ino": ino, "token": token},
            "primary rank unreachable; unlink rolled back")
        self._quota_charge(await self._quota_roots(parent), files=-1)
        return {"ino": ino}

    async def _req_update_primary(self, d: dict) -> dict:
        """Cross-rank remote-unlink, PRIMARY half: decrement nlink and
        drop the remote name from the anchor, gated by the commit
        marker (slave-commit role).  Routed by ``parent`` (the
        primary's directory) so this rank's authority is enforced;
        runs under the normal handler lock."""
        ino = int(d["ino"])
        drop = [int(d["drop_remote"][0]), str(d["drop_remote"][1])]
        token = str(d.get("token", ""))
        rec = await self._anchor_get(ino)
        if rec is None:
            raise MDSError(ENOENT, f"no anchor for {ino:x}")
        pp, pn = int(rec["primary"][0]), str(rec["primary"][1])
        self._guard_busy((pp, pn))
        primary = dict(await self._get_dentry(pp, pn))
        remotes = [[int(r[0]), str(r[1])] for r in rec["remotes"]]
        if drop not in remotes:
            # retried request whose first attempt already applied
            if token and (await self._rename_marker_state(token)
                          ).get("committed"):
                return {"dentry": primary}
            raise MDSError(ENOENT, f"{drop} not a link of {ino:x}")
        nl = int(primary.get("nlink", 1)) - 1
        primary["nlink"] = nl
        kept = [r for r in remotes if r != drop]
        anchor = await self._anchor_next(
            ino, None if nl <= 1 else
            {"primary": [pp, pn], "remotes": kept})
        entry = {"op": "update_primary", "pp": pp, "pn": pn,
                 "ino": ino, "primary_dentry": primary,
                 "anchor": anchor, "token": token}
        await self._journal(entry)
        await self._apply(entry)
        if token:
            state = await self._rename_marker_state(token)
            if not state.get("committed"):
                raise MDSError(EXDEV,
                               "unlink aborted by the remote's rank")
        return {"dentry": primary}

    async def _req_rmdir(self, d: dict) -> dict:
        parent, name = int(d["parent"]), str(d["name"])
        self._guard_busy((parent, name))
        dentry = await self._get_dentry(parent, name)
        if dentry["type"] != "dir":
            raise MDSError(ENOTDIR, name)
        if int(dentry["ino"]) in self._subtrees:
            raise MDSError(EBUSY, f"{name!r} is a subtree export root")
        kv = await self._dir_all(int(dentry["ino"]))
        if kv:
            raise MDSError(ENOTEMPTY, name)
        entry = {"op": "rmdir", "parent": parent, "name": name,
                 "ino": int(dentry["ino"])}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_charge(await self._quota_roots(parent), files=-1)
        return {}

    async def _is_ancestor(self, ino: int, of: int) -> bool:
        """Walk ``of``'s parent chain to the root looking for ``ino``
        (Server::handle_client_rename's subtree check)."""
        cur = of
        hops = 0
        while cur != ROOT_INO and hops < 4096:
            if cur == ino:
                return True
            try:
                raw = await self.meta.get_xattr(dirfrag_oid(cur),
                                                "parent")
            except RadosError:
                return False
            cur = int(raw)
            hops += 1
        return cur == ino

    async def _req_import_dentry(self, d: dict) -> dict:
        """Cross-rank rename, DESTINATION half (witness-lite slave
        request, reference Server::handle_slave_rename_prep role):
        link an existing inode's dentry into a directory this rank is
        authoritative over, applying POSIX rename overwrite semantics
        to any existing destination.  Routed by ``parent`` so
        _check_auth enforces authority; journaled locally."""
        dp, dn = int(d["parent"]), str(d["name"])
        dentry = dict(d["dentry"])
        token = str(d.get("token", ""))
        is_dir = dentry.get("type") == "dir"
        if is_dir:
            # destination-side re-validation with THIS rank's view:
            # the source checked too, but its snap table only holds
            # realms it serves — a snapshot rooted in OUR territory is
            # invisible to it
            if await self._covering_snaps(dp):
                raise MDSError(
                    EXDEV, "cross-rank directory rename under a "
                    "live snapshot")
            if await self._is_ancestor(int(dentry["ino"]), dp):
                raise MDSError(EINVAL,
                               "cannot move a directory into itself")
        purge_ino = purge_size = purge_dir_ino = 0
        unlinked_ino = 0
        pre = None
        try:
            dst = await self._get_dentry(dp, dn)
        except MDSError as e:
            if not e.missing_dentry:
                raise
            dst = None
        if dst is not None:
            if is_dir:
                if dst["type"] != "dir":
                    raise MDSError(ENOTDIR, dn)
                if int(dst["ino"]) == int(dentry["ino"]):
                    if token and not (await self._rename_marker_state(
                            token)).get("committed"):
                        # FRESH request, not a retry: a same-ino dst
                        # appeared — acking without committing would
                        # make the source drop its name (orphan)
                        raise MDSError(EEXIST,
                                       f"{dn!r} already names the "
                                       "inode")
                    return {"dentry": dst}  # retried import: done
                if int(dst["ino"]) in self._subtrees:
                    raise MDSError(
                        EBUSY, f"{dn!r} is a subtree export root")
                if await self._dir_all(int(dst["ino"])):
                    raise MDSError(ENOTEMPTY, dn)
                purge_dir_ino = int(dst["ino"])   # replaced empty dir
            elif dst["type"] == "dir":
                raise MDSError(EISDIR, dn)
            elif int(dst["ino"]) == int(dentry["ino"]):
                if token and not (await self._rename_marker_state(
                        token)).get("committed"):
                    raise MDSError(EEXIST,
                                   f"{dn!r} already names the inode")
                return {"dentry": dst}      # retried import: done
            elif dst.get("remote") or int(dst.get("nlink", 1)) > 1:
                # replaced hardlinked dst: the link-aware unlink rides
                # INSIDE the import entry so it only applies once the
                # commit claim wins (an aborted import must not have
                # unlinked anything)
                await self._plan_unlink_guard(dst)
                unlinked_ino = int(dst["ino"])
                pre = await self._unlink_plan(dp, dn, dst)
            else:
                unlinked_ino = int(dst["ino"])
                purge_ino = int(dst["ino"])
                purge_size = int(dst.get("size", 0))
        await self._quota_check(
            dp, add_files=1,
            add_bytes=int(dentry.get("size", 0))
            if dentry.get("type") == "file" else 0)
        entry = {"op": "import_dentry", "parent": dp, "name": dn,
                 "ino": int(dentry["ino"]), "dentry": dentry,
                 "purge_ino": purge_ino, "purge_size": purge_size,
                 "purge_dir_ino": purge_dir_ino,
                 "token": token, "pre": pre,
                 "anchor": d.get("anchor"),
                 "anchor_ino": int(d.get("anchor_ino", 0) or 0)}
        await self._journal(entry)
        await self._apply(entry)
        self._quota_invalidate()
        if token:
            state = await self._rename_marker_state(token)
            if not state.get("committed"):
                # the source claimed abort first (resolved a timeout):
                # _apply skipped the link; tell the (possibly still
                # listening) source the rename did not happen
                raise MDSError(EXDEV,
                               "rename aborted by the source rank")
        return {"dentry": dentry, "unlinked_ino": unlinked_ino}

    def _guard_busy(self, *pairs: tuple[int, str]) -> None:
        """Mutations on a (parent, name) with a cross-rank rename in
        flight get EBUSY: the source name must stay stable while the
        export protocol runs WITHOUT the rank-wide mutate lock held
        across the peer RPC (the slave-request xlock role)."""
        for pair in pairs:
            if pair in self._busy_names:
                raise MDSError(
                    EBUSY, f"{pair[1]!r}: cross-rank rename in flight")

    async def _rename_cross_rank(self, d: dict,
                                 dst_rank: int) -> dict:
        """Cross-rank FILE rename (witness-lite): journal an export
        intent, ask the destination rank to import the dentry, then
        unlink the source name.  The mutate lock is NOT held across
        the peer RPC — the source name is pinned by the busy-names
        guard instead, so the rank keeps serving.  A dangling intent
        resolves by the atomic commit marker (the slave-commit /
        rollback decision, reference rename two-phase).  DIRECTORY
        renames ride the same protocol (authority follows the new
        ancestry chain; Migrator.h:50 rename-export role) behind the
        invariant checks below.  Hardlinked PRIMARY renames move too:
        the versioned anchor's primary pointer rides the import under
        its commit claim (r5); only REMOTE names headed to a third
        rank still decline.

        Caller holds the mutate lock for THIS phase (validate +
        intent); it is released before the RPC and re-taken for the
        finish."""
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["dst_parent"]), str(d["dst_name"])
        dentry = await self._get_dentry(sp, sn)
        try:
            dst0 = await self._get_dentry(dp, dn)
        except MDSError as e:
            if not e.missing_dentry and e.rc != ENOENT:
                raise
            dst0 = None
        if dst0 is not None and \
                int(dst0.get("ino", 0)) == int(dentry["ino"]):
            # POSIX: renaming onto another name of the SAME inode does
            # nothing — running the protocol would let the import's
            # retried-request short-circuit ack without committing and
            # the finish would then orphan the inode by dropping the
            # source name
            return {"noop": dict(dentry)}
        if dentry.get("type") == "dir":
            # cross-rank DIRECTORY rename: the same two-phase protocol
            # works because dirfrags live in shared RADOS — only the
            # dentry, the parent back-pointer, and AUTHORITY move.
            # Refuse the shapes whose invariants span ranks:
            ino_d = int(dentry["ino"])
            if ino_d in self._subtrees:
                raise MDSError(EBUSY,
                               f"{sn!r} is a subtree export root")
            for s in self._subtrees:
                if s != ino_d and await self._is_ancestor(ino_d, s):
                    raise MDSError(
                        EXDEV, "a delegated subtree boundary lies "
                        "inside the moved directory")
            await self._check_no_boundary_anchors(ino_d)
            if await self._covering_snaps(ino_d) \
                    or await self._covering_snaps(dp):
                raise MDSError(
                    EXDEV, "cross-rank directory rename under a "
                    "live snapshot")
            if await self._is_ancestor(ino_d, dp):
                raise MDSError(EINVAL,
                               "cannot move a directory into itself")
        elif dentry.get("remote"):
            # moving a REMOTE name into a third rank's directory would
            # nest the anchor repoint (primary's rank) inside the
            # dentry import (destination rank) — a three-party
            # protocol; rename it within its own rank or unlink+relink
            raise MDSError(EXDEV,
                           "moves a remote name across a rank "
                           "boundary; rename within its rank or "
                           "unlink + relink")
        anchor = None
        anchor_ino = 0
        if int(dentry.get("nlink", 1)) > 1:
            # hardlinked PRIMARY moving ranks (formerly declined): the
            # anchor's primary pointer must follow the inode.  The
            # versioned record (put-if-newer + tombstones) makes the
            # write replay-safe from EITHER rank's journal, and the
            # destination applies it under the same commit claim that
            # gates the dentry — an aborted rename leaves the anchor
            # untouched.  Remote names elsewhere stay valid: they
            # resolve by ino through this record.
            rec = await self._anchor_get(int(dentry["ino"]))
            if rec is not None:
                anchor_ino = int(dentry["ino"])
                anchor = await self._anchor_next(anchor_ino, {
                    "primary": [dp, dn],
                    "remotes": [[int(r[0]), str(r[1])]
                                for r in rec.get("remotes", ())],
                })
        token = secrets.token_hex(8)
        intent = {"op": "rename_export_intent", "src_parent": sp,
                  "src_name": sn, "dst_parent": dp, "dst_name": dn,
                  "ino": int(dentry["ino"]), "dentry": dentry,
                  "token": token, "anchor": anchor,
                  "anchor_ino": anchor_ino}
        await self._journal(intent)
        self._busy_names.add((sp, sn))
        return {"_phase2": (d, dst_rank, token, dentry, anchor,
                            anchor_ino)}

    async def _two_phase_finish(self, dst_rank: int, payload: dict,
                                token: str, abort_entry: dict,
                                finish_entry: dict,
                                unreachable: str) -> dict:
        """The shared skeleton of every witness-lite protocol's phases
        2+3 (caller does NOT hold the mutate lock): peer RPC (one
        redirect retry), then under the lock either the journaled
        finish, or — on an AMBIGUOUS no-reply — whatever the atomic
        abort-unless-committed claim decides (exactly one winner; the
        peer may have committed before dying).  Returns the peer
        reply ({"rc": 0} when resolved committed)."""
        reply = None
        try:
            reply = await self._peer_request(dst_rank, payload,
                                             timeout=5.0)
            if int(reply.get("rc", EXDEV)) != 0 and \
                    reply.get("redirect_rank") is not None:
                # target subtree moved mid-flight: one retry at the
                # rank the redirect names
                reply = await self._peer_request(
                    int(reply["redirect_rank"]), payload, timeout=5.0)
        except MDSError:
            reply = None
        async with self._mutate:
            if reply is None:
                committed = await self._rename_resolve_abort(token)
                if not committed:
                    await self._journal(abort_entry)
                    raise MDSError(EXDEV, unreachable)
                reply = {"rc": 0}       # committed after all
            elif int(reply.get("rc", EXDEV)) != 0:
                # unambiguous refusal from the peer
                await self._journal(abort_entry)
                raise MDSError(int(reply.get("rc", EXDEV)),
                               str(reply.get("err", "peer refused")))
            await self._journal(finish_entry)
            await self._apply(finish_entry)
        await self._rename_clear(token)
        return reply

    async def _rename_cross_rank_finish(self, phase1: dict) -> dict:
        """Phases 2+3: peer RPC WITHOUT the mutate lock, then the
        journaled finish/abort under it (caller manages locks)."""
        (d, dst_rank, token, dentry, anchor,
         anchor_ino) = phase1["_phase2"]
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["dst_parent"]), str(d["dst_name"])
        reply = await self._two_phase_finish(
            dst_rank,
            {"op": "import_dentry", "parent": dp, "name": dn,
             "dentry": dentry, "token": token,
             "anchor": anchor, "anchor_ino": anchor_ino},
            token,
            {"op": "rename_export_abort", "src_parent": sp,
             "src_name": sn, "ino": int(dentry["ino"]),
             "token": token},
            {"op": "rename_export_finish", "src_parent": sp,
             "src_name": sn, "ino": int(dentry["ino"]),
             "token": token},
            "destination rank unreachable; rename rolled back")
        return {"dentry": dentry,
                "unlinked_ino": int(reply.get("unlinked_ino", 0))}

    async def _req_rename(self, d: dict) -> dict:
        """Rename entry point — manages its own locking: same-rank
        renames run wholly under the mutate lock; cross-rank renames
        hold it only for the intent and finish phases, pinning the
        source name with the busy guard across the peer RPC."""
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["dst_parent"]), str(d["dst_name"])
        repoint = None
        async with self._mutate:
            # re-check: a balancer export may have moved authority
            # while this op queued on the lock
            await self._check_auth(d, "rename")
            self._guard_busy((sp, sn), (dp, dn))
            dst_rank = await self._auth_rank(dp)
            if dst_rank == self.rank:
                repoint = await self._maybe_repoint_remote(d)
                if repoint is None:
                    result = await self._rename_same_rank(d)
                    await self._maybe_compact()
                    return result
            else:
                phase1 = await self._rename_cross_rank(d, dst_rank)
                if "noop" in phase1:
                    # POSIX rename between two names of one inode
                    return {"dentry": phase1["noop"]}
        if repoint is not None:
            if isinstance(repoint, dict) and "noop" in repoint:
                # POSIX rename between two names of one inode
                return {"dentry": repoint["noop"]}
            try:
                return await self._repoint_remote_finish(repoint)
            finally:
                self._busy_names.discard((sp, sn))
                self._busy_names.discard((dp, dn))
                for pin in repoint[-1]:
                    self._busy_names.discard(pin)
        try:
            return await self._rename_cross_rank_finish(phase1)
        finally:
            self._busy_names.discard((sp, sn))

    async def _maybe_repoint_remote(self, d: dict):
        """Rename of a REMOTE name whose primary lives on a foreign
        rank (round-3 weak #5): the anchor repoint runs as a claim-
        gated peer op on the primary's rank, then the name moves here.
        Returns the phase-1 state, or None for every other rename
        shape (caller holds the mutate lock).  A destination with a
        LOCAL teardown is replaced (the plan rides the claim-gated
        finish, r5); only a destination needing its own foreign-rank
        teardown still declines."""
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["dst_parent"]), str(d["dst_name"])
        if (sp, sn) == (dp, dn):
            return None
        dentry = await self._get_dentry(sp, sn)
        if not dentry.get("remote"):
            return None
        ino = int(dentry["ino"])
        rec = await self._anchor_get(ino)
        if rec is None:
            return None
        pp, pn = int(rec["primary"][0]), str(rec["primary"][1])
        prim_rank = await self._auth_rank(pp)
        if prim_rank == self.rank:
            return None                  # same-rank path handles it
        # rename-REPLACING while repointing (formerly declined): a
        # destination whose teardown is LOCAL rides inside the
        # claim-gated finish entry, exactly like import_dentry's
        # ``pre`` — an aborted repoint must not have unlinked it.  A
        # destination needing its OWN foreign-rank teardown still
        # declines (_plan_unlink_guard): that would nest a second
        # two-phase protocol inside this one.
        purge_ino = purge_size = 0
        pre = None
        try:
            dst = await self._get_dentry(dp, dn)
        except MDSError as e:
            if not e.missing_dentry:
                raise
            dst = None
        if dst is not None:
            if dst.get("type") == "dir":
                raise MDSError(EISDIR, dn)
            if int(dst.get("ino", 0)) == ino:
                # POSIX: renaming between two names of the same inode
                # does nothing (both names stay)
                return {"noop": dict(dentry)}
            await self._plan_unlink_guard(dst)
            if dst.get("remote") or int(dst.get("nlink", 1)) > 1:
                pre = await self._unlink_plan(dp, dn, dst)
            else:
                purge_ino = int(dst["ino"])
                purge_size = int(dst.get("size", 0))
        # the replaced destination's teardown plan holds ABSOLUTE
        # nlink/anchor values: the names it touches must stay pinned
        # across the unlocked RPC window or a concurrent link/unlink
        # on them would be clobbered at finish
        extra_pins = []
        if pre is not None and pre["op"] == "unlink_remote":
            extra_pins.append((int(pre["pp"]), str(pre["pn"])))
        elif pre is not None and pre["op"] == "promote_link":
            extra_pins.append((int(pre["np"]), str(pre["nn"])))
        token = secrets.token_hex(8)
        await self._journal({
            "op": "repoint_intent", "src_parent": sp, "src_name": sn,
            "dst_parent": dp, "dst_name": dn, "ino": ino,
            "dentry": dict(dentry), "token": token, "pre": pre,
            "purge_ino": purge_ino, "purge_size": purge_size})
        self._busy_names.add((sp, sn))
        self._busy_names.add((dp, dn))
        self._busy_names.update(extra_pins)
        return (token, prim_rank, pp, ino, sp, sn, dp, dn,
                dict(dentry), pre, purge_ino, purge_size, extra_pins)

    async def _repoint_remote_finish(self, phase1) -> dict:
        (token, prim_rank, pp, ino, sp, sn, dp, dn, dentry,
         pre, purge_ino, purge_size, extra_pins) = phase1
        await self._two_phase_finish(
            prim_rank,
            {"op": "repoint_remote", "parent": pp, "ino": ino,
             "old": [sp, sn], "new": [dp, dn], "token": token},
            token,
            {"op": "repoint_abort", "ino": ino, "token": token},
            {"op": "repoint_finish", "src_parent": sp,
             "src_name": sn, "dst_parent": dp, "dst_name": dn,
             "ino": ino, "dentry": dentry, "token": token,
             "pre": pre, "purge_ino": purge_ino,
             "purge_size": purge_size},
            "primary rank unreachable; rename rolled back")
        self._quota_invalidate()
        return {"dentry": dentry}

    async def _req_repoint_remote(self, d: dict) -> dict:
        """Primary-rank half of a remote-name rename: swap the name in
        the anchor's remotes list under the commit claim (routed by
        the primary's directory, so authority is enforced)."""
        ino = int(d["ino"])
        old = [int(d["old"][0]), str(d["old"][1])]
        new = [int(d["new"][0]), str(d["new"][1])]
        token = str(d.get("token", ""))
        rec = await self._anchor_get(ino)
        if rec is None:
            raise MDSError(ENOENT, f"no anchor for {ino:x}")
        pp, pn = int(rec["primary"][0]), str(rec["primary"][1])
        self._guard_busy((pp, pn))
        remotes = [[int(r[0]), str(r[1])] for r in rec["remotes"]]
        if old not in remotes:
            if new in remotes and token and (
                    await self._rename_marker_state(token)
            ).get("committed"):
                return {}               # retried request: already done
            raise MDSError(ENOENT, f"{old} not a link of {ino:x}")
        anchor = await self._anchor_next(ino, {
            "primary": [pp, pn],
            "remotes": [new if r == old else r for r in remotes],
        })
        entry = {"op": "repoint_remote", "ino": ino,
                 "anchor": anchor, "token": token}
        await self._journal(entry)
        await self._apply(entry)
        if token:
            state = await self._rename_marker_state(token)
            if not state.get("committed"):
                raise MDSError(EXDEV,
                               "repoint aborted by the name's rank")
        return {}

    async def _rename_same_rank(self, d: dict) -> dict:
        sp, sn = int(d["src_parent"]), str(d["src_name"])
        dp, dn = int(d["dst_parent"]), str(d["dst_name"])
        dentry = await self._get_dentry(sp, sn)
        if dentry.get("type") == "dir" \
                and int(dentry["ino"]) in self._subtrees:
            raise MDSError(EBUSY, f"{sn!r} is a subtree export root")
        unlinked_ino = 0
        if (sp, sn) == (dp, dn):
            # POSIX rename-to-self is a no-op — it must not purge the
            # live object's data blocks or dirfrag
            return {"dentry": dentry}
        if dentry["type"] == "dir" and \
                await self._is_ancestor(int(dentry["ino"]), dp):
            # renaming a directory into its own subtree would orphan it
            # as an unreachable cycle
            raise MDSError(EINVAL, "cannot move a directory into itself")
        if dentry.get("remote"):
            # moving one name of a cross-rank link repoints an anchor
            # another rank owns: decline BEFORE any mutation (a failed
            # rename must leave the destination intact)
            rec0 = await self._anchor_get(int(dentry["ino"]))
            if rec0 is not None and await self._auth_rank(
                    int(rec0["primary"][0])) != self.rank:
                raise MDSError(EXDEV,
                               "renames one name of a cross-rank "
                               "link; unlink + relink instead")
        purge_ino = purge_size = purge_dir_ino = 0
        try:
            dst = await self._get_dentry(dp, dn)
            if dst["type"] == "dir":
                if dentry["type"] != "dir":
                    raise MDSError(EISDIR, dn)
                kv = await self._dir_all(int(dst["ino"]))
                if kv:
                    raise MDSError(ENOTEMPTY, dn)
                if int(dst["ino"]) != int(dentry["ino"]):
                    purge_dir_ino = int(dst["ino"])   # replaced empty dir
            elif dentry["type"] == "dir":
                raise MDSError(ENOTDIR, dn)
            elif int(dst["ino"]) == int(dentry["ino"]):
                # POSIX: renaming between two hard links of the same
                # file does NOTHING (both names stay)
                return {"dentry": dentry}
            else:
                unlinked_ino = int(dst["ino"])
                if dst.get("remote") or int(dst.get("nlink", 1)) > 1:
                    # replacing one name of a hardlinked file: run the
                    # link-aware unlink first — its data must survive
                    # under the other names
                    await self._plan_unlink_guard(dst)
                    pre = await self._unlink_plan(dp, dn, dst)
                    await self._journal(pre)
                    await self._apply(pre)
                else:
                    purge_ino = int(dst["ino"])   # overwritten file
                    purge_size = int(dst.get("size", 0))
        except MDSError as e:
            if not e.missing_dentry:
                raise
        anchor_ino, anchor = 0, None
        if dentry.get("remote") or int(dentry.get("nlink", 1)) > 1:
            # the moved name is one of a hardlinked file's names: its
            # anchortable pointer must follow the rename (the
            # cross-rank-link shape was already declined up top,
            # before any destination mutation)
            anchor_ino = int(dentry["ino"])
            rec = await self._anchor_get(anchor_ino)
            if rec is not None:
                if dentry.get("remote"):
                    anchor = await self._anchor_next(anchor_ino, {
                        "primary": rec["primary"], "remotes": [
                            ([dp, dn]
                             if [int(r[0]), str(r[1])] == [sp, sn]
                             else r) for r in rec["remotes"]
                        ]})
                else:
                    anchor = await self._anchor_next(anchor_ino, {
                        "primary": [dp, dn],
                        "remotes": rec["remotes"]})
            else:
                anchor_ino = 0
        if self.quotas:
            # admission into realms the move NET-GAINS (shared
            # ancestors see no change); matches the cross-rank
            # import_dentry check
            src_roots = set(await self._quota_roots(sp))
            gain = [q for q in await self._quota_roots(dp)
                    if q not in src_roots]
            if gain:
                await self._quota_check(
                    dp, add_files=1,
                    add_bytes=int(dentry.get("size", 0))
                    if dentry.get("type") == "file" else 0,
                    roots=gain)
        past_snaps: list[int] = []
        if dentry["type"] == "dir" and self.snaps:
            # realm membership at the OLD location must stick to the
            # moved subtree (SnapRealm past_parents): its descendants'
            # ancestry walk picks these up through this dirfrag
            past_snaps = await self._covering_snaps(int(dentry["ino"]))
        entry = {"op": "rename", "src_parent": sp, "src_name": sn,
                 "dst_parent": dp, "dst_name": dn, "dentry": dentry,
                 "ino": int(dentry["ino"]),
                 "purge_ino": purge_ino, "purge_size": purge_size,
                 "purge_dir_ino": purge_dir_ino,
                 "anchor_ino": anchor_ino, "anchor": anchor,
                 "past_snaps": past_snaps}
        await self._journal(entry)
        await self._apply(entry)
        # realms changed (cross-dir move) or an overwrite purged the
        # destination (same-dir too): recount lazily
        self._quota_invalidate()
        return {"dentry": dentry, "unlinked_ino": unlinked_ino}

    async def _req_setattr(self, d: dict) -> dict:
        """Setattr — self-managed locking: an attr flush against a
        remote whose primary lives on another rank is FORWARDED there
        (that rank's journal + lock own the primary's dirfrag; writing
        it from here would race them), with our lock released across
        the RPC."""
        forward_rank = None
        async with self._mutate:
            await self._check_auth(d, "setattr")
            parent, name = int(d["parent"]), str(d["name"])
            self._guard_busy((parent, name))
            dentry = await self._get_dentry(parent, name)
            if dentry.get("remote"):
                parent, name, dentry = await self._primary_of(
                    int(dentry["ino"]))
                prim_rank = await self._auth_rank(parent)
                if prim_rank != self.rank:
                    forward_rank = prim_rank
                else:
                    self._guard_busy((parent, name))
            if forward_rank is None:
                old_size = int(dentry.get("size", 0))
                for key in ("size", "mode"):
                    if key in d and d[key] is not None:
                        dentry[key] = int(d[key])
                dentry["mtime"] = float(d.get("mtime", time.time()))
                delta = int(dentry.get("size", 0)) - old_size
                qroots = await self._quota_check(
                    parent, add_bytes=max(0, delta))
                entry = {"op": "setattr", "parent": parent,
                         "name": name, "ino": int(dentry["ino"]),
                         "dentry": dentry}
                await self._journal(entry)
                await self._apply(entry)
                self._quota_charge(qroots, nbytes=delta)
                await self._maybe_compact()
                return {"dentry": dentry}
        payload = {**{k: d[k] for k in ("size", "mode", "mtime")
                      if k in d},
                   "op": "setattr", "parent": parent, "name": name}
        reply = await self._peer_request(forward_rank, payload,
                                         timeout=5.0)
        if int(reply.get("rc", EXDEV)) != 0 and \
                reply.get("redirect_rank") is not None:
            # the primary's subtree moved between resolution and the
            # RPC (balancer export): one retry where the redirect says
            reply = await self._peer_request(
                int(reply["redirect_rank"]), payload, timeout=5.0)
        if int(reply.get("rc", EXDEV)) != 0:
            raise MDSError(int(reply.get("rc", EXDEV)),
                           str(reply.get("err", "setattr failed")))
        return {"dentry": dict(reply["dentry"])}
