"""PGLog: the per-PG replicated operation log.

The role of reference src/osd/PGLog.{h,cc} + pg_log_entry_t
(osd_types.h:4038): every mutation a PG applies appends one log entry —
(epoch, seq) version, object name, op kind, resulting object version —
written in the SAME store transaction as the data mutation, so log and
data cannot diverge on one OSD. Peering then exchanges log windows
(O(retained entries)) instead of full object inventories (O(objects)),
and missing sets fall out of set arithmetic over entry seqs; the full
inventory scan survives only as the backfill path for peers whose log
no longer connects (head older than the authoritative tail — the
log-vs-backfill recovery split, doc/dev/osd_internals/log_based_pg.rst).

Layout: one log per OSD per PG, in a dedicated meta collection
(CollectionId(pool, ps, shard=META_SHARD)) so EC OSDs holding several
shard collections of one PG keep exactly one log. Entries live in the
pgmeta object's omap keyed by zero-padded seq (ordered scan = log order);
the tail boundary (seq before the oldest retained entry) is an attr.
Everything rides the durable store, so a restarted OSD re-peers from its
persisted log — the "log + epoch maps" checkpoint model (SURVEY §5).

Port copy of ceph_tpu/osd/pg_log.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.store import CollectionId, GHObject, ObjectStore, Transaction

META_SHARD = -2                  # meta collection's shard id (never a chunk)
TAIL_ATTR = "log_tail"

OP_MODIFY = "modify"
OP_DELETE = "delete"


def meta_cid(pool: int, ps: int) -> CollectionId:
    return CollectionId(pool, ps, META_SHARD)


def meta_oid(pool: int) -> GHObject:
    return GHObject(pool, "_pglog", shard=META_SHARD)


def merged_reqids_oid(pool: int) -> GHObject:
    """Sidecar dedup table for PG merges: the reference empties the
    merged log (PGLog.h:791 merge_from), losing client-replay dedup for
    the source's recent ops — here the source's reqid -> obj_version
    pairs survive the fold in this meta object and feed reqid_index at
    activation (seq 0, so live log entries always win)."""
    return GHObject(pool, "_merged_reqids", shard=META_SHARD)


MERGED_REQIDS_CAP = 4096


def read_merged_reqids(store: ObjectStore, pool: int,
                       ps: int) -> dict[str, tuple[int, int]]:
    """reqid -> (fold ordinal, obj_version) pairs preserved across PG
    merges.  The ordinal is a PG-wide insertion counter (obj_version is
    per-object, useless for recency) so the eviction cap drops the
    OLDEST preserved ops, deterministically on every replica."""
    try:
        omap = store.omap_get(meta_cid(pool, ps),
                              merged_reqids_oid(pool))
    except KeyError:
        return {}
    out = {}
    for k, v in omap.items():
        try:
            o, _, ver = v.decode().partition(",")
            out[k] = (int(o), int(ver))
        except (TypeError, ValueError, AttributeError):
            continue
    return out


def seq_key(seq: int) -> str:
    """The omap key for a seq (zero-padded: ordered scan = log order)."""
    return f"{seq:016d}"


@dataclass(frozen=True)
class LogEntry:
    """One pg_log_entry_t: (epoch, seq) orders entries across intervals
    (the eversion_t role); obj_version is the resulting per-object user
    version; prior_version supports rewind decisions; reqid is the
    client op id that produced the mutation — recorded IN the log so a
    client replay after a lost reply or an interval change is answered
    from history instead of re-executed (the osd_reqid_t dedup of
    pg_log_entry_t, osd_types.h)."""
    seq: int
    epoch: int
    oid: str
    op: str                      # OP_MODIFY | OP_DELETE
    obj_version: int
    prior_version: int = 0
    reqid: str = ""

    def key(self) -> str:
        return seq_key(self.seq)

    def to_wire(self) -> dict:
        return {"s": self.seq, "e": self.epoch, "o": self.oid,
                "p": self.op, "v": self.obj_version,
                "pv": self.prior_version, "r": self.reqid}

    @classmethod
    def from_wire(cls, d: dict) -> "LogEntry":
        return cls(int(d["s"]), int(d["e"]), str(d["o"]), str(d["p"]),
                   int(d["v"]), int(d.get("pv", 0)),
                   str(d.get("r", "")))


def append_ops(tx: Transaction, pool: int, ps: int,
               entry: LogEntry) -> Transaction:
    """Add the log append to ``tx`` (same-transaction atomicity with the
    data mutation it describes)."""
    cid = meta_cid(pool, ps)
    oid = meta_oid(pool)
    tx.omap_setkeys(cid, oid, {entry.key(): encode(entry.to_wire())})
    return tx


def read_log(store: ObjectStore, pool: int, ps: int
             ) -> tuple[dict[int, LogEntry], int]:
    """(seq -> entry, tail_seq) from the durable store. Missing meta
    object = empty log, tail 0."""
    cid = meta_cid(pool, ps)
    oid = meta_oid(pool)
    try:
        omap = store.omap_get(cid, oid)
    except KeyError:
        return {}, 0
    entries: dict[int, LogEntry] = {}
    for raw in omap.values():
        try:
            e = LogEntry.from_wire(decode(raw))
        except (ValueError, TypeError, KeyError):
            continue
        entries[e.seq] = e
    tail = 0
    try:
        tail = int(store.getattr(cid, oid, TAIL_ATTR))
    except (KeyError, ValueError):
        pass
    return entries, tail


async def trim(store: ObjectStore, pool: int, ps: int,
               max_entries: int) -> None:
    """Drop the oldest entries beyond ``max_entries`` and advance the
    tail attr (PGLog::trim). The tail only advances over the CONTIGUOUS
    applied prefix: a gap (an entry this OSD never applied) pins the
    tail below it, so trimming can never claim an unapplied entry as
    applied — peering still sees the hole. Gaps are healed by the
    activation merge after recovery, which unpins the tail."""
    entries, tail = read_log(store, pool, ps)
    stale = [s for s in entries if s <= tail]   # below-tail leftovers
    new_tail = tail
    if len(entries) - len(stale) > max_entries:
        t = tail
        while t + 1 in entries:
            t += 1
        head = max(entries)
        new_tail = max(tail, min(t, head - max_entries))
    cut = [s for s in entries if s <= new_tail]
    if not cut:
        return
    tx = Transaction()
    cid = meta_cid(pool, ps)
    oid = meta_oid(pool)
    tx.omap_rmkeys(cid, oid, [seq_key(s) for s in cut])
    tx.setattr(cid, oid, TAIL_ATTR, str(new_tail).encode())
    await store.queue_transactions(tx)


def head_of(entries: dict[int, LogEntry]) -> tuple[int, int]:
    """(epoch, seq) of the newest entry — the eversion the authoritative-
    log choice compares (max epoch wins across primary failovers, then
    max seq)."""
    if not entries:
        return (0, 0)
    top = entries[max(entries)]
    return (top.epoch, top.seq)


def latest_per_object(entries: dict[int, LogEntry]
                      ) -> dict[str, LogEntry]:
    """oid -> newest entry for it (intermediate entries are superseded:
    only the last matters for missing/recovery computation)."""
    latest: dict[str, LogEntry] = {}
    for seq in sorted(entries):
        e = entries[seq]
        latest[e.oid] = e
    return latest
