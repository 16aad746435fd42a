"""RGW-lite: bucket/object gateway semantics over RADOS.

Counterpart of ceph_tpu/services/rgw.py: the same module over the
port's imports.

The storage model of reference src/rgw's RGWRados (rgw_rados.h:400)
without the HTTP frontends: every bucket has an INDEX object whose omap
maps key -> entry metadata (the cls_rgw bucket-index pattern — the index
is maintained server-side so listing never scans data objects), object
data lives in per-key RADOS objects (striped above 4 MiB, the manifest
role), and user metadata + etag ride xattrs. S3-visible behaviors kept:
listing with prefix/marker/max_keys, etag as hex md5, copy, and
conditional puts.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import math
import random
import secrets
import time
import zlib
from contextlib import contextmanager

from ceph_tpu_torch.common.compressor import get_compressor, list_compressors
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.tracing import Tracer, use_span

from ceph_tpu_torch.client.rados import (IoCtx, ObjectOperation, RadosError,
                                   full_try)
from ceph_tpu_torch.client.striper import RadosStriper, StripeLayout

rgw_log = Dout("rgw")

BUCKETS_OID = "rgw.buckets"          # omap: bucket name -> meta
STRIPE_THRESHOLD = 4 * 1024 * 1024


def _reclaims_space(fn):
    """Delete-flow methods run under CEPH_OSD_FLAG_FULL_TRY semantics:
    their sideband writes (bilog 'call' append, versioned delete-marker
    omap_set, GC-enqueue create+omap_set) must not bounce with EDQUOT on
    a quota-full pool, or users could never delete their way back under
    quota (the reference flags delete-class ops the same way)."""
    import functools

    @functools.wraps(fn)
    async def wrapper(*a, **kw):
        with full_try():
            return await fn(*a, **kw)
    return wrapper


# -- SSE-C (reference rgw_crypt.cc customer-key encryption) ---------------
# AES-256-CTR with a per-object random nonce: the keystream is seekable
# (counter = nonce + byte_offset/16), so ranged GETs decrypt any window
# without reading from zero — the role of the reference's chunk-aligned
# AES-CBC scheme.  The key is never stored; only its MD5 rides the index
# entry so GETs can validate the presented key (S3 SSE-C contract).

def manifest_window(sizes: list[int], start: int, end: int
                    ) -> list[tuple[int, int, int]]:
    """(segment index, offset-in-segment, length) triples covering the
    inclusive byte range [start, end] of the concatenation — the one
    overlap computation multipart reads, SLO and DLO all share."""
    out = []
    if end < start:
        return out
    pos = 0
    for i, psize in enumerate(sizes):
        pstart, pend = pos, pos + psize - 1
        pos += psize
        if psize <= 0 or pend < start:
            continue
        if pstart > end:
            break
        off = max(0, start - pstart)
        length = min(pend, end) - (pstart + off) + 1
        out.append((i, off, length))
    return out


def sse_begin(key: bytes) -> dict:
    if len(key) != 32:
        raise RGWError("InvalidArgument", "SSE-C key must be 32 bytes")
    return {
        "alg": "AES256",
        "key_md5": hashlib.md5(key).hexdigest(),
        "nonce": secrets.token_bytes(16).hex(),
    }


def sse_crypt(key: bytes, nonce: bytes, offset: int,
              data: bytes) -> bytes:
    """En/decrypt ``data`` as the CTR keystream window starting at byte
    ``offset`` of the object (CTR: encrypt == decrypt)."""
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    counter = (int.from_bytes(nonce, "big") + offset // 16) % (1 << 128)
    enc = Cipher(
        algorithms.AES(key),
        modes.CTR(counter.to_bytes(16, "big")),
    ).encryptor()
    skip = offset % 16
    if skip:
        enc.update(b"\0" * skip)        # discard partial-block keystream
    return enc.update(data)


def sse_check(entry: dict, key: bytes | None) -> None:
    """S3 semantics: an SSE-C object requires the matching key on every
    read; presenting a key for a plaintext object is an error too.
    KMS-managed entries (SSE-KMS / SSE-S3, marked by a wrapped data
    key) are server-decrypted — presenting an SSE-C key is an error."""
    sse = entry.get("sse")
    if sse is None:
        if key is not None:
            raise RGWError("InvalidRequest",
                           "object is not SSE-C encrypted")
        return
    if sse.get("wrapped") is not None:
        if key is not None:
            raise RGWError("InvalidRequest",
                           "object is KMS-encrypted, not SSE-C")
        return
    if key is None:
        raise RGWError("InvalidRequest",
                       "object is SSE-C encrypted; key required")
    if hashlib.md5(key).hexdigest() != sse["key_md5"]:
        raise RGWError("AccessDenied", "SSE-C key mismatch")


USERS_OID = "rgw.users"              # omap: uid -> user record json
KEYS_OID = "rgw.users.keys"          # omap: access key -> uid
STS_KEYS_OID = "rgw.users.sts"       # omap: temp access key -> record

_PERM_ORDER = {"READ": 0, "WRITE": 1, "FULL_CONTROL": 2}
_CANNED_ACLS = ("private", "public-read", "public-read-write",
                "authenticated-read")
ANONYMOUS = "anonymous"


class RGWUsers:
    """User database + S3-style key auth (the rgw_user / RGWUserCtl
    role, reference src/rgw/rgw_user.cc + radosgw-admin user ops):
    records in one omap object, an access-key index for login, per-user
    quota fields, and an HMAC check standing in for SigV4."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    async def create(self, uid: str, display_name: str = "",
                     max_size: int = 0, max_objects: int = 0) -> dict:
        try:
            kv = await self.ioctx.get_omap(USERS_OID, [uid])
        except RadosError as e:
            if e.rc != -2:
                raise
            kv = {}
        if uid in kv:
            raise RGWError("UserAlreadyExists", uid)
        rec = {
            "uid": uid, "display_name": display_name or uid,
            "access_key": secrets.token_hex(10).upper(),
            "secret_key": secrets.token_hex(20),
            "quota": {"max_size": int(max_size),
                      "max_objects": int(max_objects)},
            "suspended": False,
        }
        await self.ioctx.operate(USERS_OID, ObjectOperation()
                                 .create()
                                 .omap_set({uid: json.dumps(rec)
                                            .encode()}))
        await self.ioctx.operate(KEYS_OID, ObjectOperation()
                                 .create()
                                 .omap_set({rec["access_key"]:
                                            uid.encode()}))
        return rec

    async def _all(self) -> dict[str, dict]:
        try:
            return {
                uid: json.loads(raw) for uid, raw in
                (await self.ioctx.get_omap(USERS_OID)).items()
            }
        except RadosError as e:
            if e.rc == -2:
                return {}
            raise

    async def get(self, uid: str) -> dict:
        try:
            kv = await self.ioctx.get_omap(USERS_OID, [uid])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if uid not in kv:
            raise RGWError("NoSuchUser", uid)
        return json.loads(kv[uid])

    async def list(self) -> list[str]:
        return sorted(await self._all())

    async def remove(self, uid: str) -> None:
        rec = await self.get(uid)
        await self.ioctx.rm_omap_keys(USERS_OID, [uid])
        await self.ioctx.rm_omap_keys(KEYS_OID, [rec["access_key"]])

    async def set_quota(self, uid: str, max_size: int = 0,
                        max_objects: int = 0) -> None:
        rec = await self.get(uid)
        rec["quota"] = {"max_size": int(max_size),
                        "max_objects": int(max_objects)}
        await self.ioctx.set_omap(USERS_OID,
                                  {uid: json.dumps(rec).encode()})

    async def set_swift_meta(self, uid: str,
                             meta: dict[str, str]) -> None:
        """Swift account metadata (X-Account-Meta-*), on the user
        record like the reference's RGWUserInfo attrs.  Re-reads the
        record and patches ONLY swift_meta: a client-driven account
        POST must not write a stale whole record over a concurrent
        admin mutation (e.g. set_suspended)."""
        rec = await self.get(uid)
        rec["swift_meta"] = {str(k): str(v) for k, v in meta.items()}
        await self.ioctx.set_omap(
            USERS_OID, {uid: json.dumps(rec).encode()})

    async def set_suspended(self, uid: str,
                            suspended: bool = True) -> None:
        """radosgw-admin user suspend/enable: a suspended user fails
        every auth path (library HMAC and the HTTP frontend's SigV4)."""
        rec = await self.get(uid)
        rec["suspended"] = bool(suspended)
        await self.ioctx.set_omap(USERS_OID,
                                  {uid: json.dumps(rec).encode()})

    # -- STS (rgw_sts.cc AssumeRole role, -lite) ---------------------------
    async def sts_assume(self, uid: str, ttl: int = 3600,
                         role: str = "assumed-role") -> dict:
        """Mint temporary credentials for ``uid`` (GetSessionToken /
        AssumeRole): a time-bounded access/secret pair plus a session
        token the frontend requires on every signed request."""
        rec = await self.get(uid)
        if rec.get("suspended"):
            raise RGWError("AccessDenied", f"{uid} suspended")
        if not 1 <= int(ttl) <= 12 * 3600:
            raise RGWError("InvalidArgument", "ttl out of range")
        creds = {
            "uid": uid, "role": str(role),
            "access_key": "STS" + secrets.token_hex(8).upper(),
            "secret_key": secrets.token_hex(20),
            "session_token": secrets.token_hex(24),
            "expiration": time.time() + int(ttl),
        }
        await self.ioctx.operate(STS_KEYS_OID, ObjectOperation()
                                 .create()
                                 .omap_set({creds["access_key"]:
                                            json.dumps(creds)
                                            .encode()}))
        return creds

    async def sts_get(self, access_key: str) -> dict | None:
        """The live temp-credential record, or None (absent/expired —
        expired records are reaped on lookup)."""
        try:
            kv = await self.ioctx.get_omap(STS_KEYS_OID, [access_key])
        except RadosError as e:
            if e.rc == -2:
                return None
            raise
        if access_key not in kv:
            return None
        rec = json.loads(kv[access_key])
        if rec["expiration"] < time.time():
            try:
                await self.ioctx.rm_omap_keys(STS_KEYS_OID,
                                              [access_key])
            except RadosError:
                pass
            return None
        return rec

    async def authenticate(self, access_key: str, signature: str,
                           string_to_sign: bytes) -> str:
        """hmac-sha256(secret, string_to_sign) == signature -> uid
        (the SigV4 role collapsed to one hmac)."""
        import hmac as _hmac

        try:
            kv = await self.ioctx.get_omap(KEYS_OID, [access_key])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if access_key not in kv:
            raise RGWError("InvalidAccessKeyId", access_key)
        rec = await self.get(kv[access_key].decode())
        want = _hmac.new(rec["secret_key"].encode(), string_to_sign,
                         hashlib.sha256).hexdigest()
        if not _hmac.compare_digest(want, signature):
            raise RGWError("SignatureDoesNotMatch", access_key)
        if rec.get("suspended"):
            raise RGWError("AccessDenied", "user suspended")
        return rec["uid"]


COMP_BLOCK = 4 * 1024 * 1024


def deflate_if_smaller(data: bytes,
                       alg: str = "zlib") -> tuple[bytes, dict | None]:
    """Whole-body at-rest compression (rgw_compression.cc role for
    small objects) through the shared compressor registry
    (common/compressor, Compressor.h:33): kept only when it actually
    shrinks."""
    packed = get_compressor(alg).compress(data)
    if len(packed) < len(data):
        return packed, {"alg": alg, "stored_size": len(packed)}
    return data, None


def comp_window(blocks, start: int, end: int):
    """Map an inclusive INFLATED byte range onto independently-deflated
    blocks (the reference's compression block map, rgw_compression.h
    RGWCompressionInfo role): (stored_off, stored_len, skip, take)
    per intersecting block — inflate the block's stored bytes, then
    slice inflated[skip:skip+take].  The overlap math is
    manifest_window over the inflated block sizes; this only adds the
    stored-offset prefix sum."""
    stored_off = [0]
    for _, stored_len in blocks:
        stored_off.append(stored_off[-1] + stored_len)
    return [(stored_off[i], blocks[i][1], skip, take)
            for i, skip, take in manifest_window(
                [b[0] for b in blocks], start, end)]


class StreamingPut:
    """One chunked PUT in flight (rgw_putobj processor role): write()
    places each chunk at its running offset (striper for large bodies),
    md5/SSE state accumulate incrementally, complete() publishes the
    index entry, abort() removes whatever landed."""

    def __init__(self, rgw: "RGWLite", ctx: dict, length: int,
                 content_type: str, metadata: dict):
        self._rgw = rgw
        self._ctx = ctx
        self.length = length
        self._content_type = content_type
        self._metadata = metadata
        # SSE-C only via set_sse_key: an sse record without the key
        # would store plaintext under an entry claiming encryption
        self._sse: dict | None = None
        self._sse_key: bytes | None = None
        self._pos = 0
        self._md5 = hashlib.md5()
        self._striped = length > STRIPE_THRESHOLD
        self._buf = bytearray() if not self._striped else None
        # at-rest compression rides the stream: striped bodies deflate
        # per COMP_BLOCK into a block map so reads keep random access
        # and bounded memory; small ones stay buffered and compress at
        # complete() exactly like the buffered path
        self._comp_alg = (ctx.get("compression")
                          if ctx.get("compression") in list_compressors()
                          else None)
        self._cpos = 0
        self._blkbuf = bytearray() if self._striped else None
        self._blocks: list[list[int]] = []

    async def _handles(self):
        # the placement pool this object's storage class resolved to
        # (zone pool when ctx carries none)
        return await self._rgw._data_handles(self._ctx.get("pool"))

    def set_sse_key(self, key: bytes) -> None:
        if self._pos:
            raise RGWError("InvalidRequest",
                           "SSE-C key must be set before the first "
                           "body chunk")
        self._sse = sse_begin(key)
        self._sse_key = key
        # SSE-C excludes at-rest compression (ciphertext doesn't
        # deflate), matching the buffered put_object path
        self._comp_alg = None

    def set_sse_kms(self, data_key: bytes, sse_record: dict) -> None:
        """SSE-KMS / SSE-S3 streaming: encrypt under a KMS-wrapped
        data key (from RGWLite._kms_begin); the record (with the
        wrapped blob) rides the entry."""
        if self._pos:
            raise RGWError("InvalidRequest",
                           "encryption must start before the first "
                           "body chunk")
        self._sse = dict(sse_record)
        self._sse_key = data_key
        self._comp_alg = None

    async def write(self, chunk: bytes) -> None:
        if self._pos + len(chunk) > self.length:
            await self.abort()
            raise RGWError("InvalidArgument",
                           "body exceeds declared Content-Length")
        self._md5.update(chunk)
        if self._sse_key is not None:
            chunk = sse_crypt(self._sse_key,
                              bytes.fromhex(self._sse["nonce"]),
                              self._pos, chunk)
        if self._striped:
            if self._comp_alg is not None:
                self._blkbuf += chunk
                while len(self._blkbuf) >= COMP_BLOCK:
                    await self._emit_block(
                        bytes(self._blkbuf[:COMP_BLOCK]))
                    del self._blkbuf[:COMP_BLOCK]
            else:
                _, striper = await self._handles()
                await striper.write(self._ctx["oid"], chunk,
                                    offset=self._pos)
        else:
            self._buf += chunk
        self._pos += len(chunk)

    async def _emit_block(self, raw: bytes) -> None:
        # each block compresses independently (always kept: a streamed
        # body can't be un-written, and per-block framing overhead is
        # ~0.03% worst case) so reads seek straight to any block
        packed = get_compressor(self._comp_alg).compress(raw)
        _, striper = await self._handles()
        await striper.write(self._ctx["oid"], packed,
                            offset=self._cpos)
        self._blocks.append([len(raw), len(packed)])
        self._cpos += len(packed)

    async def complete(self) -> dict:
        if self._pos != self.length:
            await self.abort()
            raise RGWError("IncompleteBody",
                           f"{self._pos} of {self.length} bytes")
        comp = None
        if self._striped and self._comp_alg is not None:
            if self._blkbuf:
                await self._emit_block(bytes(self._blkbuf))
                self._blkbuf.clear()
            comp = {"alg": self._comp_alg, "stored_size": self._cpos,
                    "blocks": self._blocks}
        elif not self._striped:
            data = bytes(self._buf)
            if self._comp_alg is not None:
                data, comp = deflate_if_smaller(data, self._comp_alg)
            ioctx, _ = await self._handles()
            await ioctx.operate(
                self._ctx["oid"],
                ObjectOperation().write_full(data))
        # replaced object's data (and version-store adoption) happen
        # only now — with the new bytes fully down, just before the
        # index flips to them; an aborted stream never reaches here
        bucket, key = self._ctx["bucket"], self._ctx["key"]
        for action, arg in self._ctx.get("deferred_cleanup") or ():
            if action == "adopt":
                await self._rgw._adopt_null_version(bucket, key, arg)
            elif action == "null":
                await self._rgw._remove_null_version(bucket, key)
            else:
                await self._rgw._remove_entry_data(bucket, key, arg)
        return await self._rgw._finish_put(
            self._ctx, self.length, self._md5.hexdigest(),
            self._striped, self._content_type, self._metadata,
            self._sse, comp=comp)

    async def abort(self) -> None:
        """Drop any data already landed; the index was never touched."""
        try:
            ioctx, striper = await self._handles()
            if self._striped:
                await striper.remove(self._ctx["oid"])
            else:
                await ioctx.remove(self._ctx["oid"])
        except RadosError as e:
            if e.rc != -2:
                raise


class RGWError(IOError):
    def __init__(self, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}")
        self.code = code


class RGWLite:
    def __init__(self, ioctx: IoCtx, datalog: bool = True,
                 user: str | None = None,
                 users: "RGWUsers | None" = None,
                 gc_min_wait: float = 0.0,
                 auto_reshard_objs: int = 0,
                 kms=None, datalog_shards: int = 1):
        """``datalog``: append every mutation to the per-bucket data log
        (the cls_rgw bilog) so a multisite sync agent can tail it.
        ``user``: the acting identity for ACL/quota enforcement (None =
        system/admin context, every check bypassed — the original
        behavior); ``users``: the user db backing quota lookups.
        ``gc_min_wait``: >0 defers data-object deletion to the GC queue
        for that many seconds (rgw_gc_obj_min_wait; 0 = delete inline).
        ``auto_reshard_objs``: >0 doubles a bucket's index shards when
        any one shard exceeds this many entries (rgw dynamic
        resharding's rgw_max_objs_per_shard; 0 = off)."""
        self.ioctx = ioctx
        self.datalog = datalog
        # bucket-datalog shard fan-out (rgw_data_log_num_shards role):
        # mutations hash by object key onto a shard log so multisite
        # replay and trim parallelise; shard 0 keeps the legacy oid so
        # a 1-shard config is byte-compatible with pre-shard logs
        self.datalog_shards = max(1, int(datalog_shards))
        self.user = user
        self.users = users
        self.gc_min_wait = gc_min_wait
        self.auto_reshard_objs = auto_reshard_objs
        # KMS backend for SSE-KMS / SSE-S3 (services.kms; rgw_kms.h)
        self.kms = kms
        # bucket -> (fetched_at, notification configs); shared across
        # as_user handles so invalidation is seen by every identity
        self._notif_cache: dict[str, tuple[float, list]] = {}
        # push-mode delivery state (rgw_notify.cc persistent topics):
        # topic -> (worker task, wake event); topic meta cache.  Shared
        # across as_user handles like _notif_cache.
        self._pushers: dict[str, tuple] = {}
        self._topics_cache: dict[str, tuple[float, dict | None]] = {}
        # front-door QoS admission telemetry (rgw_http sheds overload
        # with 503 Slow Down and counts here; shared across as_user
        # handles so one gateway keeps one ledger)
        self.qos_stats: dict[str, int] = {
            "admitted": 0, "shed_inflight": 0, "shed_session": 0}
        self.striper = RadosStriper(ioctx, StripeLayout(
            stripe_unit=512 * 1024, stripe_count=4,
            object_size=4 * 1024 * 1024,
        ))
        # per-storage-class data pool handles (zone placement targets):
        # pool name -> (IoCtx, RadosStriper).  Shared across as_user
        # handles like the caches above so one gateway keeps one handle
        # per tier pool.
        self._pool_handles: dict[str, tuple] = {}
        # request tracing (zipkin-lite): sampled S3 requests open the
        # root span here, so the whole rgw -> objecter -> OSD path
        # reassembles into one tree.  One ring per gateway, shared
        # across as_user handles like the caches above.
        self.tracer = Tracer("rgw")

    def as_user(self, user: str | None) -> "RGWLite":
        """A handle acting as ``user`` over the same pool."""
        child = RGWLite(self.ioctx, self.datalog, user, self.users,
                        self.gc_min_wait, self.auto_reshard_objs,
                        kms=self.kms,
                        datalog_shards=self.datalog_shards)
        child._notif_cache = self._notif_cache
        child._pushers = self._pushers
        child._topics_cache = self._topics_cache
        child._pool_handles = self._pool_handles
        child.qos_stats = self.qos_stats
        child.tracer = self.tracer
        return child

    @contextmanager
    def _trace_root(self, name: str, **tags):
        """Open a sampled root span for one S3 request and make it the
        ambient span — the objecter sees it via current_span() and
        parents every resulting RADOS op under the request (the
        rgw_trace/req_state->trace linkage).  Yields None unsampled."""
        try:
            prob = float(
                self.ioctx.rados.conf["trace_probability"] or 0.0)
        except (KeyError, TypeError, ValueError, AttributeError):
            prob = 0.0
        if not prob or random.random() >= prob:
            yield None
            return
        with self.tracer.span(name, **tags) as ctx:
            with use_span(ctx):
                yield ctx

    # -- storage classes / placement pools (rgw_placement_rule) -----------
    async def _data_handles(self, pool: str | None):
        """(IoCtx, RadosStriper) for the pool an object's tail lives
        in.  Falsy / zone-pool -> the gateway's own handles; anything
        else (a COLD/ARCHIVE class's EC pool) opens once and caches.
        Index omaps, version records, and multipart metadata always
        stay in the zone pool — only tails move."""
        if not pool or pool == self.ioctx.pool_name:
            return self.ioctx, self.striper
        got = self._pool_handles.get(pool)
        if got is None:
            rados = self.ioctx.rados
            try:
                ioctx = await rados.open_ioctx(pool)
            except RadosError as e:
                if e.rc != -2:
                    raise
                # our osdmap may lag a pool another client just
                # created; wait briefly, then retry once
                try:
                    await rados._wait_pool(pool, timeout=5.0)
                except Exception:
                    raise RGWError(
                        "InvalidStorageClass",
                        f"placement pool {pool!r} does not exist",
                    ) from None
                ioctx = await rados.open_ioctx(pool)
            got = (ioctx, RadosStriper(ioctx, StripeLayout(
                stripe_unit=512 * 1024, stripe_count=4,
                object_size=4 * 1024 * 1024,
            )))
            self._pool_handles[pool] = got
        return got

    async def _class_placement(self, storage_class: str) -> dict:
        """Resolve a storage class through the zone's placement target
        ({"pool", "compression"}); InvalidStorageClass for classes no
        placement defines — the error a PUT with a bogus
        x-amz-storage-class must surface."""
        from ceph_tpu_torch.services.rgw_zone import ZonePlacement
        return await ZonePlacement(self.ioctx).resolve(storage_class)

    # -- SSE-KMS / SSE-S3 (rgw_kms.h + rgw_crypt.cc wiring) ---------------
    DEFAULT_KMS_KEY = "rgw/default"      # x-amz-...-aws-kms-key-id absent
    SSE_S3_KEY = "rgw/sse-s3"            # zone-managed SSE-S3 master key

    async def _kms_begin(self, alg: str, key_id: str | None
                         ) -> tuple[bytes, dict]:
        """Fresh per-object data key + the sse record to store (the
        wrapped blob rides the entry; the plaintext key never lands)."""
        if self.kms is None:
            raise RGWError("InvalidRequest",
                           "server-side encryption requires a KMS")
        if alg == "aws:kms":
            key_id = key_id or self.DEFAULT_KMS_KEY
        elif alg == "AES256":
            key_id = self.SSE_S3_KEY     # SSE-S3: zone-managed key
        else:
            raise RGWError("InvalidArgument",
                           f"bad server-side encryption {alg!r}")
        dk, wrapped = await self.kms.generate_data_key(key_id)
        return dk, {
            "alg": alg, "key_id": key_id, "wrapped": wrapped,
            "nonce": secrets.token_bytes(16).hex(),
        }

    async def _entry_sse_key(self, entry: dict,
                             sse_key: bytes | None) -> bytes | None:
        """Resolve the data key that decrypts ``entry`` — the
        presented SSE-C key, a KMS unwrap, or None for plaintext."""
        from ceph_tpu_torch.services.kms import KMSError

        sse_check(entry, sse_key)
        sse = entry.get("sse")
        if sse is None:
            return None
        if sse.get("wrapped") is not None:
            if self.kms is None:
                raise RGWError("InvalidRequest",
                               "object is KMS-encrypted but no KMS "
                               "is configured")
            try:
                return await self.kms.unwrap_data_key(
                    sse["key_id"], sse["wrapped"])
            except KMSError as e:
                raise RGWError("AccessDenied", str(e)) from e
        return sse_key

    # -- ACL (rgw_acl.cc canned subset + explicit grants) ------------------
    async def _bucket_meta(self, bucket: str) -> dict:
        try:
            kv = await self.ioctx.get_omap(BUCKETS_OID, [bucket])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if bucket not in kv:
            raise RGWError("NoSuchBucket", bucket)
        return json.loads(kv[bucket])

    async def _put_bucket_meta(self, bucket: str, meta: dict) -> None:
        await self.ioctx.set_omap(
            BUCKETS_OID, {bucket: json.dumps(meta).encode()}
        )

    def _acl_allows(self, owner: str, acl: dict, need: str) -> bool:
        if self.user is None:
            return True             # system context
        if self.user == owner:
            return True
        canned = acl.get("canned", "private")
        # canned publics grant data access only — never FULL_CONTROL
        # (ACL/quota/lifecycle administration stays with the owner and
        # explicit FULL_CONTROL grantees)
        if canned == "public-read-write" and need in ("READ", "WRITE"):
            return True
        if canned == "public-read" and need == "READ":
            return True
        if canned == "authenticated-read" and need == "READ" \
                and self.user != ANONYMOUS:
            return True
        for grant in acl.get("grants", ()):
            if grant.get("grantee") in (self.user, "*") and \
                    _PERM_ORDER.get(grant.get("perm"), -1) >= \
                    _PERM_ORDER[need]:
                return True
        return False

    async def _check_bucket(self, bucket: str, need: str,
                            action: str | None = None,
                            key: str | None = None) -> dict:
        """ACL + bucket-policy gate (the rgw_op.cc verify_permission
        order: policy Deny short-circuits, policy Allow grants, no
        match falls back to the ACL).

        Policy applies ONLY at call sites that name an IAM ``action``
        (the object data path).  Bucket administration and config ops
        pass no action and stay owner/ACL-gated: an object-data grant
        (s3:PutObject on bucket/*) must never open notification/
        versioning/ACL configuration, and the owner can always delete
        a bad policy (no lockout)."""
        meta = await self._bucket_meta(bucket)
        policy = meta.get("policy")
        if policy is not None and self.user is not None \
                and action is not None:
            from ceph_tpu_torch.services import iam

            resource = f"{bucket}/{key}" if key is not None else bucket
            verdict = iam.evaluate(policy, self.user, action, resource)
            if verdict == "deny":
                raise RGWError("AccessDenied",
                               f"{bucket} ({action} denied by policy)")
            if verdict == "allow":
                return meta
        if not self._acl_allows(meta.get("owner", ""),
                                meta.get("acl", {}), need):
            raise RGWError("AccessDenied", f"{bucket} ({need})")
        return meta

    # -- bucket policy (rgw_iam_policy.cc) ---------------------------------
    async def put_bucket_policy(self, bucket: str,
                                policy: str | dict) -> None:
        from ceph_tpu_torch.services import iam

        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        try:
            doc = iam.validate(policy)
        except iam.PolicyError as e:
            raise RGWError("MalformedPolicy", str(e)) from None
        meta["policy"] = doc
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_policy(self, bucket: str) -> dict:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        policy = meta.get("policy")
        if policy is None:
            raise RGWError("NoSuchBucketPolicy", bucket)
        return policy

    async def delete_bucket_policy(self, bucket: str) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta.pop("policy", None)
        await self._put_bucket_meta(bucket, meta)

    async def put_bucket_acl(self, bucket: str, canned: str = "private",
                             grants: list[dict] | None = None) -> None:
        if canned not in _CANNED_ACLS:
            raise RGWError("InvalidArgument", canned)
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta["acl"] = {"canned": canned, "grants": list(grants or ())}
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_acl(self, bucket: str) -> dict:
        """Owner / FULL_CONTROL grantees only (the READ_ACP gate):
        grant lists and ownership are not disclosed to mere readers."""
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        return {"owner": meta.get("owner", ""),
                "acl": meta.get("acl", {"canned": "private"})}

    # -- quota (rgw_quota.cc: user + bucket ceilings) ----------------------
    async def _bucket_usage(self, bucket: str,
                            meta: dict | None = None
                            ) -> tuple[int, int]:
        """(bytes, objects) from the bucket index — computed on demand
        (the reference keeps rolling stats in the index header; at our
        scale a scan is exact and race-free)."""
        index = await self._index_all(bucket, meta)
        entries = {k: json.loads(v) for k, v in index.items()}
        entries = {k: e for k, e in entries.items()
                   if not e.get("delete_marker")}
        total = sum(e["size"] for e in entries.values())
        count = len(entries)
        # non-current versions hold real bytes too.  Current versions
        # are keyed by (object key, version id): the id alone is
        # ambiguous — every adopted pre-versioning object is 'null'
        current = {(k, e.get("version_id"))
                   for k, e in entries.items()}
        try:
            vomap = await self.ioctx.get_omap(
                self._versions_oid(bucket))
        except RadosError as e:
            if e.rc != -2:
                raise
            vomap = {}
        for vk, raw in vomap.items():
            key, _, vid = vk.partition("\x00")
            v = json.loads(raw)
            if v.get("delete_marker") or (key, vid) in current:
                continue
            total += int(v.get("size", 0))
            count += 1
        return total, count

    async def set_bucket_quota(self, bucket: str, max_size: int = 0,
                               max_objects: int = 0) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta["quota"] = {"max_size": int(max_size),
                         "max_objects": int(max_objects)}
        await self._put_bucket_meta(bucket, meta)

    async def _check_quota(self, bucket: str, meta: dict,
                           incoming: int, replaced_size: int,
                           is_replace: bool) -> None:
        bq = meta.get("quota") or {}
        uq = {}
        owner = meta.get("owner", "")
        if self.users is not None and owner:
            try:
                uq = (await self.users.get(owner)).get("quota") or {}
            except RGWError:
                uq = {}
        if not bq.get("max_size") and not bq.get("max_objects") \
                and not uq.get("max_size") and not uq.get("max_objects"):
            return
        used_bytes, used_objs = await self._bucket_usage(bucket, meta)
        new_bytes = used_bytes - replaced_size + incoming
        new_objs = used_objs + (0 if is_replace else 1)
        if bq.get("max_size") and new_bytes > bq["max_size"]:
            raise RGWError("QuotaExceeded", f"bucket {bucket} size")
        if bq.get("max_objects") and new_objs > bq["max_objects"]:
            raise RGWError("QuotaExceeded", f"bucket {bucket} objects")
        if uq.get("max_size") or uq.get("max_objects"):
            total_bytes = total_objs = 0
            for b in await self.list_buckets():
                try:
                    if (await self._bucket_meta(b)).get("owner") \
                            != owner:
                        continue
                except RGWError:
                    continue
                bb, bo = await self._bucket_usage(b)
                if b == bucket:
                    bb, bo = new_bytes, new_objs
                total_bytes += bb
                total_objs += bo
            if uq.get("max_size") and total_bytes > uq["max_size"]:
                raise RGWError("QuotaExceeded", f"user {owner} size")
            if uq.get("max_objects") and total_objs > uq["max_objects"]:
                raise RGWError("QuotaExceeded", f"user {owner} objects")

    # -- object versioning (rgw_rados versioned-bucket model) -------------
    @staticmethod
    def _versions_oid(bucket: str) -> str:
        return f"rgw.bucket.versions.{bucket}"

    @staticmethod
    def _vkey(key: str, version_id: str) -> str:
        return f"{key}\x00{version_id}"

    # -- object tagging (rgw_tag.cc / rgw_obj_tags) ------------------------
    @staticmethod
    def validate_tags(tags: dict[str, str]) -> None:
        """One validator for every tag ingestion path (?tagging body,
        x-amz-tagging header, library calls)."""
        if len(tags) > 10:
            raise RGWError("InvalidTag", "at most 10 tags")
        for k, v in tags.items():
            if not k or len(k) > 128 or len(str(v)) > 256:
                raise RGWError("InvalidTag", k)

    async def _tag_update(self, bucket: str, meta: dict, key: str,
                          tags: dict[str, str] | None,
                          expect_etag: str | None = None) -> bool:
        """Atomic tag patch on the index entry (and the matching
        versions-omap record, so ?versionId reads and later history
        agree) via the rgw cls — a client-side read-modify-write
        could silently revert a concurrent PUT's entry."""
        self._index_writable(meta)
        payload = {"key": key, "tags": tags or {},
                   "expect_object": True}
        if expect_etag is not None:
            payload["expect_etag"] = expect_etag
        try:
            out = json.loads(await self.ioctx.exec(
                self._index_oid_for(bucket, meta, key), "rgw",
                "tag_update", json.dumps(payload).encode()))
        except RadosError as e:
            if e.rc == -2:
                raise RGWError("NoSuchKey", f"{bucket}/{key}")
            raise
        if not out.get("applied"):
            return False
        # mirror onto the version record of the entry the cls ACTUALLY
        # patched (its reply carries the version_id — re-reading the
        # index here could see a racing writer's entry and mis-tag it)
        vid = out.get("version_id")
        if vid:
            try:
                await self.ioctx.exec(
                    self._versions_oid(bucket), "rgw",
                    "tag_update", json.dumps({
                        "key": self._vkey(key, vid),
                        "tags": tags or {}}).encode())
            except RadosError as e:
                if e.rc != -2:
                    raise
        # a bilog entry so multisite sync replicates the tag change
        # (a DISTINCT op: ObjectCreated subscribers must not see a
        # creation event for a tag write; the sync tailer's reconcile
        # branch converges unknown ops on source state, tags included)
        kv = await self._index_get(bucket, key, meta)
        if key in kv:
            await self._log(bucket, "put-tagging", key,
                            json.loads(kv[key]).get("etag", ""))
        return True

    async def _tag_update_version(self, bucket: str, meta: dict,
                                  key: str, version_id: str,
                                  tags: dict | None) -> None:
        """Tag a SPECIFIC version's record; when that version is also
        current, the index entry follows, etag-guarded so a racing
        overwrite's entry never inherits the old version's tags."""
        self._index_writable(meta)     # BEFORE any write: a 503 must
        # not leave version and index records disagreeing
        try:
            await self.ioctx.exec(
                self._versions_oid(bucket), "rgw", "tag_update",
                json.dumps({"key": self._vkey(key, version_id),
                            "tags": tags or {},
                            "expect_object": True}).encode())
        except RadosError as e:
            if e.rc == -2:
                raise RGWError("NoSuchVersion",
                               f"{key}@{version_id}")
            raise
        kv = await self._index_get(bucket, key, meta)
        if key in kv:
            cur = json.loads(kv[key])
            if cur.get("version_id") == version_id:
                await self._tag_update(bucket, meta, key, tags,
                                       expect_etag=cur.get("etag"))

    async def put_object_tagging(self, bucket: str, key: str,
                                 tags: dict[str, str],
                                 version_id: str | None = None
                                 ) -> None:
        """S3 PutObjectTagging (?versionId targets that version)."""
        meta = await self._check_bucket(
            bucket, "WRITE", action="s3:PutObjectTagging", key=key)
        self.validate_tags(tags)
        if version_id:
            await self._tag_update_version(bucket, meta, key,
                                           version_id, dict(tags))
        else:
            await self._tag_update(bucket, meta, key, dict(tags))

    async def get_object_tagging(self, bucket: str, key: str,
                                 version_id: str | None = None
                                 ) -> dict[str, str]:
        if version_id:
            await self._check_bucket(
                bucket, "READ", action="s3:GetObjectTagging",
                key=key)
            entry = await self._lookup_version_entry(bucket, key,
                                                     version_id)
        else:
            entry = await self._entry(bucket, key,
                                      action="s3:GetObjectTagging")
        return dict(entry.get("tags") or {})

    async def delete_object_tagging(self, bucket: str, key: str,
                                    version_id: str | None = None
                                    ) -> None:
        meta = await self._check_bucket(
            bucket, "WRITE", action="s3:DeleteObjectTagging", key=key)
        if version_id:
            await self._tag_update_version(bucket, meta, key,
                                           version_id, None)
        else:
            await self._tag_update(bucket, meta, key, None)

    # -- CORS (rgw_cors.cc) ------------------------------------------------
    async def put_bucket_cors(self, bucket: str,
                              rules: list[dict]) -> None:
        """rules: [{allowed_origins, allowed_methods,
        allowed_headers?, expose_headers?, max_age_seconds?}] —
        origins may carry one ``*`` wildcard, as S3 allows."""
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        if not rules:
            # S3 rejects a rule-less document (MalformedXML): an
            # empty config must not shadow NoSuchCORSConfiguration
            raise RGWError("InvalidArgument",
                           "CORSConfiguration needs at least one rule")
        for r in rules:
            if not r.get("allowed_origins") \
                    or not r.get("allowed_methods"):
                raise RGWError("InvalidArgument",
                               "rule needs origins + methods")
            bad = [m for m in r["allowed_methods"]
                   if m not in ("GET", "PUT", "POST", "DELETE",
                                "HEAD")]
            if bad:
                raise RGWError("InvalidArgument",
                               f"unsupported methods {bad}")
            multi = [p for p in r["allowed_origins"]
                     if p.count("*") > 1]
            multi += [p for p in r.get("allowed_headers", ())
                      if p.count("*") > 1]
            if multi:
                raise RGWError("InvalidRequest",
                               f"origins/headers allow at most one "
                               f"'*': {multi}")
        meta["cors"] = [dict(r) for r in rules]
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_cors(self, bucket: str) -> list[dict]:
        # a config document: owner-gated like policy/notification
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        cors = meta.get("cors")
        if cors is None:
            raise RGWError("NoSuchCORSConfiguration", bucket)
        return cors

    async def delete_bucket_cors(self, bucket: str) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta.pop("cors", None)
        await self._put_bucket_meta(bucket, meta)

    @staticmethod
    def _cors_pattern_ok(pat: str, value: str) -> bool:
        """One-'*'-wildcard match (rgw_cors.cc host_name_matches),
        shared by origin and AllowedHeader evaluation."""
        if pat == "*":
            return True
        head, star, tail = pat.partition("*")
        if not star:
            return pat == value
        return (value.startswith(head) and value.endswith(tail)
                and len(value) >= len(head) + len(tail))

    @staticmethod
    def cors_match(rules: list[dict], origin: str,
                   method: str) -> dict | None:
        """First rule matching (origin, method)."""
        for r in rules:
            if method in r.get("allowed_methods", ()) and any(
                    RGWLite._cors_pattern_ok(p, origin)
                    for p in r.get("allowed_origins", ())):
                return r
        return None

    @staticmethod
    def cors_header_grant(rule: dict,
                          requested: list[str]) -> list[str] | None:
        """The requested headers when EVERY one is allowed by the
        rule (wildcard patterns included), else None — a preflight
        with any disallowed header must fail, not silently grant a
        subset the browser will reject anyway."""
        allowed = [h.lower() for h in rule.get("allowed_headers", ())]
        for h in requested:
            if not any(RGWLite._cors_pattern_ok(p, h.lower())
                       for p in allowed):
                return None
        return requested

    async def put_bucket_compression(self, bucket: str,
                                     alg: str | None = "zlib") -> None:
        """Per-bucket at-rest compression (rgw_compression.cc role):
        object PUTs store compressed bytes through the shared registry
        (common/compressor — zlib/zstd/lzma/bz2); S3-visible size/etag
        stay the ORIGINAL object's.  ``None`` disables (existing
        objects stay as stored, each entry remembering its alg)."""
        if alg is not None and alg not in list_compressors():
            raise RGWError("InvalidArgument", f"unknown algorithm {alg}")
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        if alg is None:
            meta.pop("compression", None)
        else:
            meta["compression"] = alg
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_compression(self, bucket: str) -> str | None:
        meta = await self._check_bucket(bucket, "READ")
        return meta.get("compression")

    async def put_bucket_versioning(self, bucket: str,
                                    enabled: bool) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        if not enabled and (meta.get("object_lock")
                            or {}).get("enabled"):
            # suspension would let the implicit-null overwrite path
            # destroy WORM-protected data (S3 forbids it too)
            raise RGWError("InvalidBucketState",
                           "object-lock buckets cannot suspend "
                           "versioning")
        meta["versioning"] = "enabled" if enabled else "suspended"
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_versioning(self, bucket: str) -> str:
        meta = await self._check_bucket(bucket, "READ")
        return meta.get("versioning", "")

    async def _adopt_null_version(self, bucket: str, key: str,
                                  old: dict) -> None:
        """A current entry written BEFORE versioning was enabled has no
        version record; S3 keeps it as the 'null' version — without
        this, overwriting it would orphan its data forever."""
        if old.get("version_id") or old.get("delete_marker"):
            return
        adopted = dict(old)
        adopted["version_id"] = "null"
        adopted.setdefault("data_oid", self._data_oid(bucket, key))
        await self._record_version(bucket, key, adopted)

    async def _suspended_replaced(self, bucket: str, key: str,
                                  existing_raw) -> tuple[int, bool]:
        """(freed_bytes, replaces_a_counted_object) for a suspended-
        state overwrite: the stored 'null' version is what dies; a
        non-null current entry survives as history and frees nothing."""
        try:
            recs = await self.ioctx.get_omap(
                self._versions_oid(bucket),
                [self._vkey(key, "null")])
        except RadosError as e:
            if e.rc != -2:
                raise
            recs = {}
        if recs:
            rec = json.loads(next(iter(recs.values())))
            if rec.get("delete_marker"):
                return 0, False       # markers hold no counted bytes
            return int(rec.get("size", 0)), True
        if existing_raw is not None:
            old = json.loads(existing_raw)
            if not old.get("version_id") \
                    and not old.get("delete_marker"):
                return int(old.get("size", 0)), True
        return 0, False

    async def _remove_null_version(self, bucket: str,
                                   key: str) -> None:
        """Drop the existing 'null' version record and its data.
        Suspended-state PUT/DELETE *replace* the null version (S3
        suspended-bucket semantics) rather than stacking history."""
        vkey = self._vkey(key, "null")
        try:
            recs = await self.ioctx.get_omap(
                self._versions_oid(bucket), [vkey])
        except RadosError as e:
            if e.rc != -2:
                raise
            return
        if vkey not in recs:
            return
        await self._remove_entry_data(bucket, key,
                                      json.loads(recs[vkey]))
        await self.ioctx.rm_omap_keys(self._versions_oid(bucket),
                                      [vkey])

    async def _remove_entry_data(self, bucket: str, key: str,
                                 rec: dict) -> None:
        """Removal of an entry's data objects (plain, striped, or
        multipart); tolerant of already-gone objects.  With
        ``gc_min_wait`` > 0 the objects are queued for deferred GC
        deletion instead (rgw_gc tail deletion: the index entry dies
        now, the data dies after the grace window)."""
        items: list = []
        # items carry the tail's placement pool as a third element so
        # cold-tier tails die in their own pool (absent/None = zone
        # pool; 2-element entries from older GC queues still parse)
        pool = rec.get("pool")
        if rec.get("slo"):
            return                  # segments are independent objects
        if rec.get("multipart"):
            items += [["plain", p["oid"], pool]
                      for p in rec["multipart"]]
        elif rec.get("striped"):
            items.append(["striped",
                          rec.get("data_oid",
                                  self._data_oid(bucket, key)), pool])
        elif not rec.get("delete_marker"):
            items.append(["plain",
                          rec.get("data_oid",
                                  self._data_oid(bucket, key)), pool])
        if not items:
            return
        if self.gc_min_wait > 0:
            await self._gc_enqueue(items, bucket, key)
        else:
            await self._gc_delete(items)

    def _new_version_id(self) -> str:
        # time-ordered prefix so listing versions newest-first is a
        # reverse lexical sort
        return f"{int(time.time() * 1e6):016x}{secrets.token_hex(4)}"

    async def _record_version(self, bucket: str, key: str,
                              entry: dict) -> None:
        await self.ioctx.operate(
            self._versions_oid(bucket),
            ObjectOperation().create().omap_set({
                self._vkey(key, entry["version_id"]):
                json.dumps(entry).encode(),
            }),
        )

    async def list_object_versions(self, bucket: str,
                                   prefix: str = "") -> list[dict]:
        """Newest-first per key (S3 ListObjectVersions)."""
        await self._check_bucket(bucket, "READ",
                                 action="s3:ListBucketVersions")
        meta = await self._bucket_meta(bucket)
        try:
            omap = await self.ioctx.get_omap(self._versions_oid(bucket))
        except RadosError as e:
            if e.rc != -2:
                raise
            if not meta.get("versioning"):
                return []
            omap = {}
        current = await self._index_all(bucket, meta)
        current_entries = {k: json.loads(v)
                           for k, v in current.items()}
        current_vid = {k: e.get("version_id")
                       for k, e in current_entries.items()}
        out = []
        have = {tuple(vk.partition("\x00")[::2]) for vk in omap}
        for k, e in (current_entries.items()
                     if meta.get("versioning") else ()):
            # pre-versioning current: implicit, un-recorded 'null'
            if not k.startswith(prefix) or e.get("version_id") \
                    or e.get("delete_marker") or (k, "null") in have:
                continue
            item = {
                "key": k, "version_id": "null",
                "size": e.get("size", 0), "etag": e.get("etag", ""),
                "mtime": e.get("mtime", 0.0),
                "is_latest": True, "delete_marker": False,
            }
            if e.get("storage_class"):
                item["storage_class"] = e["storage_class"]
            out.append(item)
        for vk, raw in omap.items():
            key, _, vid = vk.partition("\x00")
            if not key.startswith(prefix):
                continue
            e = json.loads(raw)
            item = {
                "key": key, "version_id": vid,
                "size": e.get("size", 0), "etag": e.get("etag", ""),
                "mtime": e.get("mtime", 0.0),
                "is_latest": current_vid.get(key) == vid,
                "delete_marker": bool(e.get("delete_marker")),
                "tags": dict(e.get("tags") or {}),
            }
            if e.get("storage_class"):
                item["storage_class"] = e["storage_class"]
            out.append(item)
        # newest-first within each key, by write time: the adopted
        # 'null' version keeps its original (oldest) mtime while a
        # suspended-state 'null' PUT is genuinely newest — lexical
        # version-id order would missort 'null' ('n' > any hex digit)
        out.sort(key=lambda v: (
            v["mtime"],
            "" if v["version_id"] == "null" else v["version_id"],
        ), reverse=True)
        out.sort(key=lambda v: v["key"])      # stable: keys ascending
        return out

    async def _lookup_version_entry(self, bucket: str, key: str,
                                    version_id: str) -> dict:
        """The stored record for key@version_id ('null' falls back to
        an un-adopted pre-versioning current); raises on markers so
        GET and HEAD stay bit-identical in their semantics."""
        try:
            kv = await self.ioctx.get_omap(
                self._versions_oid(bucket),
                [self._vkey(key, version_id)],
            )
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if not kv and version_id == "null":
            cur = await self._index_get(bucket, key)
            if key in cur:
                e = json.loads(cur[key])
                if not e.get("version_id") \
                        and not e.get("delete_marker"):
                    kv = {key: cur[key]}
        if not kv:
            raise RGWError("NoSuchVersion", f"{key}@{version_id}")
        entry = json.loads(next(iter(kv.values())))
        if entry.get("delete_marker"):
            raise RGWError("MethodNotAllowed",
                           f"{key}@{version_id} is a delete marker")
        return entry

    async def get_object_version(self, bucket: str, key: str,
                                 version_id: str,
                                 sse_key: bytes | None = None) -> dict:
        """GET ?versionId= — any stored version, marker or not.
        ``sse_key``: SSE-C decryption, including multipart versions
        whose parts carry their own nonces."""
        await self._check_bucket(bucket, "READ",
                                 action="s3:GetObjectVersion", key=key)
        entry = await self._lookup_version_entry(bucket, key,
                                                 version_id)
        dk = await self._entry_sse_key(entry, sse_key)
        if entry.get("comp"):
            data = await self._inflate_read(entry, None)
        elif dk is not None and entry["sse"].get("multipart"):
            data = await self._read_manifest(
                entry["multipart"], int(entry["size"]), None,
                sse_key=dk, pool=entry.get("pool"))
        else:
            data = await self._read_entry_data(bucket, key, entry,
                                               None)
            if dk is not None:
                data = sse_crypt(
                    dk, bytes.fromhex(entry["sse"]["nonce"]),
                    0, data)
        return {"data": data, **entry}

    async def head_object_version(self, bucket: str, key: str,
                                  version_id: str) -> dict:
        """HEAD ?versionId=: the version's metadata without reading
        its (possibly huge) body."""
        await self._check_bucket(bucket, "READ",
                                 action="s3:GetObjectVersion", key=key)
        return await self._lookup_version_entry(bucket, key,
                                                version_id)

    @_reclaims_space
    async def delete_object_version(self, bucket: str, key: str,
                                    version_id: str,
                                    bypass_governance: bool = False
                                    ) -> None:
        """DELETE ?versionId=: permanently removes that version; when
        it was current, the next-newest version is promoted (markers
        included).  Object-lock retention and legal holds block this
        (markers never do — they destroy no data); GOVERNANCE yields
        to ``bypass_governance`` only when the caller also holds
        s3:BypassGovernanceRetention."""
        meta = await self._check_bucket(
            bucket, "WRITE", action="s3:DeleteObjectVersion", key=key)
        if bypass_governance:
            bypass_governance = await self._bypass_allowed(bucket,
                                                           key)
        vkey = self._vkey(key, version_id)
        try:
            kv = await self.ioctx.get_omap(self._versions_oid(bucket),
                                           [vkey])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if not kv and version_id == "null":
            cur = await self._index_get(bucket, key, meta)
            if key in cur:
                e = json.loads(cur[key])
                if not e.get("version_id") \
                        and not e.get("delete_marker"):
                    why = self._lock_blocks_delete(
                        e, bypass_governance)
                    if why:
                        raise RGWError("AccessDenied", why)
                    await self._remove_entry_data(bucket, key, e)
                    await self._index_rm(bucket, meta, key)
                    await self._log(bucket, "del-version", key)
                    return
        if not kv:
            raise RGWError("NoSuchVersion", f"{key}@{version_id}")
        entry = json.loads(next(iter(kv.values())))
        if not entry.get("delete_marker"):
            why = self._lock_blocks_delete(entry, bypass_governance)
            if why:
                raise RGWError("AccessDenied", why)
        await self._remove_entry_data(bucket, key, entry)
        await self.ioctx.rm_omap_keys(self._versions_oid(bucket),
                                      [vkey])
        # promote the next-newest remaining version when the deleted
        # one was current
        current = await self._index_get(bucket, key, meta)
        if key in current and json.loads(current[key]).get(
                "version_id") == version_id:
            remaining = [
                v for v in await self.list_object_versions(
                    bucket, prefix=key)
                if v["key"] == key
            ]
            if remaining:
                vk = self._vkey(key, remaining[0]["version_id"])
                raw = (await self.ioctx.get_omap(
                    self._versions_oid(bucket), [vk]))[vk]
                await self._index_set(bucket, meta, key, raw)
            else:
                await self._index_rm(bucket, meta, key)
        await self._log(bucket, "del-version", key)

    # -- multipart upload (rgw_multi.cc: initiate/part/complete/abort) ----
    @staticmethod
    def _mp_meta_oid(bucket: str, key: str, upload_id: str) -> str:
        return f"rgw.multipart.{bucket}/{key}.{upload_id}"

    @staticmethod
    def _mp_part_oid(bucket: str, key: str, upload_id: str,
                     part: int) -> str:
        return f"rgw.part.{bucket}/{key}.{upload_id}.{part:05d}"

    async def initiate_multipart(self, bucket: str, key: str,
                                 content_type: str =
                                 "binary/octet-stream",
                                 metadata: dict | None = None,
                                 lock: dict | None = None,
                                 sse: str | None = None,
                                 kms_key_id: str | None = None,
                                 storage_class: str | None = None
                                 ) -> str:
        """S3 CreateMultipartUpload -> upload id.  ``lock``: object
        -lock headers ride the INITIATE (S3 applies them to the
        assembled object at complete).  ``sse``/``kms_key_id``:
        SSE-KMS / SSE-S3 — one data key is wrapped at initiate and
        every part encrypts under it (its own nonce per part).
        ``storage_class``: x-amz-storage-class from the initiate —
        every part inherits it, so part bodies land directly in the
        class's placement pool."""
        meta = await self._check_bucket(bucket, "WRITE",
                                       action="s3:PutObject", key=key)
        if lock:
            # validate now: a bad mode must fail the initiate, not
            # the complete after every part is uploaded
            self._stage_lock({"meta": meta}, lock)
        sclass = (storage_class or "").strip() or None
        pool = None
        if sclass and sclass != "STANDARD":
            pool = (await self._class_placement(sclass)).get("pool") \
                or None
        else:
            sclass = None
        sse_kms = None
        if sse is not None:
            _, rec = await self._kms_begin(sse, kms_key_id)
            sse_kms = {"alg": rec["alg"], "key_id": rec["key_id"],
                       "wrapped": rec["wrapped"]}
        upload_id = secrets.token_hex(8)
        await self.ioctx.operate(
            self._mp_meta_oid(bucket, key, upload_id),
            ObjectOperation().create().omap_set({
                "_meta": json.dumps({
                    "key": key, "initiated": time.time(),
                    "content_type": content_type,
                    "meta": dict(metadata or {}),
                    "owner": self.user or "",
                    "lock": lock,
                    "sse_kms": sse_kms,
                    "storage_class": sclass,
                    "pool": pool,
                }).encode(),
            }),
        )
        return upload_id

    async def _mp_meta(self, bucket: str, key: str,
                       upload_id: str) -> dict:
        try:
            omap = await self.ioctx.get_omap(
                self._mp_meta_oid(bucket, key, upload_id)
            )
        except RadosError as e:
            if e.rc == -2:
                raise RGWError("NoSuchUpload", upload_id) from e
            raise
        return omap

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part_number: int, data: bytes,
                          sse_key: bytes | None = None) -> dict:
        """S3 UploadPart; re-uploading a part number replaces it.
        ``sse_key``: SSE-C — each part encrypts under its own nonce at
        part-relative offsets (rgw_crypt.cc multipart rule: the part
        boundary resets the counter, so the assembled read can seek)."""
        if not 1 <= part_number <= 10000:
            raise RGWError("InvalidArgument", "part number 1..10000")
        meta = await self._check_bucket(
            bucket, "WRITE", action="s3:PutObject", key=key)
        info = json.loads(
            (await self._mp_meta(bucket, key, upload_id))["_meta"])
        await self._check_quota(bucket, meta, len(data),
                                replaced_size=0, is_replace=False)
        etag = hashlib.md5(data).hexdigest()
        rec = {"etag": etag, "size": len(data)}
        if info.get("sse_kms") is not None:
            if sse_key is not None:
                raise RGWError("InvalidRequest",
                               "upload uses KMS encryption, not SSE-C")
            from ceph_tpu_torch.services.kms import KMSError

            sk = info["sse_kms"]
            try:
                dk = await self.kms.unwrap_data_key(sk["key_id"],
                                                    sk["wrapped"])
            except (AttributeError, KMSError) as e:
                raise RGWError("InvalidRequest",
                               f"KMS unwrap failed: {e}") from e
            nonce = secrets.token_bytes(16).hex()
            data = sse_crypt(dk, bytes.fromhex(nonce), 0, data)
            rec["sse"] = {"nonce": nonce, "kms": True}
        elif sse_key is not None:
            sse = sse_begin(sse_key)
            data = sse_crypt(sse_key, bytes.fromhex(sse["nonce"]),
                             0, data)
            rec["sse"] = sse
        # part bodies land in the upload's storage class pool (the
        # meta omap stays in the zone pool)
        data_ioctx, _ = await self._data_handles(info.get("pool"))
        await data_ioctx.operate(
            self._mp_part_oid(bucket, key, upload_id, part_number),
            ObjectOperation().write_full(data),
        )
        await self.ioctx.set_omap(
            self._mp_meta_oid(bucket, key, upload_id), {
                f"part.{part_number:05d}": json.dumps(rec).encode(),
            },
        )
        return {"etag": etag, "part_number": part_number}

    async def upload_part_copy(self, bucket: str, key: str,
                               upload_id: str, part_number: int,
                               src_bucket: str, src_key: str,
                               src_range: tuple[int, int]
                               | None = None,
                               sse_key: bytes | None = None,
                               src_sse_key: bytes
                               | None = None) -> dict:
        """S3 UploadPartCopy: a part sourced from an existing object
        (optionally a byte range) — reads ride the normal authorized
        GET path, the part lands like any uploaded part.
        ``sse_key``/``src_sse_key``: destination-part / copy-source
        SSE-C customer keys."""
        if src_range is not None:
            a, b = src_range
            if a < 0 or b < a:
                raise RGWError("InvalidArgument",
                               f"bad copy range {src_range}")
        got = await self.get_object(src_bucket, src_key,
                                    range_=src_range,
                                    sse_key=src_sse_key)
        if src_range is not None and \
                len(got["data"]) != src_range[1] - src_range[0] + 1:
            # S3 rejects ranges past the source's end instead of
            # clamping: silent truncation would corrupt the assembly
            raise RGWError("InvalidArgument",
                           "copy range exceeds the source size")
        if not got["data"]:
            raise RGWError("InvalidRequest", "copy source is empty")
        return await self.upload_part(bucket, key, upload_id,
                                      part_number, got["data"],
                                      sse_key=sse_key)

    async def list_parts(self, bucket: str, key: str,
                         upload_id: str) -> list[dict]:
        omap = await self._mp_meta(bucket, key, upload_id)
        return [
            {"part_number": int(k.split(".", 1)[1]),
             **json.loads(v)}
            for k, v in sorted(omap.items())
            if k.startswith("part.")
        ]

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 parts: list[tuple[int, str]]) -> dict:
        """S3 CompleteMultipartUpload: validates the client's part list
        (numbers ascending, etags matching), records a MANIFEST entry —
        the object body stays in the part objects, read through the
        manifest like the reference's RGWObjManifest."""
        await self._check_bucket(bucket, "WRITE",
                                 action="s3:PutObject", key=key)
        uploaded = {p["part_number"]: p
                    for p in await self.list_parts(bucket, key,
                                                   upload_id)}
        if not parts:
            raise RGWError("InvalidArgument", "empty part list")
        meta_omap = await self._mp_meta(bucket, key, upload_id)
        info = json.loads(meta_omap["_meta"])
        kms_mode = info.get("sse_kms") is not None
        manifest = []
        total = 0
        digest_md5 = hashlib.md5()
        sse_md5s: set = set()
        last = 0
        for num, etag in parts:
            if num <= last:
                raise RGWError("InvalidPartOrder", str(num))
            last = num
            have = uploaded.get(num)
            if have is None or have["etag"] != etag:
                raise RGWError("InvalidPart", str(num))
            item = {
                "oid": self._mp_part_oid(bucket, key, upload_id, num),
                "size": have["size"], "etag": etag,
            }
            psse = have.get("sse")
            if psse is not None:
                item["nonce"] = psse["nonce"]
            if kms_mode:
                if psse is None or not psse.get("kms"):
                    raise RGWError(
                        "InvalidRequest",
                        "plaintext part inside a KMS-encrypted upload")
            else:
                sse_md5s.add(psse.get("key_md5") if psse else None)
            manifest.append(item)
            total += have["size"]
            digest_md5.update(bytes.fromhex(etag))
        entry_sse = None
        if kms_mode:
            entry_sse = {**info["sse_kms"], "multipart": True}
        elif sse_md5s != {None}:
            # encrypted parts: every part must be under the SAME key,
            # and a plaintext part cannot hide inside an SSE-C object
            if None in sse_md5s or len(sse_md5s) != 1:
                raise RGWError(
                    "InvalidRequest",
                    "all parts must use the same SSE-C key")
            entry_sse = {"alg": "AES256", "key_md5": sse_md5s.pop(),
                         "multipart": True}
        # the assembled size is the real quota event (parts are not in
        # the bucket index, so per-part checks cannot see each other)
        bucket_meta = await self._bucket_meta(bucket)
        self._index_writable(bucket_meta)
        existing0 = await self._index_get(bucket, key, bucket_meta)
        versioned = bucket_meta.get("versioning") == "enabled"
        suspended = bucket_meta.get("versioning") == "suspended"
        if versioned:
            replaced, is_replace = 0, False
        elif suspended:
            replaced, is_replace = await self._suspended_replaced(
                bucket, key, existing0.get(key))
        else:
            replaced = (json.loads(existing0[key])["size"]
                        if key in existing0 else 0)
            is_replace = key in existing0
        await self._check_quota(bucket, bucket_meta, total,
                                replaced_size=replaced,
                                is_replace=is_replace)
        # the S3 multipart etag form: md5-of-part-md5s + part count
        etag = f"{digest_md5.hexdigest()}-{len(manifest)}"
        # drop uploaded-but-unused parts
        data_ioctx, _ = await self._data_handles(info.get("pool"))
        used = {m["oid"] for m in manifest}
        for num in uploaded:
            oid = self._mp_part_oid(bucket, key, upload_id, num)
            if oid not in used:
                try:
                    await data_ioctx.remove(oid)
                except RadosError as e:
                    if e.rc != -2:
                        raise
        # replacing an existing plain/multipart object: clean old data.
        # Re-read the index HERE: awaits since existing0 (quota check,
        # part cleanup) give concurrent PUT/DELETEs of the same key a
        # window — a stale snapshot would leak a racer's data objects
        existing = await self._index_get(bucket, key, bucket_meta)
        entry = {
            "size": total, "etag": etag, "mtime": time.time(),
            "content_type": info["content_type"], "striped": False,
            "meta": info["meta"], "multipart": manifest,
        }
        if info.get("storage_class"):
            entry["storage_class"] = info["storage_class"]
        if info.get("pool"):
            entry["pool"] = info["pool"]
        if entry_sse is not None:
            entry["sse"] = entry_sse
        # WORM state for the ASSEMBLED object: initiate-time headers
        # or the bucket default (the buffered/streaming paths stage
        # this in _prepare_put; multipart assembles its own entry)
        lock_ctx = {"meta": bucket_meta}
        self._stage_lock(lock_ctx, info.get("lock"),
                         validate=False)
        if lock_ctx.get("lock_retention"):
            entry["retention"] = lock_ctx["lock_retention"]
        if lock_ctx.get("lock_legal_hold"):
            entry["legal_hold"] = True
        if versioned:
            # the assembled object is a NEW version; prior current
            # (incl. pre-versioning 'null') survives as history
            if key in existing:
                await self._adopt_null_version(
                    bucket, key, json.loads(existing[key])
                )
            entry["version_id"] = self._new_version_id()
            await self._record_version(bucket, key, entry)
        elif suspended:
            # the assembled object REPLACES the 'null' version (same
            # rule as a suspended PUT); other versions survive
            await self._remove_null_version(bucket, key)
            if key in existing:
                old = json.loads(existing[key])
                if not old.get("version_id"):
                    await self._remove_entry_data(bucket, key, old)
            entry["version_id"] = "null"
            await self._record_version(bucket, key, entry)
        elif key in existing:
            await self.delete_object(bucket, key)
        await self._index_set(bucket, bucket_meta, key,
                              json.dumps(entry).encode())
        await self.ioctx.remove(
            self._mp_meta_oid(bucket, key, upload_id)
        )
        await self._log(bucket, "put", key, etag, size=total)
        await self._maybe_auto_reshard(bucket, bucket_meta, key)
        out = {"etag": etag, "size": total}
        if entry.get("version_id") and not suspended:
            out["version_id"] = entry["version_id"]
        return out

    @_reclaims_space
    async def abort_multipart(self, bucket: str, key: str,
                              upload_id: str) -> None:
        await self._check_bucket(
            bucket, "WRITE", action="s3:AbortMultipartUpload", key=key)
        omap = await self._mp_meta(bucket, key, upload_id)
        info = json.loads(omap["_meta"])
        data_ioctx, _ = await self._data_handles(info.get("pool"))
        for k in omap:
            if not k.startswith("part."):
                continue
            try:
                await data_ioctx.remove(self._mp_part_oid(
                    bucket, key, upload_id, int(k.split(".", 1)[1])
                ))
            except RadosError as e:
                if e.rc != -2:
                    raise
        await self.ioctx.remove(
            self._mp_meta_oid(bucket, key, upload_id)
        )

    async def list_multipart_uploads(self, bucket: str) -> list[dict]:
        await self._check_bucket(
            bucket, "READ", action="s3:ListBucketMultipartUploads")
        prefix = f"rgw.multipart.{bucket}/"
        out = []
        for oid in await self.ioctx.list_objects():
            if not oid.startswith(prefix):
                continue
            rest = oid[len(prefix):]
            key, _, upload_id = rest.rpartition(".")
            out.append({"key": key, "upload_id": upload_id})
        return sorted(out, key=lambda u: (u["key"], u["upload_id"]))

    # -- static website hosting (rgw_website.cc role) ---------------------
    async def put_bucket_website(self, bucket: str, index_doc: str,
                                 error_doc: str = "") -> None:
        """PutBucketWebsite: serve the bucket as a website for
        ANONYMOUS browsers — directory paths resolve to the index
        document, missing keys to the error document."""
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        if not index_doc or "/" in index_doc:
            raise RGWError("InvalidArgument",
                           f"bad index document {index_doc!r}")
        meta["website"] = {"index": index_doc, "error": error_doc}
        await self._put_bucket_meta(bucket, meta)

    async def get_bucket_website(self, bucket: str) -> dict:
        meta = await self._check_bucket(bucket, "READ")
        cfg = meta.get("website")
        if not cfg:
            raise RGWError("NoSuchWebsiteConfiguration", bucket)
        return dict(cfg)

    async def delete_bucket_website(self, bucket: str) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta.pop("website", None)
        await self._put_bucket_meta(bucket, meta)

    # -- S3 Object Lock (rgw_object_lock.cc: WORM retention) --------------
    _LOCK_MODES = ("GOVERNANCE", "COMPLIANCE")

    async def put_object_lock_config(self, bucket: str,
                                     mode: str | None = None,
                                     days: int = 0,
                                     years: int = 0) -> None:
        """PutObjectLockConfiguration: the bucket DEFAULT retention
        new versions inherit.  Only valid on buckets created with
        object lock (S3's InvalidBucketState rule)."""
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        if not (meta.get("object_lock") or {}).get("enabled"):
            raise RGWError("InvalidBucketState",
                           "bucket was not created with object lock")
        cfg: dict = {"enabled": True}
        if mode is not None:
            if mode not in self._LOCK_MODES:
                raise RGWError("MalformedXML", f"bad mode {mode!r}")
            if bool(days) == bool(years):
                raise RGWError("MalformedXML",
                               "exactly one of days/years")
            if (days or years) <= 0:
                raise RGWError("InvalidArgument",
                               "retention period must be positive")
            cfg["mode"] = mode
            cfg["days"] = int(days)
            cfg["years"] = int(years)
        meta["object_lock"] = cfg
        await self._put_bucket_meta(bucket, meta)

    async def get_object_lock_config(self, bucket: str) -> dict:
        meta = await self._check_bucket(bucket, "READ")
        cfg = meta.get("object_lock")
        if not cfg:
            raise RGWError("ObjectLockConfigurationNotFoundError",
                           bucket)
        return dict(cfg)

    def _default_retention_until(self, meta: dict) -> dict | None:
        cfg = meta.get("object_lock") or {}
        if not cfg.get("mode"):
            return None
        period = (cfg.get("days", 0) * 86400
                  + cfg.get("years", 0) * 365 * 86400)
        return {"mode": cfg["mode"], "until": time.time() + period}

    async def _lock_entry(self, bucket: str, key: str,
                          version_id: str | None,
                          need: str = "WRITE",
                          action: str = "s3:PutObjectRetention"):
        """(entry, write-back) for the version a lock op targets:
        current index entry when no version_id, else the version
        record.  write-back persists a mutated entry to BOTH the
        version table and (when current) the index."""
        meta = await self._check_bucket(bucket, need, action=action,
                                       key=key)
        if not (meta.get("object_lock") or {}).get("enabled"):
            raise RGWError("InvalidRequest",
                           "bucket has no object lock")
        kv = await self._index_get(bucket, key, meta)
        cur = json.loads(kv[key]) if key in kv else None
        if version_id is None:
            if cur is None or cur.get("delete_marker"):
                raise RGWError("NoSuchKey", f"{bucket}/{key}")
            entry = cur
        else:
            try:
                recs = await self.ioctx.get_omap(
                    self._versions_oid(bucket),
                    [self._vkey(key, version_id)])
            except RadosError as e:
                if e.rc != -2:
                    raise
                recs = {}
            if not recs:
                raise RGWError("NoSuchVersion",
                               f"{key}@{version_id}")
            entry = json.loads(next(iter(recs.values())))
            if entry.get("delete_marker"):
                # S3 answers 405: a marker destroys no data, so
                # "protection" on one would be a lie nothing enforces
                raise RGWError("MethodNotAllowed",
                               "object lock on a delete marker")

        async def write_back(e: dict) -> None:
            vid = e.get("version_id")
            if vid:
                await self.ioctx.set_omap(
                    self._versions_oid(bucket),
                    {self._vkey(key, vid): json.dumps(e).encode()})
            if cur is not None and cur.get("version_id") \
                    == e.get("version_id"):
                await self._index_set(bucket, meta, key,
                                      json.dumps(e).encode())
        return entry, write_back

    async def put_object_retention(self, bucket: str, key: str,
                                   mode: str, until: float,
                                   version_id: str | None = None,
                                   bypass_governance: bool = False
                                   ) -> None:
        """PutObjectRetention.  COMPLIANCE can never be shortened or
        downgraded; GOVERNANCE changes that loosen protection need
        the bypass flag (s3:BypassGovernanceRetention role)."""
        if mode not in self._LOCK_MODES:
            raise RGWError("MalformedXML", f"bad mode {mode!r}")
        if until <= time.time():
            raise RGWError("InvalidArgument",
                           "retain-until must be in the future")
        entry, write_back = await self._lock_entry(bucket, key,
                                                   version_id)
        old = entry.get("retention")
        if old:
            loosens = (until < float(old["until"])
                       or (old["mode"] == "COMPLIANCE"
                           and mode != "COMPLIANCE"))
            if loosens and old["mode"] == "COMPLIANCE":
                raise RGWError("AccessDenied",
                               "COMPLIANCE retention cannot be "
                               "loosened")
            if loosens and not (
                    bypass_governance
                    and await self._bypass_allowed(bucket, key)):
                raise RGWError("AccessDenied",
                               "governance bypass required")
        entry["retention"] = {"mode": mode, "until": float(until)}
        await write_back(entry)

    async def get_object_retention(self, bucket: str, key: str,
                                   version_id: str | None = None
                                   ) -> dict:
        entry, _ = await self._lock_entry(
            bucket, key, version_id, need="READ",
            action="s3:GetObjectRetention")
        ret = entry.get("retention")
        if not ret:
            raise RGWError("NoSuchObjectLockConfiguration", key)
        return dict(ret)

    async def put_object_legal_hold(self, bucket: str, key: str,
                                    status: bool,
                                    version_id: str | None = None
                                    ) -> None:
        entry, write_back = await self._lock_entry(
            bucket, key, version_id,
            action="s3:PutObjectLegalHold")
        entry["legal_hold"] = bool(status)
        await write_back(entry)

    async def get_object_legal_hold(self, bucket: str, key: str,
                                    version_id: str | None = None
                                    ) -> str:
        entry, _ = await self._lock_entry(
            bucket, key, version_id, need="READ",
            action="s3:GetObjectLegalHold")
        return "ON" if entry.get("legal_hold") else "OFF"

    def _stage_lock(self, ctx: dict, lock: dict | None,
                    validate: bool = True) -> None:
        """Resolve the new version's lock state into the put ctx:
        explicit headers win, else the bucket default retention.
        Explicit lock state on a bucket without object lock is an
        InvalidRequest, as S3 refuses it.  ``validate=False`` replays
        values validated at an earlier request (multipart complete
        re-staging initiate-time headers: a retain-until date that
        lapsed DURING the upload must not strand the parts)."""
        meta = ctx.get("meta") or {}
        enabled = (meta.get("object_lock") or {}).get("enabled")
        if lock:
            if not enabled:
                raise RGWError("InvalidRequest",
                               "bucket has no object lock")
            if lock.get("mode"):
                until = float(lock.get("until", 0))
                if validate:
                    if lock["mode"] not in self._LOCK_MODES:
                        raise RGWError("InvalidArgument",
                                       f"bad mode {lock['mode']!r}")
                    if until <= time.time():
                        raise RGWError("InvalidArgument",
                                       "retain-until must be in the "
                                       "future")
                ctx["lock_retention"] = {"mode": lock["mode"],
                                         "until": until}
            if lock.get("legal_hold"):
                ctx["lock_legal_hold"] = True
        if enabled and "lock_retention" not in ctx:
            # the bucket default applies whenever no EXPLICIT
            # retention came with the put — a legal-hold header must
            # not suppress a COMPLIANCE default
            default = self._default_retention_until(meta)
            if default:
                ctx["lock_retention"] = default

    async def _bypass_allowed(self, bucket: str, key: str) -> bool:
        """A requested governance bypass only counts when the caller
        holds s3:BypassGovernanceRetention (owner ACL or policy) —
        otherwise the header is a no-op, as S3 treats it."""
        try:
            await self._check_bucket(
                bucket, "WRITE",
                action="s3:BypassGovernanceRetention", key=key)
            return True
        except RGWError:
            return False

    @staticmethod
    def _lock_blocks_delete(entry: dict,
                            bypass_governance: bool) -> str | None:
        """Why a permanent delete of this version is forbidden, or
        None.  Delete MARKERS are never blocked — they destroy no
        data (S3 semantics)."""
        if entry.get("legal_hold"):
            return "version is under legal hold"
        ret = entry.get("retention")
        if ret and float(ret["until"]) > time.time():
            if ret["mode"] == "COMPLIANCE":
                return "COMPLIANCE retention until " \
                    f"{ret['until']:.0f}"
            if not bypass_governance:
                return "GOVERNANCE retention until " \
                    f"{ret['until']:.0f} (bypass required)"
        return None

    # -- lifecycle (rgw_lc.cc: expiration rules + the LC worker) ----------
    _LC_ACTIONS = ("expiration_days", "expiration_seconds",
                   "noncurrent_days", "noncurrent_seconds",
                   "abort_mpu_days", "abort_mpu_seconds",
                   "transition_days", "transition_seconds",
                   "noncurrent_transition_days",
                   "noncurrent_transition_seconds")

    async def put_lifecycle(self, bucket: str,
                            rules: list[dict]) -> None:
        """rules: [{id, prefix, status} + at least one action:
        expiration_days/_seconds (current versions),
        noncurrent_days/_seconds (NoncurrentVersionExpiration),
        abort_mpu_days/_seconds (AbortIncompleteMultipartUpload
        DaysAfterInitiation), transition_days/_seconds +
        transition_class (S3 Transition: move current versions into a
        storage class), noncurrent_transition_days/_seconds +
        noncurrent_transition_class (NoncurrentVersionTransition)]."""
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        for r in rules:
            # a lone StorageClass counts as an (incomplete) action so
            # it reaches the both-or-neither check below instead of
            # reading as "no action at all"
            if not any(k in r for k in self._LC_ACTIONS
                       + ("transition_class",
                          "noncurrent_transition_class")):
                raise RGWError("InvalidArgument",
                               f"rule {r.get('id')}: no action")
            for k in self._LC_ACTIONS:
                if k not in r:
                    continue
                try:
                    val = float(r[k])
                except (TypeError, ValueError):
                    raise RGWError("InvalidArgument",
                                   f"rule {r.get('id')}: {k}="
                                   f"{r[k]!r} is not a number") \
                        from None
                if not math.isfinite(val) or val <= 0:
                    # an explicit 0 would expire the whole prefix on
                    # the next pass; S3 rejects non-positive Days
                    raise RGWError("InvalidArgument",
                                   f"rule {r.get('id')}: {k} must "
                                   f"be positive")
            if r.get("status", "Enabled") not in ("Enabled",
                                                 "Disabled"):
                raise RGWError("MalformedXML",
                               f"rule {r.get('id')}: bad status "
                               f"{r.get('status')!r}")
            if r.get("tags") and any(k.startswith("abort_mpu")
                                     for k in r):
                # S3 refuses Filter/Tag on AbortIncompleteMultipart-
                # Upload: uploads have no tags to match, so the rule
                # would abort everything the filter meant to protect
                raise RGWError("InvalidArgument",
                               f"rule {r.get('id')}: tag filters "
                               f"cannot scope multipart aborts")
            for kind in ("transition", "noncurrent_transition"):
                limit = self._lc_limit(r, kind)
                cls = r.get(f"{kind}_class")
                if limit is None and cls is None:
                    continue
                if limit is None or not cls:
                    raise RGWError(
                        "MalformedXML",
                        f"rule {r.get('id')}: {kind} needs both a "
                        f"time and a StorageClass")
                if cls == "STANDARD":
                    # objects start in STANDARD: a transition into it
                    # is a transition to the same class
                    raise RGWError(
                        "InvalidArgument",
                        f"rule {r.get('id')}: cannot transition to "
                        f"STANDARD")
                # the class must resolve NOW: a rule naming a class no
                # placement defines would stall the LC worker later
                await self._class_placement(cls)
                # expiration-vs-transition precedence: within a rule
                # the expiration must outlive the transition or the
                # move is a wasted write on a doomed object (S3
                # rejects this combination outright)
                exp_kind = ("expiration" if kind == "transition"
                            else "noncurrent")
                exp = self._lc_limit(r, exp_kind)
                if exp is not None and exp <= limit:
                    raise RGWError(
                        "InvalidArgument",
                        f"rule {r.get('id')}: {exp_kind} expiration "
                        f"must be later than the {kind}")
        meta["lifecycle"] = [dict(r) for r in rules]
        await self._put_bucket_meta(bucket, meta)

    async def get_lifecycle(self, bucket: str) -> list[dict]:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        return meta.get("lifecycle", [])

    async def delete_lifecycle(self, bucket: str) -> None:
        meta = await self._check_bucket(bucket, "FULL_CONTROL")
        meta.pop("lifecycle", None)
        await self._put_bucket_meta(bucket, meta)

    @staticmethod
    def _lc_limit(r: dict, kind: str) -> float | None:
        """The rule's threshold in seconds for one action kind
        ("expiration"/"noncurrent"/"abort_mpu"/"transition"/
        "noncurrent_transition"), or None."""
        if f"{kind}_seconds" in r:
            return float(r[f"{kind}_seconds"])
        if f"{kind}_days" in r:
            return float(r[f"{kind}_days"]) * 86400
        return None

    @_reclaims_space
    async def lc_process(self, now: float | None = None) -> dict:
        """One LC worker pass over every bucket (RGWLC::process):
        delete current versions whose age exceeds an Enabled rule's
        expiration, permanently delete NONCURRENT versions whose
        time-since-superseded exceeds a noncurrent rule (S3 measures
        from when the version became noncurrent — the successor's
        write time — not from its own), abort incomplete multipart
        uploads past DaysAfterInitiation, then TRANSITION current and
        noncurrent versions into their rules' target storage classes
        (the data-mover phase: bodies are re-written bit-identical
        into the class's placement pool — the EC cold pool for
        COLD-style classes — and the head repoints atomically).
        Expirations run first so a doomed object is never moved.
        Returns bucket -> [keys removed or transitioned ("k->CLASS",
        "k@vid->CLASS")]."""
        now = time.time() if now is None else now
        removed: dict[str, list[str]] = {}
        sys_self = self if self.user is None else self.as_user(None)
        for bucket in await self.list_buckets():
            try:
                rules = (await self._bucket_meta(bucket)) \
                    .get("lifecycle", [])
            except RGWError:
                continue
            active = [r for r in rules
                      if r.get("status", "Enabled") == "Enabled"]
            if not active:
                continue
            got = removed.setdefault(bucket, [])
            if any(self._lc_limit(r, "expiration") is not None
                   for r in active):
                await self._lc_expire_current(sys_self, bucket,
                                              active, now, got)
            if any(self._lc_limit(r, "noncurrent") is not None
                   for r in active):
                await self._lc_expire_noncurrent(sys_self, bucket,
                                                 active, now, got)
            if any(self._lc_limit(r, "abort_mpu") is not None
                   for r in active):
                await self._lc_abort_mpus(sys_self, bucket, active,
                                          now, got)
            if any(self._lc_limit(r, "transition") is not None
                   for r in active):
                await self._lc_transition_current(sys_self, bucket,
                                                  active, now, got)
            if any(self._lc_limit(r, "noncurrent_transition")
                   is not None for r in active):
                await self._lc_transition_noncurrent(
                    sys_self, bucket, active, now, got)
            if not got:
                del removed[bucket]
        return removed

    @staticmethod
    async def _lc_walk(sys_self, bucket: str, page: int = 1000):
        """Marker-paginated LC bucket walk: the worker sees every
        current object while holding at most one page in memory — a
        million-object bucket no longer materializes a single giant
        listing per pass."""
        marker = ""
        while True:
            listing = await sys_self.list_objects(bucket,
                                                  marker=marker,
                                                  max_keys=page)
            for obj in listing["contents"]:
                yield obj
            if not listing["is_truncated"] \
                    or not listing["next_marker"]:
                return
            marker = listing["next_marker"]

    async def _lc_expire_current(self, sys_self, bucket: str,
                                 active: list[dict], now: float,
                                 got: list[str]) -> None:
        async for obj in self._lc_walk(sys_self, bucket):
            age = now - float(obj["mtime"])
            for r in active:
                limit = self._lc_limit(r, "expiration")
                if limit is None:
                    continue
                if not obj["key"].startswith(r.get("prefix", "")):
                    continue
                want = r.get("tags") or {}
                if want:
                    # tag-filtered rule (S3 lifecycle Filter/Tag):
                    # tags ride the listing, so no per-object
                    # refetch and no race against deletions
                    have = obj.get("tags") or {}
                    if any(have.get(k) != v
                           for k, v in want.items()):
                        continue
                if age > limit:
                    await sys_self.delete_object(bucket, obj["key"])
                    got.append(obj["key"])
                    break

    async def _lc_expire_noncurrent(self, sys_self, bucket: str,
                                    active: list[dict], now: float,
                                    got: list[str]) -> None:
        """NoncurrentVersionExpiration (rgw_lc.cc
        LCOpAction_NonCurrentExpiration role)."""
        versions = await sys_self.list_object_versions(bucket)
        by_key: dict[str, list[dict]] = {}
        for v in versions:
            by_key.setdefault(v["key"], []).append(v)
        for key, vs in by_key.items():
            # is_latest is the PRIMARY sort key: a current version
            # whose mtime ties (or trails — an adopted pre-versioning
            # 'null' that got re-promoted) an older version must still
            # sort first, or the pairing below would treat it as
            # noncurrent and expire the live object
            vs.sort(key=lambda v: (not v["is_latest"],
                                   -float(v["mtime"])))
            # vs[0] is current; each older version became noncurrent
            # when its SUCCESSOR was written
            for succ, v in zip(vs, vs[1:]):
                if v["is_latest"]:
                    continue
                since = now - float(succ["mtime"])
                for r in active:
                    limit = self._lc_limit(r, "noncurrent")
                    if limit is None or not key.startswith(
                            r.get("prefix", "")):
                        continue
                    want = r.get("tags") or {}
                    if want:
                        # the filter evaluates each VERSION's own tag
                        # set (a dev-tagged version must survive a
                        # prod-scoped rule)
                        have = v.get("tags") or {}
                        if any(have.get(k) != t
                               for k, t in want.items()):
                            continue
                    if since > limit:
                        try:
                            await sys_self.delete_object_version(
                                bucket, key, v["version_id"])
                        except RGWError as err:
                            if err.code != "AccessDenied":
                                raise
                            break   # object-lock protected: skip
                        got.append(f"{key}@{v['version_id']}")
                        break

    async def _lc_abort_mpus(self, sys_self, bucket: str,
                             active: list[dict], now: float,
                             got: list[str]) -> None:
        """AbortIncompleteMultipartUpload (DaysAfterInitiation)."""
        for up in await sys_self.list_multipart_uploads(bucket):
            try:
                m = await sys_self._mp_meta(bucket, up["key"],
                                            up["upload_id"])
            except RGWError:
                continue        # completed/aborted underneath us
            info = json.loads(m["_meta"])
            age = now - float(info.get("initiated", now))
            for r in active:
                limit = self._lc_limit(r, "abort_mpu")
                if limit is None or not up["key"].startswith(
                        r.get("prefix", "")):
                    continue
                if age > limit:
                    await sys_self.abort_multipart(
                        bucket, up["key"], up["upload_id"])
                    got.append(f"{up['key']}+{up['upload_id']}")
                    break

    async def _lc_transition_current(self, sys_self, bucket: str,
                                     active: list[dict], now: float,
                                     got: list[str]) -> None:
        """Current-version transitions (rgw_lc.cc
        LCOpAction_Transition role): the expiration phases already ran
        this pass, so anything still listed is not doomed — move its
        bytes and repoint the head."""
        async for obj in self._lc_walk(sys_self, bucket):
            age = now - float(obj["mtime"])
            for r in active:
                limit = self._lc_limit(r, "transition")
                if limit is None:
                    continue
                if not obj["key"].startswith(r.get("prefix", "")):
                    continue
                want = r.get("tags") or {}
                if want:
                    have = obj.get("tags") or {}
                    if any(have.get(k) != v
                           for k, v in want.items()):
                        continue
                if age <= limit:
                    continue
                target = r["transition_class"]
                if obj.get("storage_class",
                           "STANDARD") == target:
                    continue
                try:
                    moved = await sys_self._transition_object(
                        bucket, obj["key"], None, target)
                except RGWError as err:
                    # SSE-C (no key available) or placement trouble:
                    # skip this object, keep the pass going
                    rgw_log.dout(5, "lc: transition %s/%s "
                                 "refused: %s", bucket, obj["key"],
                                 err)
                    break
                if moved:
                    got.append(f"{obj['key']}->{target}")
                break

    async def _lc_transition_noncurrent(self, sys_self, bucket: str,
                                        active: list[dict],
                                        now: float,
                                        got: list[str]) -> None:
        """NoncurrentVersionTransition: same successor-write-time
        clock as noncurrent expiration — a version's transition age
        starts when it STOPPED being current."""
        versions = await sys_self.list_object_versions(bucket)
        by_key: dict[str, list[dict]] = {}
        for v in versions:
            by_key.setdefault(v["key"], []).append(v)
        for key, vs in by_key.items():
            vs.sort(key=lambda v: (not v["is_latest"],
                                   -float(v["mtime"])))
            for succ, v in zip(vs, vs[1:]):
                if v["is_latest"] or v["delete_marker"]:
                    continue
                since = now - float(succ["mtime"])
                for r in active:
                    limit = self._lc_limit(r,
                                           "noncurrent_transition")
                    if limit is None or not key.startswith(
                            r.get("prefix", "")):
                        continue
                    want = r.get("tags") or {}
                    if want:
                        have = v.get("tags") or {}
                        if any(have.get(k) != t
                               for k, t in want.items()):
                            continue
                    if since <= limit:
                        continue
                    target = r["noncurrent_transition_class"]
                    if v.get("storage_class",
                             "STANDARD") == target:
                        continue
                    try:
                        moved = await sys_self._transition_object(
                            bucket, key, v["version_id"], target)
                    except RGWError as err:
                        rgw_log.dout(5, "lc: transition %s/%s@%s "
                                     "refused: %s", bucket, key,
                                     v["version_id"], err)
                        break
                    if moved:
                        got.append(
                            f"{key}@{v['version_id']}->{target}")
                    break

    async def _transition_object(self, bucket: str, key: str,
                                 version_id: str | None,
                                 target_class: str) -> bool:
        """Move one object/version's stored bytes into
        ``target_class``'s placement pool and atomically repoint its
        head (RGWLC::transition): the S3-visible identity — body
        bytes, etag, version-id, mtime, tags, lock state, SSE and
        compression envelopes — is preserved bit-for-bit; only
        storage_class/pool/data oids change.  The stored (possibly
        deflated/encrypted) bytes are copied VERBATIM through the
        normal write path — into an EC pool that means batched
        stripes through the Objecter→ECBackend encode pipeline — then
        the old tail is reclaimed through the usual GC path.  Returns
        False when there is nothing to move (already in the class,
        delete marker, SLO manifest); raises InvalidRequest for SSE-C
        objects — the lifecycle worker holds no customer key, the
        same conflict a PUT refuses."""
        place = await self._class_placement(target_class)
        pool = place.get("pool") or None
        meta = await self._bucket_meta(bucket)
        if version_id is None:
            kv = await self._index_get(bucket, key, meta)
            if key not in kv:
                raise RGWError("NoSuchKey", f"{bucket}/{key}")
            entry = json.loads(kv[key])
        else:
            vkey = self._vkey(key, version_id)
            try:
                kv = await self.ioctx.get_omap(
                    self._versions_oid(bucket), [vkey])
            except RadosError as e:
                if e.rc != -2:
                    raise
                kv = {}
            if vkey not in kv:
                raise RGWError("NoSuchVersion",
                               f"{key}@{version_id}")
            entry = json.loads(kv[vkey])
        if entry.get("delete_marker") or entry.get("slo"):
            return False
        if entry.get("storage_class", "STANDARD") == target_class:
            return False
        sse = entry.get("sse")
        if sse is not None and "wrapped" not in sse:
            # SSE-C: only the customer holds the key.  Re-placing the
            # ciphertext would work mechanically, but S3 (and our PUT
            # path) treat server-initiated handling of SSE-C objects
            # without the key as a conflict — refuse identically.
            raise RGWError("InvalidRequest",
                           f"{key}: SSE-C objects cannot transition "
                           f"without the customer key")
        old = dict(entry)
        src_ioctx, src_striper = await self._data_handles(
            entry.get("pool"))
        dst_ioctx, dst_striper = await self._data_handles(pool)
        # NEW unique tail oids (\x00t\x00 tag): in-place moves would
        # collide when source and target share a pool, and the GC
        # liveness check compares oids — a reused name would make the
        # old tail look live forever
        tag = secrets.token_hex(8)
        if entry.get("multipart"):
            new_manifest = []
            for p in entry["multipart"]:
                raw = await src_ioctx.read(p["oid"])
                new_oid = f"{p['oid']}\x00t\x00{tag}"
                await dst_ioctx.operate(
                    new_oid, ObjectOperation().write_full(raw))
                new_manifest.append({**p, "oid": new_oid})
            entry["multipart"] = new_manifest
        else:
            old_oid = entry.get("data_oid",
                                self._data_oid(bucket, key))
            new_oid = f"{self._data_oid(bucket, key)}\x00t\x00{tag}"
            if entry.get("striped"):
                raw = await src_striper.read(old_oid)
                await dst_striper.write(new_oid, raw)
            else:
                raw = await src_ioctx.read(old_oid)
                if entry.get("comp") is None and sse is None \
                        and place.get("compression") \
                        in list_compressors():
                    # the class's inline compression composes with
                    # the move: an uncompressed, unencrypted body
                    # deflates exactly as a fresh PUT into the class
                    # would (S3-visible size/etag unchanged)
                    raw, comp = deflate_if_smaller(
                        raw, place["compression"])
                    if comp is not None:
                        entry["comp"] = comp
                await dst_ioctx.operate(
                    new_oid, ObjectOperation().write_full(raw))
            entry["data_oid"] = new_oid
        entry["storage_class"] = target_class
        if pool:
            entry["pool"] = pool
        else:
            entry.pop("pool", None)
        raw_entry = json.dumps(entry).encode()
        # atomic repoint: flip the version record first (history
        # readers), then the bucket index when this record is the
        # current one — each flip is a single omap set, so readers
        # see either the old head or the new, never a mix
        if version_id is not None:
            await self.ioctx.set_omap(
                self._versions_oid(bucket), {vkey: raw_entry})
            cur = await self._index_get(bucket, key, meta)
            if key in cur and json.loads(cur[key]) \
                    .get("version_id") == version_id:
                await self._index_set(bucket, meta, key, raw_entry)
        else:
            if entry.get("version_id"):
                await self.ioctx.set_omap(
                    self._versions_oid(bucket), {
                        self._vkey(key, entry["version_id"]):
                        raw_entry,
                    })
            await self._index_set(bucket, meta, key, raw_entry)
        # reclaim the old tail (deferred through GC when configured)
        await self._remove_entry_data(bucket, key, old)
        return True

    # -- bucket index shards (cls_rgw index + rgw_reshard.cc role) ---------
    @staticmethod
    def _index_shard_oids(bucket: str, meta: dict) -> list[str]:
        """The bucket's index shard objects.  An unsharded gen-0 bucket
        keeps the legacy single-object name; sharded (or resharded)
        buckets spread keys over ``.g<gen>.<shard>`` objects — the
        generation bumps on every reshard so the old and new shard sets
        never collide (reference RGWBucketReshard new-instance ids)."""
        shards = max(1, int(meta.get("index_shards", 1)))
        gen = int(meta.get("index_gen", 0))
        if shards == 1 and gen == 0:
            return [f"rgw.bucket.index.{bucket}"]
        # NUL separators: bucket names may legally contain dots and
        # digits, so a dotted suffix would collide with the legacy oid
        # of a bucket literally named "<bucket>.g<gen>.<n>"
        return [f"rgw.bucket.index\x00{bucket}\x00g{gen}.{s}"
                for s in range(shards)]

    @staticmethod
    def _index_oid_for(bucket: str, meta: dict, key: str) -> str:
        """The shard object holding ``key`` (ceph_str_hash role)."""
        oids = RGWLite._index_shard_oids(bucket, meta)
        if len(oids) == 1:
            return oids[0]
        return oids[zlib.crc32(key.encode()) % len(oids)]

    async def _index_all(self, bucket: str,
                         meta: dict | None = None) -> dict:
        """Merged key -> raw entry across every index shard."""
        if meta is None:
            meta = await self._bucket_meta(bucket)

        async def one(oid: str) -> dict:
            try:
                return await self.ioctx.get_omap(oid)
            except RadosError as e:
                if e.rc != -2:
                    raise
                return {}

        out: dict[str, bytes] = {}
        for kv in await asyncio.gather(
                *(one(o) for o in self._index_shard_oids(bucket,
                                                         meta))):
            out.update(kv)
        return out

    async def _index_get(self, bucket: str, key: str,
                         meta: dict | None = None) -> dict:
        if meta is None:
            meta = await self._bucket_meta(bucket)
        try:
            return await self.ioctx.get_omap(
                self._index_oid_for(bucket, meta, key), [key])
        except RadosError as e:
            if e.rc != -2:
                raise
            return {}

    @staticmethod
    def _index_writable(meta: dict) -> None:
        """Index writes are blocked while a reshard copies entries
        (the reference blocks with a cls guard + retry; clients see a
        retryable 503)."""
        if meta.get("resharding"):
            raise RGWError("ServiceUnavailable",
                           "bucket index is resharding; retry")

    async def _index_set(self, bucket: str, meta: dict, key: str,
                         raw: bytes) -> None:
        self._index_writable(meta)
        await self.ioctx.set_omap(
            self._index_oid_for(bucket, meta, key), {key: raw})

    async def _index_rm(self, bucket: str, meta: dict,
                        key: str) -> None:
        self._index_writable(meta)
        await self.ioctx.rm_omap_keys(
            self._index_oid_for(bucket, meta, key), [key])

    async def reshard_bucket(self, bucket: str,
                             num_shards: int) -> dict:
        """Reshard the bucket index to ``num_shards`` shard objects
        (rgw_reshard.cc RGWBucketReshard::execute): flag the bucket,
        copy entries into a new generation of shard objects, flip the
        meta, drop the old set.  A second copy sweep picks up writers
        that raced the flag; the one-await window left open is the
        -lite stand-in for the reference's cls-guard retry protocol."""
        if not 1 <= num_shards <= 1024:
            raise RGWError("InvalidArgument",
                           f"num_shards {num_shards} not in [1,1024]")
        meta = await self._bucket_meta(bucket)
        if self.user is not None and self.user != meta.get("owner"):
            raise RGWError("AccessDenied", bucket)
        if meta.get("resharding"):
            raise RGWError("OperationAborted",
                           f"reshard of {bucket} already in progress")
        old_oids = self._index_shard_oids(bucket, meta)
        new_meta = {**meta, "index_shards": num_shards,
                    "index_gen": int(meta.get("index_gen", 0)) + 1}
        meta["resharding"] = True
        meta["reshard_target"] = num_shards
        await self._put_bucket_meta(bucket, meta)
        for oid in self._index_shard_oids(bucket, new_meta):
            await self.ioctx.operate(oid, ObjectOperation().create())
        moved: set[str] = set()
        placed: dict[str, str] = {}     # key -> new shard oid
        for sweep in range(2):
            merged: dict[str, bytes] = {}
            for old in old_oids:
                try:
                    merged.update(await self.ioctx.get_omap(old))
                except RadosError as e:
                    if e.rc != -2:
                        raise
            batches: dict[str, dict] = {}
            for k, v in merged.items():
                oid = self._index_oid_for(bucket, new_meta, k)
                batches.setdefault(oid, {})[k] = v
                placed[k] = oid
                moved.add(k)
            for oid, kvs in batches.items():
                await self.ioctx.set_omap(oid, kvs)
            if sweep == 1:
                # a DELETE that raced the flag dropped its key from an
                # old shard after sweep 0 copied it: the copy must
                # propagate removals too, or the flip resurrects an
                # index entry whose data is gone
                for k in set(placed) - set(merged):
                    await self.ioctx.rm_omap_keys(placed[k], [k])
                    moved.discard(k)
        final = dict(new_meta)
        final.pop("resharding", None)
        final.pop("reshard_target", None)
        await self._put_bucket_meta(bucket, final)
        for old in old_oids:
            try:
                await self.ioctx.remove(old)
            except RadosError as e:
                if e.rc != -2:
                    raise
        return {"bucket": bucket, "num_shards": num_shards,
                "objects": len(moved)}

    async def reshard_abort(self, bucket: str) -> None:
        """Clear a reshard wedged by a crash mid-copy: drop the
        half-written next-generation shard objects and unblock
        writes (radosgw-admin reshard cancel)."""
        meta = await self._bucket_meta(bucket)
        if not meta.get("resharding"):
            return
        target = int(meta.get("reshard_target", 1))
        next_meta = {**meta, "index_shards": target,
                     "index_gen": int(meta.get("index_gen", 0)) + 1}
        for oid in self._index_shard_oids(bucket, next_meta):
            try:
                await self.ioctx.remove(oid)
            except RadosError as e:
                if e.rc != -2:
                    raise
        meta.pop("resharding", None)
        meta.pop("reshard_target", None)
        await self._put_bucket_meta(bucket, meta)

    async def _maybe_auto_reshard(self, bucket: str, meta: dict,
                                  key: str) -> None:
        """Dynamic resharding (rgw_reshard.cc RGWReshard daemon role):
        after a put, when the target shard outgrows the per-shard
        object cap, double the shard count.  Checks only the one shard
        the put touched, so the cost is one omap read per put."""
        if self.auto_reshard_objs <= 0:
            return
        try:
            n = len(await self.ioctx.get_omap(
                self._index_oid_for(bucket, meta, key)))
        except RadosError as e:
            if e.rc != -2:
                raise
            return
        if n <= self.auto_reshard_objs:
            return
        shards = max(1, int(meta.get("index_shards", 1)))
        if shards * 2 > 1024:
            return                # at the cap: the put already landed
        try:
            await self.as_user(None).reshard_bucket(bucket, shards * 2)
        except RGWError as e:
            if e.code not in ("OperationAborted",
                              "ServiceUnavailable"):
                raise             # concurrent reshard already running

    # -- garbage collection (rgw_gc.cc deferred tail deletion) -------------
    GC_OID = "rgw.gc"

    async def _gc_enqueue(self, items: list, bucket: str,
                          key: str) -> None:
        """Queue data objects for deferred deletion; keys sort by
        expiry so gc_process stops at the first unexpired entry.
        ``bucket``/``key`` ride along for the reap-time liveness
        check: plain puts reuse the deterministic per-key oid, so a
        key re-created inside the grace window holds LIVE data at an
        oid a stale GC entry names (the reference avoids this with
        per-write tail tags; -lite checks liveness when reaping)."""
        expire = time.time() + self.gc_min_wait
        await self.ioctx.operate(
            self.GC_OID, ObjectOperation().create().omap_set({
                f"{expire:020.6f}.{secrets.token_hex(6)}":
                    json.dumps({"bucket": bucket, "key": key,
                                "items": items}).encode(),
            }))

    async def _live_oids(self, bucket: str, key: str) -> set[str]:
        """Every data oid the bucket CURRENTLY references for ``key``
        (index entry + all version records): a GC entry must never
        delete these — they belong to a re-created or overwritten
        object, not the dead one that was enqueued."""
        def oids_of(rec: dict) -> list[str]:
            if rec.get("delete_marker"):
                return []
            if rec.get("multipart"):
                return [p["oid"] for p in rec["multipart"]]
            return [rec.get("data_oid", self._data_oid(bucket, key))]

        live: set[str] = set()
        try:
            kv = await self._index_get(bucket, key)
        except RGWError:
            return live                   # bucket itself is gone
        if key in kv:
            live.update(oids_of(json.loads(kv[key])))
        try:
            vomap = await self.ioctx.get_omap(
                self._versions_oid(bucket))
        except RadosError as e:
            if e.rc != -2:
                raise
            vomap = {}
        prefix = key + "\x00"
        for vk, raw in vomap.items():
            if vk.startswith(prefix):
                live.update(oids_of(json.loads(raw)))
        return live

    async def _gc_delete(self, items: list) -> None:
        for it in items:
            kind, oid = it[0], it[1]
            try:
                ioctx, striper = await self._data_handles(
                    it[2] if len(it) > 2 else None)
                if kind == "striped":
                    await striper.remove(oid)
                else:
                    await ioctx.remove(oid)
            except (RadosError, RGWError) as e:
                # -2 / a deleted placement pool: the tail is already
                # gone either way
                if isinstance(e, RadosError) and e.rc != -2:
                    raise

    async def gc_list(self) -> list[dict]:
        try:
            omap = await self.ioctx.get_omap(self.GC_OID)
        except RadosError as e:
            if e.rc != -2:
                raise
            return []
        out = []
        for k, v in sorted(omap.items()):
            parts = k.rsplit(".", 2)
            ent = json.loads(v)
            out.append({"tag": k,
                        "expire": float(parts[0] + "." + parts[1]),
                        **ent})
        return out

    @_reclaims_space
    async def gc_process(self, now: float | None = None) -> int:
        """Reap expired GC entries (RGWGC::process); returns the
        number of queue entries deleted."""
        now = time.time() if now is None else now
        reaped = 0
        for ent in await self.gc_list():
            if ent["expire"] > now:
                break                     # sorted by expiry
            live = await self._live_oids(ent["bucket"], ent["key"])
            await self._gc_delete([it for it in ent["items"]
                                   if it[1] not in live])
            await self.ioctx.rm_omap_keys(self.GC_OID, [ent["tag"]])
            reaped += 1
        return reaped

    # -- buckets -----------------------------------------------------------
    @staticmethod
    def _index_oid(bucket: str) -> str:
        """Legacy unsharded index oid (gen-0 single shard only)."""
        return f"rgw.bucket.index.{bucket}"

    @staticmethod
    def _log_oid(bucket: str, shard: int = 0) -> str:
        """Datalog shard object.  Shard 0 keeps the legacy unsuffixed
        name so single-shard deployments (and their persisted sync
        markers) survive the sharding change unmodified; higher shards
        use a NUL separator for the same dotted-bucket-name reason as
        the index shards."""
        if shard == 0:
            return f"rgw.bucket.log.{bucket}"
        return f"rgw.bucket.log\x00{bucket}\x00{shard}"

    def _log_shard_of(self, key: str) -> int:
        """The datalog shard holding ``key``'s mutations (same
        crc32 placement as the index shards, so the mapping is a pure
        function both zones compute identically)."""
        if self.datalog_shards <= 1:
            return 0
        return zlib.crc32(key.encode()) % self.datalog_shards

    async def _log(self, bucket: str, op: str, key: str,
                   etag: str = "", event: str | None = None,
                   size: int = 0) -> None:
        """``event``: explicit S3 event name when the op name alone is
        ambiguous (a versioned DELETE logs 'del' but the S3 event is
        DeleteMarkerCreated).  ``size``: payload bytes for puts, so the
        sync agent's lag ledger can price unreplicated entries in bytes
        as well as entries."""
        if self.datalog:
            await self.ioctx.exec(
                self._log_oid(bucket, self._log_shard_of(key)),
                "rgw", "log_add",
                json.dumps({"op": op, "key": key, "etag": etag,
                            "mtime": time.time(),
                            "size": int(size)}).encode(),
            )
        await self._notify(bucket, op, key, etag, event)

    # -- bucket notifications / pubsub (rgw_pubsub.cc role) ---------------
    # Notification configs live in the bucket meta; events land in
    # per-topic queue objects (same seq-allocating rgw cls as the
    # datalog) and are consumed PULL-style (topic_pull/topic_trim — the
    # reference pubsub sync module's pull mode).
    _EVENT_OF_OP = {
        "put": "s3:ObjectCreated:Put",
        "put-tagging": "s3:ObjectTagging:Put",
        "del": "s3:ObjectRemoved:Delete",
        # permanent removal of a specific version IS a Delete; marker
        # creation passes an explicit event at the call site
        "del-version": "s3:ObjectRemoved:Delete",
    }

    @staticmethod
    def _topic_oid(topic: str) -> str:
        return f"rgw.pubsub.topic.{topic}"

    async def put_bucket_notification(
            self, bucket: str, topic: str,
            events: list[str] | None = None) -> None:
        meta = await self._check_bucket(bucket, "WRITE")
        cfgs = [c for c in meta.get("notifications", ())
                if c["topic"] != topic]
        cfgs.append({"topic": str(topic),
                     "events": list(events or ["s3:ObjectCreated:*",
                                               "s3:ObjectRemoved:*"])})
        meta["notifications"] = cfgs
        await self._put_bucket_meta(bucket, meta)
        self._notif_cache.pop(bucket, None)

    async def set_bucket_notifications(self, bucket: str,
                                       configs: list[dict]) -> None:
        """REPLACE the whole notification document (S3
        PutBucketNotificationConfiguration semantics — an empty list is
        how clients disable notifications; there is no DELETE API)."""
        meta = await self._check_bucket(bucket, "WRITE")
        meta["notifications"] = [
            {"topic": str(c["topic"]),
             "events": list(c.get("events")
                            or ["s3:ObjectCreated:*",
                                "s3:ObjectRemoved:*"])}
            for c in configs
        ]
        await self._put_bucket_meta(bucket, meta)
        self._notif_cache.pop(bucket, None)

    async def get_bucket_notification(self, bucket: str) -> list[dict]:
        meta = await self._check_bucket(bucket, "READ")
        return list(meta.get("notifications", ()))

    async def delete_bucket_notification(
            self, bucket: str, topic: str | None = None) -> None:
        meta = await self._check_bucket(bucket, "WRITE")
        meta["notifications"] = [
            c for c in meta.get("notifications", ())
            if topic is not None and c["topic"] != topic
        ]
        await self._put_bucket_meta(bucket, meta)
        self._notif_cache.pop(bucket, None)

    @staticmethod
    def _event_match(pattern: str, event: str) -> bool:
        return (pattern == event
                or (pattern.endswith("*")
                    and event.startswith(pattern[:-1])))

    async def _notify(self, bucket: str, op: str, key: str,
                      etag: str, event: str | None = None) -> None:
        event = event or self._EVENT_OF_OP.get(op)
        if event is None:
            return
        now = time.time()
        cached = self._notif_cache.get(bucket)
        if cached is None or now - cached[0] > 5.0:
            try:
                meta = await self._bucket_meta(bucket)
            except RGWError:
                return
            if len(self._notif_cache) > 4096:
                self._notif_cache.clear()
            cached = (now, list(meta.get("notifications", ())))
            self._notif_cache[bucket] = cached
        for cfg in cached[1]:
            if any(self._event_match(p, event)
                   for p in cfg.get("events", ())):
                await self.ioctx.exec(
                    self._topic_oid(cfg["topic"]), "rgw", "log_add",
                    json.dumps({
                        "op": "notify", "key": key, "etag": etag,
                        "mtime": now, "eventName": event,
                        "bucket": bucket, "eventTime": now,
                    }).encode(),
                )
                # push mode: wake (or revive after a restart) the
                # topic's delivery worker
                tmeta = await self._topic_meta(cfg["topic"])
                if tmeta is not None and tmeta.get("push_endpoint"):
                    self._ensure_pusher(cfg["topic"], tmeta)

    # -- persistent topics + push-mode delivery ---------------------------
    # rgw_pubsub_push.h:20 (RGWPubSubEndpoint) + rgw_notify.cc
    # persistent-topic semantics: events land in the per-topic queue
    # (the at-least-once source of truth) regardless of mode; a topic
    # with a push_endpoint gets a worker that delivers in order,
    # advances a DURABLE cursor xattr only after an ack (or after
    # parking an exhausted event in <topic>.deadletter), and backs off
    # exponentially between attempts.  A restart resumes from the
    # cursor: delivery is at-least-once, never lossy.
    TOPICS_OID = "rgw.pubsub.topics"

    async def create_topic(self, name: str,
                           push_endpoint: str | None = None,
                           ack_level: str = "broker",
                           max_retries: int = 5,
                           retry_sleep: float = 0.05,
                           opaque: str = "") -> dict:
        """Create/replace a topic (radosgw-admin topic create +
        attributes: push-endpoint URL, ack level, OpaqueData)."""
        if push_endpoint:
            from ceph_tpu_torch.services.rgw_push import PushEndpoint

            PushEndpoint.make(push_endpoint, ack_level)  # validate now
        meta = {"name": str(name), "push_endpoint": push_endpoint,
                "ack_level": ack_level,
                "max_retries": int(max_retries),
                "retry_sleep": float(retry_sleep),
                "opaque": str(opaque), "created": time.time()}
        await self.ioctx.operate(
            self.TOPICS_OID, ObjectOperation().create()
            .omap_set({str(name): json.dumps(meta).encode()}))
        self._topics_cache.pop(str(name), None)
        # replace semantics: a live worker was built from the OLD meta
        # (endpoint/ack/retries) — stop it; the new one starts now or,
        # for a pull-only topic, never
        self._stop_pusher(str(name))
        if push_endpoint:
            self._ensure_pusher(str(name), meta)
        return meta

    async def get_topic(self, name: str) -> dict:
        t = await self._topic_meta(name)
        if t is None:
            raise RGWError("NoSuchTopic", name)
        return t

    async def list_topics(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap(self.TOPICS_OID))
        except RadosError as e:
            if e.rc != -2:
                raise
            return []

    async def delete_topic(self, name: str) -> None:
        self._stop_pusher(name)
        try:
            await self.ioctx.operate(
                self.TOPICS_OID, ObjectOperation().omap_rm([str(name)]))
        except RadosError as e:
            if e.rc != -2:
                raise
        self._topics_cache.pop(str(name), None)
        for oid in (self._topic_oid(name),
                    self._topic_oid(name) + ".deadletter"):
            try:
                await self.ioctx.remove(oid)
            except RadosError as e:
                if e.rc != -2:
                    raise

    async def _topic_meta(self, name: str) -> dict | None:
        now = time.time()
        cached = self._topics_cache.get(name)
        if cached is not None and now - cached[0] <= 5.0:
            return cached[1]
        try:
            kv = await self.ioctx.get_omap(self.TOPICS_OID, [str(name)])
            meta = json.loads(kv[str(name)]) if str(name) in kv else None
        except RadosError as e:
            if e.rc != -2:
                raise
            meta = None
        if len(self._topics_cache) > 4096:
            self._topics_cache.clear()
        self._topics_cache[name] = (now, meta)
        return meta

    def _ensure_pusher(self, topic: str, meta: dict) -> None:
        cur = self._pushers.get(topic)
        if cur is not None and not cur[0].done():
            cur[1].set()
            return
        ev = asyncio.Event()
        ev.set()
        task = asyncio.get_running_loop().create_task(
            self._push_loop(topic, meta, ev))
        self._pushers[topic] = (task, ev)

    def _stop_pusher(self, topic: str) -> None:
        cur = self._pushers.pop(topic, None)
        if cur is not None:
            cur[0].cancel()

    async def start_push(self) -> None:
        """Spawn delivery workers for every push topic (the restart
        hook: events queued before a process restart must not wait for
        new traffic on their topic — rgw_notify.cc starts its
        persistent-queue workers at init the same way)."""
        try:
            kv = await self.ioctx.get_omap(self.TOPICS_OID)
        except RadosError as e:
            if e.rc != -2:
                raise
            return
        for name, raw in kv.items():
            try:
                meta = json.loads(raw)
            except ValueError:
                continue
            if meta.get("push_endpoint"):
                self._ensure_pusher(name, meta)

    async def stop_push(self) -> None:
        """Cancel + drain every push worker (test/shutdown hook)."""
        tasks = [t for t, _ in self._pushers.values()]
        self._pushers.clear()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    @staticmethod
    def _event_payload(topic: str, opaque: str, e: dict) -> bytes:
        """S3 notification record shape (what the reference's HTTP
        endpoint POSTs, rgw_pubsub.cc json_format_versioned_event)."""
        return json.dumps({"Records": [{
            "eventVersion": "2.2",
            "eventSource": "ceph:s3",
            "eventName": e.get("eventName", ""),
            "eventTime": e.get("eventTime", 0),
            "s3": {"bucket": {"name": e.get("bucket", "")},
                   "object": {"key": e.get("key", ""),
                              "eTag": e.get("etag", "")}},
            "opaqueData": opaque,
            "topic": topic,
        }]}).encode()

    async def _push_loop(self, topic: str, meta: dict,
                         ev: asyncio.Event) -> None:
        from ceph_tpu_torch.services.rgw_push import DeliveryError, \
            PushEndpoint

        ep = PushEndpoint.make(meta["push_endpoint"],
                               meta.get("ack_level", "broker"))
        oid = self._topic_oid(topic)
        # cursor load rides the same backoff-retry as the batch loop:
        # a transient RadosError (failover while the worker spawns)
        # must neither kill the delivery worker nor reset the cursor
        # and mass-redeliver the whole queue
        while True:
            try:
                cursor = int(await self.ioctx.get_xattr(
                    oid, "push_cursor"))
                break
            except RadosError as e:
                if e.rc == -2:
                    cursor = 0     # topic never delivered before
                    break
                rgw_log.derr("push %s: cursor load error %s; backing "
                             "off", topic, e)
                await asyncio.sleep(1.0)
            except ValueError:
                cursor = 0
                break
        retries = int(meta.get("max_retries", 5))
        sleep0 = float(meta.get("retry_sleep", 0.05))
        down_sleep = sleep0                  # unreachable-endpoint backoff
        while True:
            try:
                # cross-handle reconfiguration: another gateway sharing
                # the pool may have replaced (or deleted) this topic —
                # re-read the (5s-cached) meta and respawn with fresh
                # attributes rather than pushing to a dead endpoint
                # forever
                fresh = await self._topic_meta(topic)
                if fresh is None:
                    return                    # topic deleted
                if fresh != meta:
                    if self._pushers.get(topic, (None,))[0] is \
                            asyncio.current_task():
                        self._pushers.pop(topic, None)
                    if fresh.get("push_endpoint"):
                        self._ensure_pusher(topic, fresh)
                    return
                batch = await self.topic_pull(topic, after=cursor)
                events = batch["events"]
                for e in events:
                    payload = self._event_payload(
                        topic, meta.get("opaque", ""), e)
                    delivered = False
                    rejected = False
                    for attempt in range(retries + 1):
                        try:
                            await ep.send(payload)
                            delivered = True
                            break
                        except DeliveryError as de:
                            rejected = de.connected
                            if not de.connected:
                                break   # dead endpoint: the outer
                                        # down_sleep paces reconnects
                            if attempt < retries:  # no backoff after
                                await asyncio.sleep(  # the last try
                                    min(sleep0 * (2 ** attempt), 2.0))
                    if not delivered and not rejected:
                        # UNREACHABLE endpoint (restart backlog before
                        # the consumer is up, network partition): the
                        # reference's persistent queues keep retrying
                        # within retention rather than discarding —
                        # hold position, back off, re-attempt later
                        rgw_log.dout(
                            5, "push %s: endpoint unreachable at seq "
                            "%s; retrying in %.1fs", topic, e["seq"],
                            down_sleep)
                        await asyncio.sleep(down_sleep)
                        down_sleep = min(down_sleep * 2, 5.0)
                        break
                    down_sleep = sleep0
                    if not delivered:
                        # the endpoint ANSWERED and rejected through
                        # every retry: dead-letter and move on so one
                        # rejecting consumer cannot wedge the topic.
                        # The DL log allocates its own seq — the
                        # original topic seq must not ride along or
                        # it would clobber deadletter_pull's cursor
                        rgw_log.derr(
                            "push %s: endpoint rejected event seq %s "
                            "%d times; dead-lettering", topic,
                            e["seq"], retries + 1)
                        parked = {k: v for k, v in e.items()
                                  if k != "seq"}
                        await self.ioctx.exec(
                            oid + ".deadletter", "rgw", "log_add",
                            json.dumps(parked).encode())
                    cursor = int(e["seq"])
                    # durable ack: a restarted worker resumes past
                    # this event (at-least-once — a crash between
                    # send and this write redelivers)
                    await self.ioctx.set_xattr(
                        oid, "push_cursor", str(cursor).encode())
            except RadosError as e:
                if e.rc != -2:
                    # transient cluster trouble (failover, timeout):
                    # the worker must survive it, not die with a
                    # backlog — back off, log, retry
                    rgw_log.derr("push %s: rados error %s; backing "
                                 "off", topic, e)
                    await asyncio.sleep(1.0)
                events = []            # rc=-2: queue not created yet
            if not events:
                ev.clear()
                try:
                    await asyncio.wait_for(ev.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass

    async def deadletter_pull(self, topic: str, after: int = 0,
                              max_events: int = 1000) -> dict:
        """Inspect events whose delivery exhausted max_retries."""
        try:
            out = json.loads(await self.ioctx.exec(
                self._topic_oid(topic) + ".deadletter", "rgw",
                "log_list",
                json.dumps({"after": after,
                            "max": max_events}).encode()))
        except RadosError as e:
            if e.rc != -2:
                raise
            return {"events": [], "last": after}
        entries = out.get("entries", [])
        return {"events": entries,
                "last": entries[-1]["seq"] if entries else after}

    async def topic_pull(self, topic: str, after: int = 0,
                         max_events: int = 1000) -> dict:
        """Consume queued events (pull mode): {'events': [...],
        'last': seq} — pass ``last`` back as ``after`` to resume."""
        out = json.loads(await self.ioctx.exec(
            self._topic_oid(topic), "rgw", "log_list",
            json.dumps({"after": after, "max": max_events}).encode(),
        ))
        entries = out.get("entries", [])
        last = entries[-1]["seq"] if entries else after
        return {"events": entries, "last": last}

    async def topic_trim(self, topic: str, upto: int) -> None:
        await self.ioctx.exec(
            self._topic_oid(topic), "rgw", "log_trim",
            json.dumps({"upto": upto}).encode(),
        )

    async def log_list(self, bucket: str, after: int = 0,
                       max_entries: int = 1000,
                       shard: int = 0) -> dict:
        out = await self.ioctx.exec(
            self._log_oid(bucket, shard), "rgw", "log_list",
            json.dumps({"after": after, "max": max_entries}).encode(),
        )
        return json.loads(out)

    async def log_trim(self, bucket: str, upto: int,
                       shard: int = 0) -> None:
        await self.ioctx.exec(
            self._log_oid(bucket, shard), "rgw", "log_trim",
            json.dumps({"upto": upto}).encode(),
        )

    async def create_bucket(self, bucket: str,
                            object_lock: bool = False) -> None:
        """``object_lock``: WORM bucket (rgw_object_lock role) —
        versioning is enabled atomically with it, as S3 requires;
        the flag cannot be added to an existing bucket."""
        if self.user == ANONYMOUS:
            raise RGWError("AccessDenied", "anonymous cannot create")
        if not bucket or any(ord(c) < 0x20 for c in bucket):
            raise RGWError("InvalidBucketName", repr(bucket))
        existing = await self.list_buckets()
        if bucket in existing:
            raise RGWError("BucketAlreadyExists", bucket)
        meta = {
            "created": time.time(),
            "owner": self.user or "",
            "acl": {"canned": "private"},
        }
        if object_lock:
            meta["object_lock"] = {"enabled": True}
            meta["versioning"] = "enabled"
        await self.ioctx.operate(BUCKETS_OID, ObjectOperation()
                                 .create()
                                 .omap_set({bucket: json.dumps(
                                     meta).encode()}))
        await self.ioctx.operate(self._index_oid(bucket),
                                 ObjectOperation().create())
        # a recreated name must not inherit the old bucket's configs
        self._notif_cache.pop(bucket, None)

    @_reclaims_space
    async def delete_bucket(self, bucket: str) -> None:
        meta = await self._bucket_meta(bucket)
        if self.user is not None and self.user != meta.get("owner"):
            raise RGWError("AccessDenied", bucket)
        index = await self._index_all(bucket, meta)
        if index:
            raise RGWError("BucketNotEmpty", bucket)
        try:
            if await self.ioctx.get_omap(self._versions_oid(bucket)):
                # ghost history must not leak into a recreated bucket
                raise RGWError("BucketNotEmpty",
                               f"{bucket} still has object versions")
            await self.ioctx.remove(self._versions_oid(bucket))
        except RadosError as e:
            if e.rc != -2:
                raise
        self._notif_cache.pop(bucket, None)
        for oid in self._index_shard_oids(bucket, meta):
            try:
                await self.ioctx.remove(oid)
            except RadosError as e:
                if e.rc != -2:
                    raise
        for shard in range(self.datalog_shards):
            try:
                await self.ioctx.remove(self._log_oid(bucket, shard))
            except RadosError as e:
                if e.rc != -2:
                    raise
        await self.ioctx.rm_omap_keys(BUCKETS_OID, [bucket])

    async def head_bucket(self, bucket: str) -> dict:
        """S3 HeadBucket: existence + access probe without pulling the
        whole bucket table or index (the rgw_file facade's per-call
        liveness check)."""
        return await self._check_bucket(bucket, "READ")

    async def list_buckets(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap(BUCKETS_OID))
        except RadosError as e:
            if e.rc == -2:
                return []
            raise

    # -- objects -----------------------------------------------------------
    @staticmethod
    def _data_oid(bucket: str, key: str) -> str:
        return f"rgw.obj.{bucket}/{key}"

    async def _prepare_put(self, bucket: str, key: str, length: int,
                           if_none_match: bool,
                           defer_cleanup: bool = False,
                           lock: dict | None = None,
                           storage_class: str | None = None) -> dict:
        """Everything a PUT decides BEFORE any body byte lands: ACL,
        preconditions, quota (against the declared length), versioning
        mode, target oid, and old-data cleanup.  Shared by the buffered
        and streaming paths.

        ``defer_cleanup`` (streaming): the replaced object's data must
        survive until complete() — an aborted stream (disconnect, hash
        mismatch) would otherwise have destroyed a durable object whose
        index entry still stands.  The stream writes to a UNIQUE oid
        and cleanup happens after the index flips to it."""
        meta = await self._check_bucket(bucket, "WRITE",
                                        action="s3:PutObject", key=key)
        self._index_writable(meta)
        index_oid = self._index_oid_for(bucket, meta, key)
        existing = await self._index_get(bucket, key, meta)
        if if_none_match and existing and \
                not json.loads(existing[key]).get("delete_marker"):
            raise RGWError("PreconditionFailed", key)
        versioned = meta.get("versioning") == "enabled"
        suspended = meta.get("versioning") == "suspended"
        if versioned:
            replaced, is_replace = 0, False
        elif suspended:
            replaced, is_replace = await self._suspended_replaced(
                bucket, key, existing.get(key))
        else:
            replaced = (json.loads(existing[key])["size"]
                        if key in existing else 0)
            is_replace = key in existing
        await self._check_quota(bucket, meta, length,
                                replaced_size=replaced,
                                is_replace=is_replace)
        oid = self._data_oid(bucket, key)
        version_id = None
        deferred: list[tuple] = []
        if versioned and defer_cleanup:
            version_id = self._new_version_id()
            oid = f"{oid}\x00v\x00{version_id}"
            if key in existing:
                # adopting the pre-versioning entry as 'null' must wait
                # for complete(): an aborted stream must leave the
                # version store untouched
                deferred.append(("adopt", json.loads(existing[key])))
        elif versioned:
            # every PUT is a NEW version: prior data objects survive
            # under their own version ids (rgw versioned-bucket model)
            version_id = self._new_version_id()
            oid = f"{oid}\x00v\x00{version_id}"
            if key in existing:
                await self._adopt_null_version(
                    bucket, key, json.loads(existing[key])
                )
        elif defer_cleanup:
            # unique data oid: an aborted stream removes only its own
            # bytes; the old object stays intact and indexed
            oid = f"{oid}\x00s\x00{secrets.token_hex(8)}"
            if key in existing:
                old = json.loads(existing[key])
                if suspended:
                    deferred.append(("null", None))
                if not old.get("version_id"):
                    deferred.append(("entry", old))
        elif key in existing:
            # drop the old data objects first: a smaller striped body
            # must not inherit the old size xattr / stale tail stripes
            old = json.loads(existing[key])
            if suspended:
                # a suspended-state PUT REPLACES the 'null' version;
                # every other version's data stays retrievable
                await self._remove_null_version(bucket, key)
            # data owned by a (non-null) version record stays
            # retrievable through the version API — never clean it
            if not old.get("version_id"):
                await self._remove_entry_data(bucket, key, old)
        if self.gc_min_wait > 0 and "\x00" not in oid:
            # deferred GC must NEVER share an oid with a later write:
            # an in-place striped overwrite would inherit the old size
            # xattr + tail stripes, and representation changes would
            # leak.  Unique per-write tail oids (the reference's tail
            # tag) make deferral safe for every shape.
            oid = f"{oid}\x00g\x00{secrets.token_hex(8)}"
        ctx = {"bucket": bucket, "key": key, "oid": oid,
               "index_oid": index_oid, "versioned": versioned,
               "suspended": suspended, "version_id": version_id,
               "deferred_cleanup": deferred, "meta": meta,
               "compression": meta.get("compression"),
               "storage_class": None, "pool": None}
        sclass = (storage_class or "").strip()
        if sclass and sclass != "STANDARD":
            # x-amz-storage-class routes the tail through the zone's
            # placement target for that class; the class's inline
            # compression overrides the bucket's
            place = await self._class_placement(sclass)
            ctx["storage_class"] = sclass
            ctx["pool"] = place.get("pool") or None
            if place.get("compression"):
                ctx["compression"] = place["compression"]
        # EVERY put shape flows through here — buffered, streaming,
        # multipart complete, SLO — so WORM state cannot be dodged
        # by picking a body size (the streaming-path hole)
        self._stage_lock(ctx, lock)
        return ctx

    async def put_slo_manifest(self, bucket: str, key: str,
                               segments: list[dict],
                               content_type: str =
                               "application/octet-stream",
                               metadata: dict | None = None) -> dict:
        """Swift Static Large Object manifest (rgw SLO support in
        rgw_rest_swift): ``segments`` are {"bucket", "key"} (+optional
        "etag"/"size_bytes" to validate); the stored entry reuses the
        multipart manifest read path, so plain GETs concatenate and
        range/stream like any multipart object.  Segments must be
        plain-stored (not striped/compressed/SSE-C/multipart) and stay
        independent objects — deleting the manifest leaves them."""
        if not segments:
            raise RGWError("InvalidArgument", "empty SLO manifest")
        manifest = []
        descr = []
        etags = hashlib.md5()
        total = 0
        for seg in segments:
            sb, sk = str(seg["bucket"]), str(seg["key"])
            entry = await self._entry(sb, sk)
            if entry.get("striped") or entry.get("multipart") \
                    or entry.get("sse") or entry.get("comp"):
                raise RGWError(
                    "InvalidArgument",
                    f"SLO segment {sb}/{sk} must be a plain object")
            if "etag" in seg and seg["etag"] and \
                    seg["etag"] != entry["etag"]:
                raise RGWError("InvalidArgument",
                               f"segment {sb}/{sk} etag mismatch")
            if "size_bytes" in seg and seg["size_bytes"] and \
                    int(seg["size_bytes"]) != int(entry["size"]):
                raise RGWError("InvalidArgument",
                               f"segment {sb}/{sk} size mismatch")
            oid = entry.get("data_oid", self._data_oid(sb, sk))
            manifest.append({"oid": oid, "size": int(entry["size"])})
            descr.append({"name": f"/{sb}/{sk}",
                          "etag": entry["etag"],
                          "bytes": int(entry["size"])})
            etags.update(entry["etag"].encode())
            total += int(entry["size"])
        # quota: the manifest stores no NEW bytes (segments already
        # paid); charge zero or every SLO byte would count twice
        ctx = await self._prepare_put(bucket, key, 0, False)
        meta = dict(metadata or {})
        meta["slo_segments"] = descr        # faithful manifest echo
        return await self._finish_put(
            ctx, total, f"{etags.hexdigest()}-{len(manifest)}",
            False, content_type, meta, None, multipart=manifest,
            slo=True)

    async def begin_put(self, bucket: str, key: str, length: int,
                        content_type: str = "binary/octet-stream",
                        metadata: dict[str, str] | None = None,
                        if_none_match: bool = False,
                        lock: dict | None = None,
                        storage_class: str | None = None
                        ) -> "StreamingPut":
        """Chunked S3 PUT session (the beast frontend's streaming body
        path): validation happens up front against the declared length,
        then body chunks land at their striper offsets without ever
        buffering the whole object."""
        ctx = await self._prepare_put(bucket, key, length,
                                      if_none_match,
                                      defer_cleanup=True, lock=lock,
                                      storage_class=storage_class)
        return StreamingPut(self, ctx, length, content_type,
                            dict(metadata or {}))

    async def put_object(self, bucket: str, key: str, data: bytes,
                         content_type: str = "binary/octet-stream",
                         metadata: dict[str, str] | None = None,
                         if_none_match: bool = False,
                         sse_key: bytes | None = None,
                         tags: dict[str, str] | None = None,
                         lock: dict | None = None,
                         sse: str | None = None,
                         kms_key_id: str | None = None,
                         storage_class: str | None = None) -> dict:
        """S3 PUT. ``if_none_match``: fail when the key exists ('*').
        ``sse_key``: SSE-C customer key (32 bytes, AES-256).
        ``sse``: server-managed encryption — "aws:kms" (SSE-KMS, key
        named by ``kms_key_id``) or "AES256" (SSE-S3, zone key); the
        x-amz-server-side-encryption header.
        ``tags``: object tags (the x-amz-tagging header).
        ``lock``: explicit object-lock state for the new version:
        {mode, until, legal_hold} (x-amz-object-lock-* headers).
        ``storage_class``: x-amz-storage-class — the tail lands in the
        class's placement pool (STANDARD/None = the zone pool)."""
        with self._trace_root("rgw:put", bucket=bucket, key=key,
                              size=len(data)):
            return await self._put_object_impl(
                bucket, key, data, content_type, metadata,
                if_none_match, sse_key, tags, lock, sse, kms_key_id,
                storage_class)

    async def _put_object_impl(self, bucket, key, data, content_type,
                               metadata, if_none_match, sse_key, tags,
                               lock, sse, kms_key_id,
                               storage_class) -> dict:
        if tags:
            self.validate_tags(tags)
        if sse is not None and sse_key is not None:
            raise RGWError("InvalidArgument",
                           "SSE-C and server-side encryption are "
                           "mutually exclusive")
        ctx = await self._prepare_put(bucket, key, len(data),
                                      if_none_match, lock=lock,
                                      storage_class=storage_class)
        etag = hashlib.md5(data).hexdigest()
        size = len(data)
        comp = None
        if ctx.get("compression") in list_compressors() \
                and sse_key is None and sse is None:
            # compress-at-rest (rgw_compression.cc): S3-visible
            # size/etag stay the original
            data, comp = deflate_if_smaller(data, ctx["compression"])
        if sse is not None:
            dk, kms_sse = await self._kms_begin(sse, kms_key_id)
            data = sse_crypt(dk, bytes.fromhex(kms_sse["nonce"]),
                             0, data)
            sse = kms_sse
        elif sse_key is not None:
            sse = sse_begin(sse_key)
            data = sse_crypt(sse_key, bytes.fromhex(sse["nonce"]),
                             0, data)
        oid = ctx["oid"]
        ioctx, striper = await self._data_handles(ctx.get("pool"))
        striped = len(data) > STRIPE_THRESHOLD
        if striped:
            await striper.write(oid, data)
        else:
            op = ObjectOperation().write_full(data)
            await ioctx.operate(oid, op)
        return await self._finish_put(ctx, size, etag, striped,
                                      content_type,
                                      dict(metadata or {}), sse,
                                      comp=comp, tags=tags)

    async def _finish_put(self, ctx: dict, size: int, etag: str,
                          striped: bool, content_type: str,
                          metadata: dict, sse: dict | None,
                          comp: dict | None = None,
                          multipart: list | None = None,
                          slo: bool = False,
                          tags: dict | None = None) -> dict:
        """Publish the index entry once the data is down (shared by
        buffered and streaming PUTs)."""
        bucket, key = ctx["bucket"], ctx["key"]
        versioned = ctx["versioned"]
        version_id = ctx["version_id"]
        entry = {
            "size": size, "etag": etag, "mtime": time.time(),
            "content_type": content_type, "striped": striped,
            "meta": metadata,
            "data_oid": ctx["oid"],
        }
        # storage class + tail pool ride the head record (the
        # RGWObjManifest's placement rule); absent = STANDARD in the
        # zone pool, so pre-tiering entries parse unchanged
        if ctx.get("storage_class"):
            entry["storage_class"] = ctx["storage_class"]
        if ctx.get("pool"):
            entry["pool"] = ctx["pool"]
        if sse is not None:
            entry["sse"] = sse
        if comp is not None:
            entry["comp"] = comp
        if multipart is not None:
            entry["multipart"] = multipart
        if slo:
            # Swift SLO: the manifest only REFERENCES independent
            # segment objects — deleting it must not delete them
            entry["slo"] = True
        if tags:
            entry["tags"] = {str(k): str(v) for k, v in tags.items()}
        if ctx.get("lock_retention"):
            entry["retention"] = ctx["lock_retention"]
        if ctx.get("lock_legal_hold"):
            entry["legal_hold"] = True
        if versioned:
            entry["version_id"] = version_id
            await self._record_version(bucket, key, entry)
        elif ctx["suspended"]:
            entry["version_id"] = "null"
            await self._record_version(bucket, key, entry)
        await self.ioctx.set_omap(ctx["index_oid"], {
            key: json.dumps(entry).encode(),
        })
        await self._log(bucket, "put", key, etag, size=size)
        await self._maybe_auto_reshard(bucket, ctx.get("meta", {}),
                                       key)
        out = {"etag": etag, "size": size}
        if versioned:
            out["version_id"] = version_id
        return out

    async def _entry(self, bucket: str, key: str,
                     need: str = "READ",
                     action: str = "s3:GetObject") -> dict:
        meta = await self._check_bucket(bucket, need,
                                        action=action, key=key)
        kv = await self._index_get(bucket, key, meta)
        if key not in kv:
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        entry = json.loads(kv[key])
        if entry.get("delete_marker"):
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        return entry

    async def get_object(self, bucket: str, key: str,
                         range_: tuple[int, int] | None = None,
                         sse_key: bytes | None = None) -> dict:
        """S3 GET (optionally a byte range, inclusive bounds).
        ``sse_key``: the SSE-C customer key for encrypted objects;
        SSE-KMS / SSE-S3 objects decrypt server-side via the KMS."""
        with self._trace_root("rgw:get", bucket=bucket, key=key):
            return await self._get_object_impl(bucket, key, range_,
                                               sse_key)

    async def _get_object_impl(self, bucket, key, range_,
                               sse_key) -> dict:
        entry = await self._entry(bucket, key)
        dk = await self._entry_sse_key(entry, sse_key)
        if entry.get("comp"):
            # compressed at rest: ranges slice the INFLATED bytes
            data = await self._inflate_read(entry, range_)
            return {"data": data, **entry}
        if dk is not None and entry["sse"].get("multipart"):
            data = await self._read_manifest(
                entry["multipart"], int(entry["size"]), range_,
                sse_key=dk, pool=entry.get("pool"))
            return {"data": data, **entry}
        data = await self._read_entry_data(bucket, key, entry, range_)
        if dk is not None:
            start = range_[0] if range_ is not None else 0
            data = sse_crypt(dk,
                             bytes.fromhex(entry["sse"]["nonce"]),
                             start, data)
        return {"data": data, **entry}

    async def _read_stored(self, entry: dict, off: int,
                           length: int) -> bytes:
        """Stored (possibly deflated) bytes by STORED offset — never
        clamped by the inflated size, which deflate can exceed."""
        oid = entry["data_oid"]
        ioctx, striper = await self._data_handles(entry.get("pool"))
        if entry["striped"]:
            return await striper.read(oid, length, off)
        return await ioctx.read(oid, length, off)

    async def _inflate_read(self, entry: dict,
                            range_: tuple[int, int] | None) -> bytes:
        """Read an at-rest-compressed entry's INFLATED bytes. Blocked
        objects (streamed PUTs) inflate only the blocks the range
        touches; legacy whole-body deflate inflates everything."""
        size = int(entry["size"])
        start, end = (0, size - 1) if range_ is None else range_
        end = min(end, size - 1)
        if end < start:
            return b""
        comp = get_compressor(entry["comp"].get("alg", "zlib"))
        blocks = entry["comp"].get("blocks")
        if blocks is None:
            raw = await self._read_stored(
                entry, 0, entry["comp"]["stored_size"])
            return comp.decompress(raw)[start:end + 1]
        async def one(soff, slen, skip, take):
            raw = await self._read_stored(entry, soff, slen)
            return comp.decompress(raw)[skip:skip + take]

        # the windows are independent stored ranges: fetch + inflate
        # them concurrently (the result is buffered whole either way)
        out = await asyncio.gather(*(
            one(*w) for w in comp_window(blocks, start, end)))
        return b"".join(out)

    async def _read_entry_data(self, bucket: str, key: str,
                               entry: dict,
                               range_: tuple[int, int] | None) -> bytes:
        oid = entry.get("data_oid", self._data_oid(bucket, key))
        if entry.get("multipart"):
            return await self._read_manifest(entry["multipart"],
                                             entry["size"], range_,
                                             pool=entry.get("pool"))
        ioctx, striper = await self._data_handles(entry.get("pool"))
        if range_ is not None:
            start, end = range_
            end = min(end, entry["size"] - 1)
            length = max(0, end - start + 1)
            if entry["striped"]:
                return await striper.read(oid, length, start)
            return await ioctx.read(oid, length, start)
        if entry["striped"]:
            return await striper.read(oid)
        return await ioctx.read(oid)

    async def stream_object(self, bucket: str, key: str,
                            range_: tuple[int, int] | None = None,
                            sse_key: bytes | None = None,
                            chunk: int = 1 << 20,
                            entry: dict | None = None):
        """Chunked S3 GET: returns (entry, async-generator) so the
        frontend never buffers the whole body (the beast frontend's
        streaming response path).  ``entry``: pass a just-fetched index
        entry to skip the re-read."""
        if entry is None:
            entry = await self._entry(bucket, key)
        sse_check(entry, sse_key)
        if entry.get("comp"):
            # read through the GIVEN entry so the headers the caller
            # already built and the body can never describe different
            # objects
            blocks = entry["comp"].get("blocks")
            if blocks is None:
                # legacy whole-body deflate (small buffered puts)
                data = await self._inflate_read(entry, range_)

                async def one():
                    yield data

                return entry, one()
            size = int(entry["size"])
            start, end = (0, size - 1) if range_ is None else range_
            end = min(end, size - 1)
            windows = comp_window(blocks, start, end)
            comp_dec = get_compressor(entry["comp"].get("alg", "zlib"))

            async def blocked():
                # one block in memory at a time: the block map keeps
                # streamed GETs of compressed objects bounded
                for soff, slen, skip, take in windows:
                    raw = await self._read_stored(entry, soff, slen)
                    yield comp_dec.decompress(raw)[skip:skip + take]

            return entry, blocked()
        size = int(entry["size"])
        start, end = (0, size - 1) if range_ is None else range_
        end = min(end, size - 1)
        if sse_key is not None and entry["sse"].get("multipart"):
            manifest = entry["multipart"]
            windows = manifest_window(
                [int(p["size"]) for p in manifest], start, end)
            mp_ioctx, _ = await self._data_handles(entry.get("pool"))

            async def gen_mp():
                # per-part nonces: decrypt at part-relative offsets,
                # chunk-bounded so huge parts never buffer whole
                for i, off, length in windows:
                    part = manifest[i]
                    pnonce = bytes.fromhex(part["nonce"])
                    pos, rem = off, length
                    while rem > 0:
                        n = min(chunk, rem)
                        data = await mp_ioctx.read(part["oid"], n,
                                                   pos)
                        yield sse_crypt(sse_key, pnonce, pos, data)
                        pos += n
                        rem -= n

            return entry, gen_mp()
        nonce = (bytes.fromhex(entry["sse"]["nonce"])
                 if sse_key is not None else b"")

        async def gen():
            pos = start
            while pos <= end:
                n = min(chunk, end - pos + 1)
                data = await self._read_entry_data(
                    bucket, key, entry, (pos, pos + n - 1))
                if sse_key is not None:
                    data = sse_crypt(sse_key, nonce, pos, data)
                yield data
                pos += n

        return entry, gen()

    async def _read_manifest(self, manifest: list[dict], size: int,
                             range_: tuple[int, int] | None,
                             sse_key: bytes | None = None,
                             pool: str | None = None) -> bytes:
        """Read through a multipart manifest (RGWObjManifest role):
        only the parts overlapping the requested range are fetched.
        ``sse_key``: decrypt SSE-C parts with their per-part nonce at
        part-relative offsets.  ``pool``: the placement pool the parts
        live in (zone pool when None)."""
        start, end = (0, size - 1) if range_ is None else range_
        end = min(end, size - 1)
        ioctx, _ = await self._data_handles(pool)
        chunks = []
        for i, off, length in manifest_window(
                [int(p["size"]) for p in manifest], start, end):
            raw = await ioctx.read(manifest[i]["oid"], length, off)
            if sse_key is not None and manifest[i].get("nonce"):
                raw = sse_crypt(
                    sse_key, bytes.fromhex(manifest[i]["nonce"]),
                    off, raw)
            chunks.append(raw)
        return b"".join(chunks)

    async def head_object(self, bucket: str, key: str) -> dict:
        return await self._entry(bucket, key)

    @_reclaims_space
    async def delete_object(self, bucket: str, key: str) -> None:
        meta = await self._check_bucket(
            bucket, "WRITE", action="s3:DeleteObject", key=key)
        state = meta.get("versioning", "")
        self._index_writable(meta)
        index_oid = self._index_oid_for(bucket, meta, key)
        kv = await self._index_get(bucket, key, meta)
        entry = json.loads(kv[key]) if key in kv else None
        if state == "enabled":
            # versioned DELETE always succeeds: data survives and a
            # delete MARKER becomes current — stacking on prior
            # markers and absent keys alike (S3 semantics)
            if entry is not None and not entry.get("delete_marker"):
                await self._adopt_null_version(bucket, key, entry)
            version_id = self._new_version_id()
            marker = {
                "size": 0, "etag": "", "mtime": time.time(),
                "delete_marker": True, "version_id": version_id,
                "striped": False, "meta": {},
            }
            await self._record_version(bucket, key, marker)
            await self.ioctx.set_omap(index_oid, {
                key: json.dumps(marker).encode(),
            })
            await self._log(bucket, "del", key,
                            event="s3:ObjectRemoved:DeleteMarkerCreated")
            return
        if state == "suspended":
            # suspended DELETE replaces the 'null' version with a null
            # delete marker; versioned history is untouched.  A
            # pre-versioning current entry IS the implicit null
            # version — its data dies with it, or it leaks forever
            await self._remove_null_version(bucket, key)
            if entry is not None and not entry.get("version_id") \
                    and not entry.get("delete_marker"):
                await self._remove_entry_data(bucket, key, entry)
            marker = {
                "size": 0, "etag": "", "mtime": time.time(),
                "delete_marker": True, "version_id": "null",
                "striped": False, "meta": {},
            }
            await self._record_version(bucket, key, marker)
            await self.ioctx.set_omap(index_oid, {
                key: json.dumps(marker).encode(),
            })
            await self._log(bucket, "del", key,
                            event="s3:ObjectRemoved:DeleteMarkerCreated")
            return
        if entry is None or entry.get("delete_marker"):
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        await self._remove_entry_data(bucket, key, entry)
        await self.ioctx.rm_omap_keys(index_oid, [key])
        await self._log(bucket, "del", key)

    async def copy_object(self, src_bucket: str, src_key: str,
                          dst_bucket: str, dst_key: str,
                          src_sse_key: bytes | None = None,
                          sse_key: bytes | None = None,
                          sse: str | None = None,
                          kms_key_id: str | None = None,
                          storage_class: str | None = None) -> dict:
        """S3 CopyObject.  A KMS-encrypted source decrypts server-side
        (no key needed); SSE-C sources need ``src_sse_key``.  The
        destination re-encrypts per ``sse``/``kms_key_id``/``sse_key``
        — copies never splice ciphertext, so source and destination
        keys are independent (rgw_crypt.cc copy rule).
        ``storage_class``: the DESTINATION's class (a copy is a fresh
        PUT; the source's class does not follow the bytes)."""
        got = await self.get_object(src_bucket, src_key,
                                    sse_key=src_sse_key)
        return await self.put_object(
            dst_bucket, dst_key, got["data"],
            content_type=got["content_type"], metadata=got["meta"],
            tags=got.get("tags") or None,
            sse_key=sse_key, sse=sse, kms_key_id=kms_key_id,
            storage_class=storage_class,
        )

    async def list_objects(self, bucket: str, prefix: str = "",
                           marker: str = "",
                           max_keys: int = 1000,
                           delimiter: str = "") -> dict:
        """S3 ListObjects: sorted, prefix-filtered, marker-paginated.
        ``delimiter`` rolls keys sharing prefix..delimiter up into
        common_prefixes (the folder-browsing view); common prefixes
        count toward max_keys, as S3 counts them."""
        meta = await self._check_bucket(bucket, "READ",
                                        action="s3:ListBucket")
        index = await self._index_all(bucket, meta)
        contents: list = []
        prefixes: list[str] = []
        seen_prefixes: set[str] = set()
        truncated = False
        last = ""
        # lazy parse: stop after filling the page + 1 (truncation
        # probe) instead of json-decoding the whole bucket per listing
        for k in sorted(index):
            if not k.startswith(prefix) or k <= marker:
                continue
            if delimiter:
                rest = k[len(prefix):]
                pos = rest.find(delimiter)
                if pos >= 0:
                    cp = prefix + rest[:pos + len(delimiter)]
                    if cp in seen_prefixes or cp == marker:
                        continue      # rolled up / prior page
                    # a marker STRICTLY inside the group (start-after
                    # on a member key) must not hide the group: keys
                    # past it still roll up, as S3 rolls them
                    if json.loads(index[k]).get("delete_marker"):
                        continue      # a dead member alone must not
                                      # surface a phantom prefix
                    if len(contents) + len(prefixes) == max_keys:
                        truncated = True
                        break
                    seen_prefixes.add(cp)
                    prefixes.append(cp)
                    last = cp
                    continue
            entry = json.loads(index[k])
            if entry.get("delete_marker"):
                continue
            if len(contents) + len(prefixes) == max_keys:
                truncated = True
                break
            item = {
                "key": k, "size": entry["size"], "etag": entry["etag"],
                "mtime": entry["mtime"],
            }
            if entry.get("tags"):
                item["tags"] = entry["tags"]
            if entry.get("storage_class"):
                item["storage_class"] = entry["storage_class"]
            contents.append(item)
            last = k
        return {
            "contents": contents,
            "common_prefixes": prefixes,
            "is_truncated": truncated,
            "next_marker": last if truncated else "",
        }
