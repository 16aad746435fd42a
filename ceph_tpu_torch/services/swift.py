"""Swift REST frontend for RGW-lite: the rgw_rest_swift.h role.

Counterpart of ceph_tpu/services/swift.py: the same module over the
port's imports.

The reference serves the OpenStack Swift dialect off the same RGWRados
store as S3 (src/rgw/rgw_rest_swift.{h,cc}); this frontend serves the
Swift v1 core off the same :class:`RGWLite`, so a container created
over Swift is a bucket over S3 and vice versa:

- TempAuth handshake (``GET /auth/v1.0`` with ``X-Auth-User`` /
  ``X-Auth-Key``) returning ``X-Auth-Token`` + ``X-Storage-Url``; the
  token is self-validating (uid + expiry + HMAC over the user's secret
  key), so no server-side token table is needed.
- Account:   ``GET /v1/AUTH_<uid>``        container listing (JSON)
- Container: ``PUT/GET/HEAD/DELETE /v1/AUTH_<uid>/<container>``
- Object:    ``PUT/GET/HEAD/DELETE/POST /v1/AUTH_<uid>/<c>/<obj>``
  with ``X-Object-Meta-*`` metadata, Range reads, and POST metadata
  replacement (Swift semantics).

Authorization rides RGWLite ``as_user`` exactly like the S3 frontend,
so ACL/quota/versioning behavior is shared.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json
import time
from email.utils import formatdate

from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.services.rgw import RGWError, RGWLite, RGWUsers

log = Dout("rgw-http")

_MAX_BODY = 256 * 1024 * 1024
TOKEN_TTL = 24 * 3600

# RGWError -> Swift status
_STATUS = {
    "AccessDenied": 403,
    "NoSuchBucket": 404,
    "NoSuchKey": 404,
    "BucketNotEmpty": 409,
    "BucketAlreadyExists": 202,    # Swift PUT container is idempotent
    "QuotaExceeded": 413,
}


def _mint_token(uid: str, secret: str, now: float | None = None) -> str:
    exp = int((now or time.time()) + TOKEN_TTL)
    mac = hmac.new(secret.encode(), f"{uid}:{exp}".encode(),
                   hashlib.sha256).hexdigest()[:32]
    return f"AUTH_tk{uid}:{exp}:{mac}"


class SwiftFrontend:
    """One listening Swift endpoint over an RGWLite handle."""

    def __init__(self, rgw: RGWLite, users: RGWUsers | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.rgw = rgw
        self.users = users if users is not None else rgw.users
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.dout(1, "swift frontend on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- http plumbing -----------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                try:
                    method, path, _ = lines[0].split(" ", 2)
                except ValueError:
                    break
                hdrs = {}
                for ln in lines[1:]:
                    if ln:
                        k, _, v = ln.partition(":")
                        hdrs[k.strip().lower()] = v.strip()
                try:
                    length = int(hdrs.get("content-length", "0") or 0)
                except ValueError:
                    length = -1
                if not 0 <= length <= _MAX_BODY:
                    # the unread body would desynchronize a reused
                    # connection: answer and close
                    status, rh, body = 400, {}, b"bad content-length"
                    hdrs["connection"] = "close"
                else:
                    data = await reader.readexactly(length) \
                        if length > 0 else b""
                    try:
                        status, rh, body = await self._route(
                            method.upper(), path, hdrs, data)
                    except RGWError as e:
                        status = _STATUS.get(e.code, 400)
                        rh, body = {}, str(e).encode()
                    except (ValueError, KeyError) as e:
                        status, rh, body = 400, {}, repr(e).encode()
                keep = hdrs.get("connection", "keep-alive") != "close"
                base = {"date": formatdate(usegmt=True),
                        "connection":
                            "keep-alive" if keep else "close"}
                base.update(rh)
                # handlers (e.g. HEAD object) may have set the entity
                # size already; only fill in the actual body length
                base.setdefault("content-length", str(len(body)))
                out = [f"HTTP/1.1 {status} S"]
                out += [f"{k}: {v}" for k, v in base.items()]
                payload = "\r\n".join(out).encode("latin-1") \
                    + b"\r\n\r\n"
                if method.upper() != "HEAD":
                    payload += body
                writer.write(payload)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- auth (TempAuth) ---------------------------------------------------
    async def _auth_handshake(self, hdrs: dict):
        user = hdrs.get("x-auth-user", "")
        key = hdrs.get("x-auth-key", "")
        uid = user.split(":", 1)[0]
        try:
            rec = await self.users.get(uid)
        except RGWError:
            return 401, {}, b"bad credentials"
        if rec.get("suspended") or not hmac.compare_digest(
                key.encode(), rec["secret_key"].encode()):
            # bytes compare: str compare_digest raises on non-ASCII
            # header values, which must be a 401, not a dead socket
            return 401, {}, b"bad credentials"
        token = _mint_token(uid, rec["secret_key"])
        url = f"http://{self.host}:{self.port}/v1/AUTH_{uid}"
        return 200, {"x-auth-token": token,
                     "x-storage-token": token,
                     "x-storage-url": url}, b""

    async def _validate_token(self, token: str) -> str:
        """Token -> uid, or raise AccessDenied."""
        try:
            rest = token.removeprefix("AUTH_tk")
            uid, exp_s, mac = rest.rsplit(":", 2)
            exp = int(exp_s)
        except ValueError:
            raise RGWError("AccessDenied", "malformed token")
        if exp < time.time():
            raise RGWError("AccessDenied", "token expired")
        try:
            rec = await self.users.get(uid)
        except RGWError:
            raise RGWError("AccessDenied", "unknown account")
        want = hmac.new(rec["secret_key"].encode(),
                        f"{uid}:{exp}".encode(),
                        hashlib.sha256).hexdigest()[:32]
        if not hmac.compare_digest(want, mac):
            raise RGWError("AccessDenied", "bad token")
        if rec.get("suspended"):
            raise RGWError("AccessDenied", f"{uid} suspended")
        return uid

    # -- TempURL (reference rgw_swift_auth.h:176 TempURLEngine) ------------
    async def _temp_url(self, method: str, path: str, query: dict,
                        hdrs: dict, body: bytes):
        """Validate ``?temp_url_sig=&temp_url_expires=`` pre-signed
        access against the account's Temp-URL keys (the
        X-Account-Meta-Temp-URL-Key / -Key-2 metadata), then execute
        the object op as the account.  Signature = HMAC(key,
        "<method>\\n<expires>\\n<path>"), sha1 or sha256 by digest
        length; prefix mode signs "prefix:<path-prefix>" and admits
        any object under it.  HEAD is allowed with a GET or PUT
        signature (Swift tempurl middleware rules)."""
        parts = [p for p in path.split("/") if p]
        if len(parts) < 4 or parts[0] != "v1" \
                or not parts[1].startswith("AUTH_"):
            return 401, {}, b"temp url requires an object path"
        account = parts[1][len("AUTH_"):]
        container = parts[2]
        obj = "/".join(parts[3:])
        try:
            expires = int(query["temp_url_expires"])
        except ValueError:
            return 401, {}, b"bad temp_url_expires"
        if time.time() > expires:
            return 401, {}, b"temp url expired"
        try:
            rec = await self.users.get(account)
        except RGWError:
            return 401, {}, b"bad temp url"
        meta = rec.get("swift_meta") or {}
        keys = [meta[k] for k in ("temp-url-key", "temp-url-key-2")
                if meta.get(k)]
        if not keys or rec.get("suspended"):
            return 401, {}, b"no temp-url keys set"
        sig = str(query["temp_url_sig"]).lower()
        digestmod = {40: hashlib.sha1, 64: hashlib.sha256}.get(
            len(sig))
        if digestmod is None:
            return 401, {}, b"bad signature"
        prefix = query.get("temp_url_prefix")
        if prefix is not None:
            if not obj.startswith(prefix):
                return 401, {}, b"object outside signed prefix"
            signed_path = f"/v1/AUTH_{account}/{container}/{prefix}"
            body_of = lambda m: f"{m}\n{expires}\nprefix:{signed_path}"
        else:
            signed_path = path
            body_of = lambda m: f"{m}\n{expires}\n{signed_path}"
        # HEAD validates with a GET or PUT signature too
        methods = {"HEAD": ("HEAD", "GET", "PUT")}.get(method,
                                                       (method,))
        if method not in ("GET", "HEAD", "PUT"):
            return 401, {}, b"method not allowed for temp urls"
        ok = any(
            hmac.compare_digest(
                hmac.new(key.encode(), body_of(m).encode(),
                         digestmod).hexdigest(), sig)
            for key in keys for m in methods
        )
        if not ok:
            return 401, {}, b"invalid temp url signature"
        gw = self.rgw.as_user(account)
        return await self._object(method, gw, container, obj, hdrs,
                                  body, {})

    # -- routing (RGWHandler_REST_SWIFT) -----------------------------------
    async def _route(self, method: str, raw_path: str, hdrs: dict,
                     body: bytes):
        import urllib.parse

        path, _, rawq = raw_path.partition("?")
        query = {}
        for part in rawq.split("&") if rawq else ():
            k, _, v = part.partition("=")
            query[urllib.parse.unquote(k)] = urllib.parse.unquote(v)
        if path.rstrip("/") == "/auth/v1.0":
            return await self._auth_handshake(hdrs)
        if "temp_url_sig" in query and "temp_url_expires" in query:
            # pre-signed access: no token at all (TempURLEngine,
            # reference rgw_swift_auth.h:176)
            return await self._temp_url(method, path, query, hdrs,
                                        body)
        uid = await self._validate_token(hdrs.get("x-auth-token", ""))
        parts = [p for p in path.split("/") if p]
        # /v1/AUTH_<account>[/container[/object...]]
        if len(parts) < 2 or parts[0] != "v1" \
                or not parts[1].startswith("AUTH_"):
            return 404, {}, b"not found"
        account = parts[1][len("AUTH_"):]
        if account != uid:
            raise RGWError("AccessDenied", "cross-account access")
        gw = self.rgw.as_user(uid)
        if len(parts) == 2:
            if method == "POST" and "bulk-delete" in query:
                return await self._bulk_delete(gw, hdrs, body)
            return await self._account(method, gw, uid, hdrs)
        container = parts[2]
        if len(parts) == 3:
            return await self._container(method, gw, container, query,
                                         hdrs)
        obj = "/".join(parts[3:])
        return await self._object(method, gw, container, obj, hdrs,
                                  body, query)

    async def _dlo_read(self, method: str, gw: RGWLite, entry: dict,
                        dlo: str, rng):
        """Dynamic Large Object GET/HEAD: concatenate every object
        under <container>/<prefix> in name order (Swift DLO
        semantics)."""
        from ceph_tpu_torch.services.rgw import manifest_window

        sc, _, prefix = dlo.lstrip("/").partition("/")
        segs = []
        marker = ""
        while True:
            listing = await gw.list_objects(sc, prefix=prefix,
                                            marker=marker,
                                            max_keys=1000)
            segs += listing["contents"]
            if not listing.get("is_truncated"):
                break
            marker = segs[-1]["key"]
        total = sum(int(c["size"]) for c in segs)
        if method == "HEAD":
            return 200, _dlo_headers(entry, total), b""
        start, end = (0, total - 1) if rng is None else \
            (rng[0], min(rng[1], total - 1))
        if rng is not None and start >= total:
            return 416, {"content-range": f"bytes */{total}"}, b""
        chunks = []
        for i, off, length in manifest_window(
                [int(c["size"]) for c in segs], start, end):
            got = await gw.get_object(
                sc, segs[i]["key"], range_=(off, off + length - 1))
            chunks.append(got["data"])
        body = b"".join(chunks)
        hdrs = _dlo_headers(entry, len(body))
        if rng is not None:
            hdrs["content-range"] = f"bytes {start}-{end}/{total}"
            return 206, hdrs, body
        return 200, hdrs, body

    async def _bulk_delete(self, gw: RGWLite, hdrs: dict,
                           body: bytes):
        """Swift bulk delete (POST ?bulk-delete, the bulk middleware):
        newline-separated "container/object" (or bare "container")
        paths, per-item outcomes summarised in a JSON report — one
        bad item must not abort the rest."""
        import urllib.parse
        paths = [urllib.parse.unquote(ln.strip())
                 for ln in body.decode(errors="replace").splitlines()
                 if ln.strip()]
        if len(paths) > 10000:
            return 413, {}, b"too many items"
        deleted = not_found = 0
        errors: list[list[str]] = []
        for p in paths:
            container, _, obj = p.lstrip("/").partition("/")
            try:
                if obj:
                    await gw.delete_object(container, obj)
                else:
                    await gw.delete_bucket(container)
                deleted += 1
            except RGWError as e:
                if e.code in ("NoSuchKey", "NoSuchBucket"):
                    not_found += 1
                else:
                    errors.append([p, e.code])
        report = {
            "Number Deleted": deleted,
            "Number Not Found": not_found,
            "Response Status": "200 OK" if not errors
            else "400 Bad Request",
            "Errors": errors,
        }
        return (200, {"content-type": "application/json"},
                json.dumps(report).encode())

    async def _account(self, method: str, gw: RGWLite, uid: str,
                       hdrs: dict | None = None):
        hdrs = hdrs or {}
        if method == "POST":
            # Swift account metadata (x-account-meta-* sets,
            # x-remove-account-meta-* deletes), kept on the user
            # record like the reference's user attrs
            rec = await self.users.get(uid)
            stored = dict(rec.get("swift_meta") or {})
            sets, removes = _meta_headers_for(hdrs, "account")
            stored.update(sets)
            for k in removes:
                stored.pop(k, None)
            await self.users.set_swift_meta(uid, stored)
            return 204, {}, b""
        if method not in ("GET", "HEAD"):
            return 405, {}, b""
        out = []
        for b in await gw.list_buckets():
            try:
                meta = await gw._bucket_meta(b)
            except RGWError:
                continue
            if meta.get("owner") != uid:
                continue
            nbytes, nobj = await gw._bucket_usage(b)
            out.append({"name": b, "count": nobj, "bytes": nbytes})
        rh = {"content-type": "application/json",
              "x-account-container-count": str(len(out)),
              "x-account-object-count":
                  str(sum(c["count"] for c in out)),
              "x-account-bytes-used":
                  str(sum(c["bytes"] for c in out))}
        rec = await self.users.get(uid)
        for k, v in sorted((rec.get("swift_meta") or {}).items()):
            rh[f"x-account-meta-{k}"] = v
        return 200, rh, json.dumps(out).encode()

    async def _container(self, method: str, gw: RGWLite, name: str,
                         query: dict | None = None,
                         hdrs: dict | None = None):
        query = query or {}
        hdrs = hdrs or {}
        if method == "PUT":
            cmeta = _container_meta_headers(hdrs)
            try:
                await gw.create_bucket(name)
                status = 201
            except RGWError as e:
                if e.code != "BucketAlreadyExists":
                    raise
                status = 202            # Swift: idempotent accept
                if cmeta[0] or cmeta[1]:
                    # an EXISTING container's metadata is owner-gated
                    # (the create path made us the owner already)
                    await gw._check_bucket(name, "FULL_CONTROL")
            if cmeta[0] or cmeta[1]:
                await self._apply_container_meta(gw, name, cmeta)
            return status, {}, b""
        if method == "POST":
            # Swift container metadata update: x-container-meta-* sets,
            # x-remove-container-meta-* deletes (rgw_rest_swift's
            # REST_Swift container POST)
            await gw._check_bucket(name, "FULL_CONTROL")
            await self._apply_container_meta(
                gw, name, _container_meta_headers(hdrs))
            return 204, {}, b""
        if method == "DELETE":
            await gw.delete_bucket(name)
            return 204, {}, b""
        if method in ("GET", "HEAD"):
            # container headers reflect the WHOLE container (Swift
            # semantics), independent of the listing page below
            bmeta = await gw._check_bucket(name, "READ")
            nbytes, nobj = await gw._bucket_usage(name, bmeta)
            rh = {"content-type": "application/json",
                  "x-container-object-count": str(nobj),
                  "x-container-bytes-used": str(nbytes)}
            for k, v in sorted((bmeta.get("swift_meta")
                                or {}).items()):
                rh[f"x-container-meta-{k}"] = v
            # Swift listing semantics: ?limit= caps the page, ?marker=
            # resumes after a name, ?prefix= filters — clients page
            # through arbitrarily large containers
            try:
                limit = max(0, min(int(query.get("limit", 10000)),
                                   10000))
            except ValueError:
                limit = 10000
            if limit == 0:
                # terminal empty page (never "truncated": a paging
                # client could not advance its marker and would spin)
                return 200, rh, b"[]"
            listing = await gw.list_objects(
                name, prefix=query.get("prefix", ""),
                marker=query.get("marker", ""), max_keys=limit,
                delimiter=query.get("delimiter", ""))
            out = [{
                "name": c["key"], "bytes": c["size"],
                "hash": c["etag"],
                "last_modified": _iso(c["mtime"]),
            } for c in listing["contents"]]
            # Swift renders rolled-up prefixes as subdir entries
            out += [{"subdir": cp}
                    for cp in listing.get("common_prefixes", ())]
            out.sort(key=lambda e: e.get("name", e.get("subdir",
                                                       "")))
            if listing.get("is_truncated"):
                rh["x-container-truncated"] = "true"
            return 200, rh, json.dumps(out).encode()
        return 405, {}, b""

    @staticmethod
    async def _apply_container_meta(gw: RGWLite, name: str,
                                    cmeta: tuple[dict, list]) -> None:
        sets, removes = cmeta
        bmeta = await gw._bucket_meta(name)
        stored = dict(bmeta.get("swift_meta") or {})
        stored.update(sets)
        for k in removes:
            stored.pop(k, None)
        bmeta["swift_meta"] = stored
        await gw._put_bucket_meta(name, bmeta)

    async def _reap_if_expired(self, gw: RGWLite, container: str,
                               obj: str, entry: dict) -> bool:
        """Swift object expiry on the read path: an object past its
        X-Delete-At reads as absent and is deleted inline (the
        object-expirer daemon's reconciliation, collapsed)."""
        if not _expired(entry, time.time()):
            return False
        try:
            await gw.delete_object(container, obj)
        except RGWError:
            pass                  # already raced away
        return True

    async def expirer_pass(self, now: float | None = None) -> dict:
        """One object-expirer sweep over every container (Swift's
        object-expirer daemon role): reap objects whose X-Delete-At
        has passed.  Returns container -> [reaped names]."""
        now = time.time() if now is None else now
        gw = self.rgw
        reaped: dict[str, list[str]] = {}
        for container in await gw.list_buckets():
            # ONE index read per container, not one head per object:
            # the entries already carry the meta the check needs
            try:
                bmeta = await gw._bucket_meta(container)
                index = await gw._index_all(container, bmeta)
            except RGWError:
                continue
            for key, raw in index.items():
                entry = json.loads(raw)
                if entry.get("delete_marker"):
                    continue
                if _expired(entry, now):
                    try:
                        await gw.delete_object(container, key)
                    except RGWError:
                        continue
                    reaped.setdefault(container, []).append(key)
        return reaped

    async def _object(self, method: str, gw: RGWLite, container: str,
                      obj: str, hdrs: dict, body: bytes,
                      query: dict | None = None):
        query = query or {}
        mm = query.get("multipart-manifest", "")
        if method == "PUT" and mm == "put":
            # SLO manifest: JSON [{path, etag?, size_bytes?}, ...]
            try:
                listing = json.loads(body.decode())
                segments = []
                for s in listing:
                    sb, _, sk = str(s["path"]).lstrip("/").partition("/")
                    if not sb or not sk:
                        raise ValueError(s.get("path"))
                    segments.append({
                        "bucket": sb, "key": sk,
                        "etag": s.get("etag", ""),
                        "size_bytes": s.get("size_bytes", 0),
                    })
            except (ValueError, TypeError, KeyError) as e:
                return 400, {}, f"bad manifest: {e!r}".encode()
            slo_meta = {k[len("x-object-meta-"):]: v
                        for k, v in hdrs.items()
                        if k.startswith("x-object-meta-")}
            exp = _parse_expiry(hdrs)
            if exp is not None:
                slo_meta["delete_at"] = exp
            out = await gw.put_slo_manifest(
                container, obj, segments,
                content_type=hdrs.get("content-type",
                                      "application/octet-stream"),
                metadata=slo_meta)
            return 201, {"etag": out["etag"]}, b""
        if method == "GET" and mm == "get":
            entry = await gw.head_object(container, obj)
            descr = _slo_descr(entry)
            if descr is None:
                return 400, {}, b"not an SLO manifest"
            return 200, {"content-type": "application/json"}, \
                json.dumps(descr).encode()
        if method == "DELETE" and mm == "delete":
            # delete the manifest AND its segments (Swift semantics)
            entry = await gw.head_object(container, obj)
            descr = _slo_descr(entry) or []
            await gw.delete_object(container, obj)
            for s in descr:
                sb, _, sk = str(s["name"]).lstrip("/").partition("/")
                try:
                    await gw.delete_object(sb, sk)
                except RGWError:
                    pass            # already gone / foreign container
            return 204, {}, b""
        if method == "PUT":
            # slo_segments is SERVER-owned metadata: a client header
            # forging it would poison manifest introspection/delete
            meta = _client_meta(hdrs)
            exp = _parse_expiry(hdrs)
            if exp is not None:
                meta["delete_at"] = exp
            dlo = hdrs.get("x-object-manifest", "")
            if dlo:
                # DLO: zero-byte manifest whose GET concatenates every
                # object under <container>/<prefix> (Swift dynamic
                # large objects)
                meta["dlo_manifest"] = dlo
            out = await gw.put_object(
                container, obj, body,
                content_type=hdrs.get("content-type",
                                      "application/octet-stream"),
                metadata=meta)
            return 201, {"etag": out["etag"]}, b""
        if method == "POST":
            # Swift POST REPLACES the object metadata set (unlike S3
            # copy-with-metadata); -lite rewrites the index entry.
            # X-Object-Manifest follows Swift semantics: present sets
            # the DLO pointer, absent drops it (clients re-send it to
            # keep a manifest through a metadata update).
            await gw._check_bucket(container, "WRITE")
            entry = await gw.head_object(container, obj)
            if await self._reap_if_expired(gw, container, obj,
                                           entry):
                return 404, {}, b""      # updating a ghost lies
            meta = _client_meta(hdrs)
            exp = _parse_expiry(hdrs)
            if exp is not None:
                meta["delete_at"] = exp
            elif "x-remove-delete-at" not in hdrs:
                # POST replaces the meta set, but expiry survives
                # unless explicitly removed (Swift keeps X-Delete-At
                # through metadata updates)
                old_exp = (entry.get("meta") or {}).get("delete_at")
                if old_exp is not None:
                    meta["delete_at"] = old_exp
            slo = (entry.get("meta") or {}).get("slo_segments")
            if slo is not None:
                meta["slo_segments"] = slo     # server-owned: sticky
            dlo = hdrs.get("x-object-manifest", "")
            if dlo and not entry.get("slo"):
                meta["dlo_manifest"] = dlo
            entry["meta"] = meta
            bmeta = await gw._bucket_meta(container)
            await gw._index_set(container, bmeta, obj,
                                json.dumps(entry).encode())
            return 202, {}, b""
        if method == "DELETE":
            await gw.delete_object(container, obj)
            return 204, {}, b""
        if method in ("GET", "HEAD"):
            rng = None
            rh = hdrs.get("range", "")
            if rh.startswith("bytes=") and "-" in rh[6:]:
                a, _, b = rh[6:].partition("-")
                if a:
                    rng = (int(a), int(b) if b else (1 << 62))
                    if rng[1] < rng[0]:
                        # RFC 9110: a syntactically inverted range is
                        # INVALID — ignore it and serve the full body
                        rng = None
            if method == "HEAD":
                entry = await gw.head_object(container, obj)
                if await self._reap_if_expired(gw, container, obj,
                                               entry):
                    return 404, {}, b""
                dlo = (entry.get("meta") or {}).get("dlo_manifest")
                if dlo and not entry.get("slo"):
                    return await self._dlo_read("HEAD", gw, entry,
                                                dlo, rng)
                return 200, _obj_headers(entry), b""
            got = await gw.get_object(container, obj, range_=rng)
            if await self._reap_if_expired(gw, container, obj, got):
                return 404, {}, b""
            dlo = (got.get("meta") or {}).get("dlo_manifest")
            if dlo and not got.get("slo"):
                # a manifest's stored body is empty: the probe wasted
                # nothing and the hot plain-GET path stays one read
                return await self._dlo_read("GET", gw, got, dlo, rng)
            rh = _obj_headers(got)
            if rng is not None:
                size = int(got.get("size", 0))
                if rng[0] >= size:
                    # unsatisfiable range: 416, never a 206 whose
                    # Content-Range would read end < start
                    return 416, {"content-range": f"bytes */{size}"}, \
                        b""
                # the entity is the RANGE: frame it correctly or a
                # keep-alive peer blocks waiting for the full size
                end = min(rng[1], size - 1)
                rh["content-length"] = str(len(got["data"]))
                rh["content-range"] = f"bytes {rng[0]}-{end}/{size}"
                return 206, rh, got["data"]
            return 200, rh, got["data"]
        return 405, {}, b""


_SERVER_META = ("slo_segments", "dlo_manifest", "delete_at")


def _parse_expiry(hdrs: dict) -> float | None:
    """X-Delete-At (epoch) / X-Delete-After (relative seconds) —
    Swift object expiry.  Past or non-numeric values are 400s."""
    at = hdrs.get("x-delete-at")
    after = hdrs.get("x-delete-after")
    if at is None and after is None:
        return None
    # non-numeric values raise ValueError, which the dispatcher
    # renders as the 400 Swift answers
    when = float(at) if at is not None \
        else time.time() + float(after)
    if not when > time.time():
        # the inverted comparison catches NaN too — storing it would
        # read as instantly-expired (silent data loss on first GET)
        raise ValueError("X-Delete-At is in the past")
    return when


def _expired(entry: dict, now: float) -> bool:
    """ONE expiry predicate for the read-path reap and the sweep."""
    exp = (entry.get("meta") or {}).get("delete_at")
    return exp is not None and float(exp) <= now


def _meta_headers_for(hdrs: dict, scope: str) -> tuple[dict, list]:
    """(sets, removes) from x-<scope>-meta-* /
    x-remove-<scope>-meta-* headers (scope: container / account)."""
    pfx = f"x-{scope}-meta-"
    rm_pfx = f"x-remove-{scope}-meta-"
    sets = {k[len(pfx):]: v for k, v in hdrs.items()
            if k.startswith(pfx) and len(k) > len(pfx)}
    removes = [k[len(rm_pfx):] for k in hdrs
               if k.startswith(rm_pfx)]
    return sets, removes


def _container_meta_headers(hdrs: dict) -> tuple[dict, list]:
    return _meta_headers_for(hdrs, "container")


def _client_meta(hdrs: dict) -> dict:
    """x-object-meta-* minus the server-owned keys (forging them would
    poison manifest introspection/resolution)."""
    return {k[len("x-object-meta-"):]: v
            for k, v in hdrs.items()
            if k.startswith("x-object-meta-")
            and k[len("x-object-meta-"):] not in _SERVER_META}


def _dlo_headers(entry: dict, size: int) -> dict:
    hdrs = _obj_headers(entry)
    hdrs["content-length"] = str(size)
    hdrs["x-object-manifest"] = entry["meta"]["dlo_manifest"]
    return hdrs


def _slo_descr(entry: dict) -> list | None:
    """The trusted manifest description: entry['slo'] is set only by
    put_slo_manifest (user metadata cannot forge the server flag)."""
    if not entry.get("slo"):
        return None
    descr = (entry.get("meta") or {}).get("slo_segments")
    if not isinstance(descr, list) or not all(
            isinstance(s, dict) and "name" in s for s in descr):
        return None
    return descr


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000000",
                         time.gmtime(ts))


def _obj_headers(entry: dict) -> dict:
    hdrs = {
        "content-type": entry.get("content_type",
                                  "application/octet-stream"),
        "etag": entry.get("etag", ""),
        "x-timestamp": str(entry.get("mtime", 0.0)),
        "content-length": str(entry.get("size", 0)),
    }
    for k, v in (entry.get("meta") or {}).items():
        if k not in _SERVER_META:
            hdrs[f"x-object-meta-{k}"] = str(v)
    exp = (entry.get("meta") or {}).get("delete_at")
    if exp is not None:
        hdrs["x-delete-at"] = str(int(float(exp)))
    return hdrs
