"""S3 REST frontend for RGW-lite: the asio/beast frontend role.

Counterpart of ceph_tpu/services/rgw_http.py: the same module over the
port's imports.

The reference serves S3 over HTTP through an embedded server
(src/rgw/rgw_asio_frontend.cc) that parses requests into RGWOps
(rgw_rest_s3.cc) and authenticates AWS Signature V4 headers
(rgw_auth_s3.cc).  This frontend does the same on asyncio streams:

- HTTP/1.1 keep-alive parsing (request line, headers, Content-Length
  bodies) without any web framework — the runtime stays stdlib.
- AWS SigV4 verification against the RGWUsers key table: canonical
  request -> string-to-sign -> derived signing key, exactly the
  published algorithm, so any stock S3 SDK signs compatibly.  No
  Authorization header means the ``anonymous`` identity.
- Routing: service (/), bucket (/b), object (/b/k) levels with the S3
  subresources (?versioning ?versions ?uploads ?lifecycle ?acl
  ?delete ?partNumber&uploadId), Range/ETag/x-amz-meta-* headers and
  XML bodies in the S3 namespace.

Every operation funnels into :class:`RGWLite` ``as_user(uid)`` so ACL,
quota, versioning and datalog behavior is identical to the library
path the rest of the framework (multisite sync, radosgw-admin) uses.
"""

from __future__ import annotations

import asyncio
import calendar
import hashlib
import hmac
import math
import time
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate

from ceph_tpu_torch.common.events import emit_proc
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.qos import TokenBucket
from ceph_tpu_torch.services.rgw import (
    ANONYMOUS,
    RGWError,
    RGWLite,
    RGWUsers,
    sse_check,
    sse_crypt,
)

log = Dout("rgw-http")

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
_MAX_BODY = 256 * 1024 * 1024       # buffered (non-streaming) bodies only
_STREAM_MIN = 1 << 20               # PUT bodies this big stream
_STREAM_CHUNK = 1 << 20
_EMPTY_SHA = hashlib.sha256(b"").hexdigest()

# RGWError code -> HTTP status (rgw_common.cc rgw_http_s3_errors)
_STATUS = {
    "AccessDenied": 403,
    "SignatureDoesNotMatch": 403,
    "InvalidAccessKeyId": 403,
    "NoSuchBucket": 404,
    "NoSuchKey": 404,
    "NoSuchUser": 404,
    "UserAlreadyExists": 409,
    "NoSuchVersion": 404,
    "NoSuchUpload": 404,
    "NoSuchLifecycleConfiguration": 404,
    "NoSuchBucketPolicy": 404,
    "NoSuchCORSConfiguration": 404,
    "NoSuchWebsiteConfiguration": 404,
    "ObjectLockConfigurationNotFoundError": 404,
    "InvalidBucketState": 409,
    "NoSuchObjectLockConfiguration": 404,
    "MalformedPolicy": 400,
    "BucketNotEmpty": 409,
    "BucketAlreadyExists": 409,
    "PreconditionFailed": 412,
    "QuotaExceeded": 403,
    "MethodNotAllowed": 405,
    "InvalidRange": 416,
    "MalformedXML": 400,
    "InvalidStorageClass": 400,
    "NotImplemented": 501,
}


class _HTTPError(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        self.status = status
        self.code = code
        self.msg = msg


class _Request:
    def __init__(self, method: str, raw_path: str,
                 headers: dict[str, str], body: bytes):
        self.method = method
        self.headers = headers
        self.body = body
        # streaming PUT bodies: the socket reader + declared length;
        # consumed tracks how much the handler actually drained
        self.stream = None
        self.content_length = len(body)
        self.stream_consumed = 0
        path, _, query = raw_path.partition("?")
        self.raw_path = path
        self.path = urllib.parse.unquote(path)
        self.query: dict[str, str] = {}
        self.raw_query = query
        for part in query.split("&") if query else ():
            k, _, v = part.partition("=")
            self.query[urllib.parse.unquote(k)] = urllib.parse.unquote(v)

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


# -- SigV4 (rgw_auth_s3.cc) -----------------------------------------------
def _sig_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(b"AWS4" + secret.encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _canonical_query(raw_query: str) -> str:
    pairs = []
    for part in raw_query.split("&") if raw_query else ():
        k, eq, v = part.partition("=")
        pairs.append((urllib.parse.unquote(k), urllib.parse.unquote(v)))
    enc = urllib.parse.quote
    return "&".join(
        f"{enc(k, safe='-_.~')}={enc(v, safe='-_.~')}"
        for k, v in sorted(pairs)
    )


def sigv4_string_to_sign(req: _Request, signed_headers: list[str],
                         scope: str, amz_date: str,
                         payload_hash: str | None = None,
                         raw_query: str | None = None) -> str:
    """The ONE SigV4 canonicalization (header auth, presigned
    verification, and URL generation all feed through here so the
    folding/quoting rules can never drift apart).  ``payload_hash``:
    presigned mode forces UNSIGNED-PAYLOAD; ``raw_query``: presigned
    verification signs the query minus X-Amz-Signature."""
    if payload_hash is None:
        payload_hash = req.header("x-amz-content-sha256")
        if payload_hash in ("", "UNSIGNED-PAYLOAD"):
            payload_hash = (payload_hash or
                            hashlib.sha256(req.body).hexdigest())
    canon_headers = "".join(
        f"{h}:{' '.join(req.header(h).split())}\n" for h in signed_headers
    )
    canon_uri = urllib.parse.quote(req.path, safe="/-_.~")
    canonical = "\n".join([
        req.method, canon_uri,
        _canonical_query(req.raw_query if raw_query is None
                         else raw_query),
        canon_headers, ";".join(signed_headers), payload_hash,
    ])
    return "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])


def _parse_scope_date(amz_date: str, cred_day: str) -> float:
    """x-amz-date -> epoch seconds, enforcing the credential-scope
    day match (shared by header auth and presigned verification)."""
    import calendar

    try:
        ts = calendar.timegm(time.strptime(amz_date,
                                           "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise _HTTPError(403, "AccessDenied", "bad x-amz-date")
    if amz_date[:8] != cred_day:
        raise _HTTPError(403, "SignatureDoesNotMatch",
                         "credential scope date mismatch")
    return ts


def presign_url(method: str, host: str, port: int, bucket: str,
                key: str, access_key: str, secret_key: str,
                expires: int = 3600, region: str = "us-east-1",
                session_token: str | None = None,
                amz_date: str | None = None) -> str:
    """Generate a presigned URL (the SDK generate_presigned_url /
    reference query-string auth role): anyone holding the URL can
    perform ``method`` on bucket/key until it expires.  The signature
    covers method, path, the X-Amz-* query parameters, and the host
    header; the payload is UNSIGNED-PAYLOAD, as presigned requests
    always are."""
    amz_date = amz_date or time.strftime("%Y%m%dT%H%M%SZ",
                                         time.gmtime())
    day = amz_date[:8]
    scope = f"{day}/{region}/s3/aws4_request"
    path = "/" + "/".join(
        urllib.parse.quote(seg, safe="-_.~")
        for seg in f"{bucket}/{key}".split("/"))
    host_hdr = f"{host}:{port}"
    params = [
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(int(expires))),
        ("X-Amz-SignedHeaders", "host"),
    ]
    if session_token is not None:
        params.append(("X-Amz-Security-Token", session_token))
    enc = urllib.parse.quote
    query = "&".join(f"{enc(k, safe='-_.~')}={enc(v, safe='-_.~')}"
                     for k, v in sorted(params))
    req = _Request(method, f"{path}?{query}",
                   {"host": host_hdr}, b"")
    sts = sigv4_string_to_sign(req, ["host"], scope, amz_date,
                               payload_hash="UNSIGNED-PAYLOAD")
    sig = hmac.new(_sig_key(secret_key, day, region, "s3"),
                   sts.encode(), hashlib.sha256).hexdigest()
    return (f"http://{host_hdr}{path}?{query}"
            f"&X-Amz-Signature={sig}")


def sigv4_sign(req: _Request, access_key: str, secret_key: str,
               region: str = "us-east-1") -> str:
    """Produce the Authorization header a stock SDK would (the client
    half; the frontend verifies with the same canonicalization)."""
    amz_date = req.header("x-amz-date")
    day = amz_date[:8]
    scope = f"{day}/{region}/s3/aws4_request"
    signed = sorted(h for h in req.headers
                    if h == "host" or h.startswith("x-amz-"))
    sts = sigv4_string_to_sign(req, signed, scope, amz_date)
    sig = hmac.new(_sig_key(secret_key, day, region, "s3"),
                   sts.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


class S3Frontend:
    """One listening S3 endpoint over an RGWLite handle."""

    def __init__(self, rgw: RGWLite, users: RGWUsers | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 region: str = "us-east-1",
                 system_users: frozenset[str] = frozenset()):
        self.rgw = rgw
        self.users = users if users is not None else rgw.users
        self.host = host
        self.port = port
        self.region = region
        self.system_users = system_users
        self._server: asyncio.AbstractServer | None = None
        self._reqid = 0
        # bucket -> (fetched_at, cors rules): decoration must not
        # double bucket-meta reads on every Origin-bearing request
        self._cors_cache: dict[str, tuple[float, list]] = {}
        # QoS admission control (the front-door actuator of the
        # defense plane): requests in flight behind the gate + one
        # token bucket per session (access key); conf is read live so
        # the knobs retune without a frontend restart
        self._inflight = 0
        self._buckets: dict[str, TokenBucket] = {}

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._client, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.dout(1, "s3 frontend on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # push workers outliving the rados client would loop against a
        # shut-down connection (warnings + racing teardown writes)
        await self.rgw.stop_push()

    # -- connection loop ---------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except _HTTPError as e:
                    status, headers, body = self._error(
                        e.status, e.code, e.msg)
                    stub = _Request("GET", "/", {}, b"")
                    await self._respond(writer, stub, status, headers,
                                        body, keep=False)
                    break
                if req is None:
                    break
                keep = req.header("connection", "keep-alive") != "close"
                if req.stream is not None:
                    # default pessimistic: only a fully drained body
                    # leaves the socket reusable
                    keep_after_stream = keep
                    keep = False
                shed = self._admission(req)
                if shed is not None:
                    # overload sheds at the front door, before any
                    # RADOS work: 503 Slow Down + Retry-After.  A
                    # streamed body was never drained, so the socket
                    # cannot be reused
                    status, headers, body = shed
                    await self._respond(writer, req, status, headers,
                                        body, keep)
                    if not keep:
                        break
                    continue
                self._inflight += 1
                try:
                    with self._class_ctx(req):
                        status, headers, body = await self._route(req)
                except _HTTPError as e:
                    status, headers, body = self._error(e.status, e.code,
                                                        e.msg)
                except RGWError as e:
                    status, headers, body = self._error(
                        _STATUS.get(e.code, 400), e.code, str(e)
                    )
                except (ValueError, ET.ParseError) as e:
                    # malformed numbers/XML/params from the client:
                    # a 400, never a dropped connection
                    status, headers, body = self._error(
                        400, "InvalidArgument", str(e))
                except Exception as e:     # noqa: BLE001 — serve 500
                    log.dout(1, "request failed: %r", e)
                    status, headers, body = self._error(
                        500, "InternalError", type(e).__name__)
                finally:
                    self._inflight -= 1
                if req.stream is not None and \
                        req.stream_consumed >= req.content_length:
                    keep = keep_after_stream
                if req.header("origin"):
                    headers = {**headers,
                               **await self._cors_headers(req)}
                await self._respond(writer, req, status, headers, body,
                                    keep)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self,
                            reader: asyncio.StreamReader
                            ) -> _Request | None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, raw_path, _version = lines[0].split(" ", 2)
        except ValueError:
            raise _HTTPError(400, "InvalidRequest", "bad request line")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise _HTTPError(400, "InvalidArgument", "bad content-length")
        if length < 0:
            raise _HTTPError(400, "InvalidArgument", "bad content-length")
        req = _Request(method.upper(), raw_path, headers, b"")
        req.content_length = length
        if self._should_stream(req, length):
            # body stays on the socket; the object handler drains it
            # chunk by chunk into RGWLite (no whole-body buffering)
            req.stream = reader
            return req
        if length > _MAX_BODY:
            # bound only BUFFERED bodies (non-streamable requests);
            # large uploads ride the streaming path or multipart
            raise _HTTPError(400, "EntityTooLarge", str(length))
        req.body = await reader.readexactly(length) if length else b""
        return req

    @staticmethod
    def _should_stream(req: _Request, length: int) -> bool:
        """Plain object PUTs with a declared payload hash stream; the
        hash header is required so SigV4 verifies from headers alone
        and the body sha256 is enforced incrementally."""
        if req.method != "PUT" or length < _STREAM_MIN:
            return False
        if not req.header("x-amz-content-sha256"):
            return False
        parts = req.path.lstrip("/").split("/", 1)
        if len(parts) < 2 or not parts[1]:
            return False                # not an object-level request
        blocked = {"partNumber", "uploadId", "acl", "versioning",
                   "lifecycle", "tagging", "notification", "delete",
                   "retention", "legal-hold", "object-lock"}
        if blocked & set(req.query):
            return False
        if req.header("x-amz-copy-source"):
            return False
        return True

    async def _respond(self, writer: asyncio.StreamWriter, req: _Request,
                       status: int, headers: dict, body,
                       keep: bool) -> None:
        self._reqid += 1
        reason = {200: "OK", 204: "No Content", 206: "Partial Content",
                  403: "Forbidden", 404: "Not Found",
                  503: "Slow Down"}.get(status, "S3")
        out = [f"HTTP/1.1 {status} {reason}"]
        streaming = not isinstance(body, (bytes, bytearray))
        base = {
            "x-amz-request-id": f"{self._reqid:016x}",
            "date": formatdate(usegmt=True),
            "connection": "keep-alive" if keep else "close",
        }
        if not streaming:
            base["content-length"] = str(len(body))
        base.update(headers)    # streaming callers set content-length
        for k, v in base.items():
            out.append(f"{k}: {v}")
        head = "\r\n".join(out).encode("latin-1") + b"\r\n\r\n"
        writer.write(head)
        if req.method != "HEAD":
            if streaming:
                # async-generator body: chunks flow straight from RADOS
                # to the socket, never materializing the whole object
                try:
                    async for chunk in body:
                        writer.write(chunk)
                        await writer.drain()
                except (ConnectionError, asyncio.IncompleteReadError):
                    raise
                except Exception as e:     # noqa: BLE001
                    # backend failure mid-stream: the status line is
                    # gone, so the only honest signal is a truncated
                    # body + closed connection (what beast does too)
                    log.derr("streaming GET aborted: %r", e)
                    await body.aclose()
                    raise ConnectionError("stream aborted") from e
            else:
                writer.write(bytes(body))
        await writer.drain()

    @staticmethod
    def _error(status: int, code: str, msg: str = ""):
        root = ET.Element("Error")
        ET.SubElement(root, "Code").text = code
        ET.SubElement(root, "Message").text = msg
        body = ET.tostring(root, xml_declaration=True,
                           encoding="unicode").encode()
        return status, {"content-type": "application/xml"}, body

    # -- QoS admission control (front-door defense plane) -----------------
    def _qos_conf(self):
        """(max_inflight, session_rate, burst, retry_after) read live
        from conf — 0/0 disables both gates (the default)."""
        try:
            conf = self.rgw.ioctx.rados.conf
            return (int(conf["rgw_max_inflight"]),
                    float(conf["rgw_session_ops_per_s"]),
                    float(conf["rgw_session_burst"]),
                    float(conf["rgw_retry_after_s"]))
        except (AttributeError, KeyError, TypeError, ValueError):
            return 0, 0.0, 8.0, 1.0

    @staticmethod
    def _session_key(req: _Request) -> str:
        """Throttle identity: the access key from the SigV4 header or
        presigned query (cheap string parse, no verification — a shed
        request never reaches auth)."""
        auth = req.header("authorization")
        marker = "Credential="
        i = auth.find(marker)
        if i >= 0:
            cred = auth[i + len(marker):]
            return cred.split("/", 1)[0].split(",", 1)[0]
        cred = req.query.get("X-Amz-Credential", "")
        if cred:
            return cred.split("/", 1)[0]
        return "anonymous"

    def _tenant_class(self, req: _Request) -> str:
        """Tenant class for this request: ``slo_class_map`` access-key
        assignment, defaulting to the LAST ``slo_class_labels`` label
        (bronze) for unmapped keys.  The class rides the rados qclass
        contextvar into per-class OSD latency histograms — the S3-side
        half of the attribution plane (in-process rados clients stamp
        themselves via loadgen's tenant_class)."""
        import re as _re
        try:
            conf = self.rgw.ioctx.rados.conf
            labels = [lbl.strip() for lbl in
                      str(conf["slo_class_labels"] or "").split(",")
                      if lbl.strip()]
            spec = str(conf["slo_class_map"] or "")
        except (AttributeError, KeyError, TypeError):
            return ""
        if not labels:
            return ""
        mapping = {}
        for part in _re.split(r"[,\s]+", spec.strip()):
            if part and "=" in part:
                k, _, v = part.partition("=")
                mapping[k.strip()] = v.strip()
        cls = mapping.get(self._session_key(req), labels[-1])
        return cls if cls in labels else labels[-1]

    def _class_ctx(self, req: _Request):
        cls = self._tenant_class(req)
        if not cls:
            import contextlib
            return contextlib.nullcontext()
        from ceph_tpu_torch.client.rados import op_class
        return op_class(cls)

    def _admission(self, req: _Request):
        """Queue-depth gate + per-session token bucket.  Returns a
        ready 503 Slow Down response tuple when the request sheds,
        None when admitted."""
        max_inflight, rate, burst, retry = self._qos_conf()
        if max_inflight <= 0 and rate <= 0:
            return None
        if max_inflight > 0 and self._inflight >= max_inflight:
            return self._shed(req, "inflight", retry)
        if rate > 0:
            now = asyncio.get_running_loop().time()
            key = self._session_key(req)
            bucket = self._buckets.get(key)
            if bucket is None or bucket.rate != rate:
                bucket = self._buckets[key] = TokenBucket(
                    rate, burst, now)
            if not bucket.take(now):
                return self._shed(req, "session",
                                  max(retry, bucket.retry_after()),
                                  session=key)
        self.rgw.qos_stats["admitted"] += 1
        return None

    def _shed(self, req: _Request, reason: str, retry_after: float,
              session: str = ""):
        self.rgw.qos_stats[f"shed_{reason}"] = \
            self.rgw.qos_stats.get(f"shed_{reason}", 0) + 1
        emit_proc("qos.shed", reason=reason, method=req.method,
                  path=req.path, session=session,
                  inflight=self._inflight)
        log.dout(5, "shed %s %s (%s): 503 Slow Down",
                 req.method, req.path, reason)
        status, headers, body = self._error(
            503, "SlowDown", "please reduce your request rate")
        headers = {**headers,
                   "retry-after": str(max(1, int(round(retry_after))))}
        return status, headers, body

    # -- auth (rgw_auth_s3.cc) --------------------------------------------
    async def _identify(self, req: _Request) -> str:
        auth = req.header("authorization")
        if not auth:
            if req.query.get("X-Amz-Algorithm") \
                    == "AWS4-HMAC-SHA256":
                return await self._identify_presigned(req)
            return ANONYMOUS
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            raise _HTTPError(400, "InvalidArgument", "unsupported auth")
        fields = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        try:
            cred = fields["Credential"].split("/")
            access_key, day, region = cred[0], cred[1], cred[2]
            signed = fields["SignedHeaders"].split(";")
            their_sig = fields["Signature"]
        except (KeyError, IndexError):
            raise _HTTPError(400, "InvalidArgument", "malformed auth")
        if self.users is None:
            raise _HTTPError(403, "InvalidAccessKeyId", access_key)
        amz_date = req.header("x-amz-date")
        self._check_request_time(amz_date, day)
        uid, secret, session_token = await self._lookup_key(access_key)
        if session_token is not None and not hmac.compare_digest(
                session_token, req.header("x-amz-security-token")):
            # STS credentials are only valid with their session token
            # (reference rgw_sts.cc session validation)
            raise _HTTPError(403, "InvalidToken", access_key)
        scope = f"{day}/{region}/s3/aws4_request"
        sts = sigv4_string_to_sign(req, signed, scope, amz_date)
        want = hmac.new(_sig_key(secret, day, region, "s3"),
                        sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, their_sig):
            raise _HTTPError(403, "SignatureDoesNotMatch", access_key)
        declared = req.header("x-amz-content-sha256")
        if req.stream is None and declared and \
                declared != "UNSIGNED-PAYLOAD" and \
                declared != hashlib.sha256(req.body).hexdigest():
            # a valid signature over a LIED-ABOUT payload hash must
            # not authorize the actual body (replay/tamper guard)
            raise _HTTPError(400, "XAmzContentSHA256Mismatch",
                             "payload hash mismatch")
        return uid

    async def _identify_presigned(self, req: _Request) -> str:
        """Query-string (presigned URL) SigV4 auth — reference
        rgw_auth_s3.cc query-string mode: the signature rides the
        query parameters, the payload is UNSIGNED, and validity is
        bounded by X-Amz-Date + X-Amz-Expires instead of the clock
        skew alone."""
        q = req.query
        try:
            cred = q["X-Amz-Credential"].split("/")
            access_key, day, region = cred[0], cred[1], cred[2]
            amz_date = q["X-Amz-Date"]
            expires = int(q["X-Amz-Expires"])
            signed = q["X-Amz-SignedHeaders"].split(";")
            their_sig = q["X-Amz-Signature"]
        except (KeyError, IndexError, ValueError):
            raise _HTTPError(400, "InvalidArgument",
                             "malformed presigned query")
        if not 1 <= expires <= 604800:
            raise _HTTPError(400, "InvalidArgument",
                             "X-Amz-Expires out of range")
        ts = _parse_scope_date(amz_date, day)
        now = time.time()
        if now > ts + expires:
            raise _HTTPError(403, "AccessDenied",
                             "Request has expired")
        if ts > now + self._SKEW_S:
            raise _HTTPError(403, "RequestTimeTooSkewed", amz_date)
        if self.users is None:
            raise _HTTPError(403, "InvalidAccessKeyId", access_key)
        uid, secret, session_token = await self._lookup_key(access_key)
        if session_token is not None and not hmac.compare_digest(
                session_token, q.get("X-Amz-Security-Token", "")):
            raise _HTTPError(403, "InvalidToken", access_key)
        scope = f"{day}/{region}/s3/aws4_request"
        # the canonical query is everything EXCEPT the signature
        sts = sigv4_string_to_sign(
            req, signed, scope, amz_date,
            payload_hash="UNSIGNED-PAYLOAD",
            raw_query="&".join(
                part for part in req.raw_query.split("&")
                if not part.startswith("X-Amz-Signature=")))
        want = hmac.new(_sig_key(secret, day, region, "s3"),
                        sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, their_sig):
            raise _HTTPError(403, "SignatureDoesNotMatch", access_key)
        return uid

    # Reference rgw_auth_s3.cc rejects requests whose signed timestamp
    # drifts more than RGW_AUTH_GRACE (15 min) from the server clock —
    # without this a captured signed request replays forever.
    _SKEW_S = 15 * 60

    def _check_request_time(self, amz_date: str, cred_day: str) -> None:
        ts = _parse_scope_date(amz_date, cred_day)
        if abs(time.time() - ts) > self._SKEW_S:
            raise _HTTPError(403, "RequestTimeTooSkewed", amz_date)

    async def _lookup_key(self, access_key: str
                          ) -> tuple[str, str, str | None]:
        """(uid, signing secret, required session token or None):
        permanent keys resolve through the user db, STS temp keys
        through the time-bounded credential table."""
        from ceph_tpu_torch.services.rgw import KEYS_OID
        from ceph_tpu_torch.client.rados import RadosError

        try:
            kv = await self.users.ioctx.get_omap(KEYS_OID, [access_key])
        except RadosError as e:
            if e.rc == -2:
                kv = {}
            else:
                raise
        if access_key not in kv:
            sts_rec = await self.users.sts_get(access_key)
            if sts_rec is None:
                raise _HTTPError(403, "InvalidAccessKeyId", access_key)
            rec = await self.users.get(sts_rec["uid"])
            if rec.get("suspended"):
                raise _HTTPError(403, "AccessDenied",
                                 f"{sts_rec['uid']} suspended")
            return (sts_rec["uid"], sts_rec["secret_key"],
                    sts_rec["session_token"])
        uid = kv[access_key].decode()
        rec = await self.users.get(uid)
        if rec.get("suspended"):
            raise _HTTPError(403, "AccessDenied", f"{uid} suspended")
        return uid, rec["secret_key"], None

    # -- CORS (rgw_cors.cc: preflight + response decoration) --------------
    async def _bucket_cors_rules(self, bucket: str) -> list[dict]:
        """The bucket's CORS rules via the system context — CORS
        evaluation is configuration, not an authorized data access
        (preflights are unsigned by design).  A 1s TTL cache keeps
        the decoration hook from doubling bucket-meta reads on every
        Origin-bearing request."""
        from ceph_tpu_torch.client.rados import RadosError

        if not bucket:
            return []
        hit = self._cors_cache.get(bucket)
        now = time.monotonic()
        if hit is not None and now - hit[0] < 1.0:
            return hit[1]
        try:
            meta = await self.rgw._bucket_meta(bucket)
            rules = meta.get("cors") or []
        except (RGWError, RadosError):
            rules = []
        self._cors_cache[bucket] = (now, rules)
        if len(self._cors_cache) > 4096:
            self._cors_cache.clear()
        return rules

    async def _cors_rule(self, req: _Request,
                         method: str) -> tuple[dict | None, dict]:
        """(matched rule, base response headers) for the request's
        bucket + Origin — the one lookup both the preflight and the
        response decoration share."""
        origin = req.header("origin")
        if not origin:
            return None, {}      # no Origin, no CORS evaluation
        bucket = req.path.lstrip("/").split("/", 1)[0]
        rules = await self._bucket_cors_rules(bucket)
        rule = RGWLite.cors_match(rules, origin, method)
        if rule is None:
            return None, {}
        base = {"vary": "Origin"}
        # the credentials grant keys off WHICH pattern matched: only
        # a NON-wildcard pattern may echo the origin with
        # allow-credentials (wildcard + credentials is the exact
        # combination the browser * ban exists to prevent)
        if any(p != "*" and RGWLite._cors_pattern_ok(p, origin)
               for p in rule.get("allowed_origins", ())):
            base["access-control-allow-origin"] = origin
            base["access-control-allow-credentials"] = "true"
        else:
            base["access-control-allow-origin"] = "*"
        return rule, base

    async def _cors_headers(self, req: _Request) -> dict[str, str]:
        if req.method == "OPTIONS":
            return {}     # the preflight handler already decorated
        rule, out = await self._cors_rule(req, req.method)
        if rule is None:
            return {}
        if rule.get("expose_headers"):
            out["access-control-expose-headers"] = \
                ",".join(rule["expose_headers"])
        return out

    async def _preflight(self, req: _Request):
        """OPTIONS preflight (RGWOp_CORS): match Origin + requested
        method against the bucket's rules; never authenticated."""
        origin = req.header("origin")
        want = req.header("access-control-request-method")
        if not origin or not want:
            raise _HTTPError(400, "InvalidArgument",
                             "preflight needs Origin + "
                             "Access-Control-Request-Method")
        rule, headers = await self._cors_rule(req, want)
        if rule is None:
            raise _HTTPError(403, "AccessDenied", "CORSResponse: no "
                             "matching rule")
        headers["access-control-allow-methods"] = \
            ",".join(rule["allowed_methods"])
        want_headers = req.header("access-control-request-headers")
        if want_headers:
            grant = RGWLite.cors_header_grant(
                rule, [h.strip() for h in want_headers.split(",")
                       if h.strip()])
            if grant is None:
                # a disallowed requested header fails the WHOLE
                # preflight (S3 semantics) — a silent subset grant
                # would still be rejected by the browser, opaquely
                raise _HTTPError(403, "AccessDenied",
                                 "CORSResponse: header not allowed")
            headers["access-control-allow-headers"] = ",".join(grant)
        if rule.get("max_age_seconds") is not None:
            headers["access-control-max-age"] = \
                str(rule["max_age_seconds"])
        return 200, headers, b""

    # -- routing (rgw_rest_s3.cc RGWHandler_REST_S3) ----------------------
    async def _route(self, req: _Request):
        if req.method == "OPTIONS":
            return await self._preflight(req)
        uid = await self._identify(req)
        gw = self.rgw.as_user(None if uid in self.system_users
                              else uid)
        parts = req.path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        if uid == ANONYMOUS and bucket and not req.query \
                and req.method in ("GET", "HEAD"):
            web = await self._maybe_website(req, gw, bucket, key)
            if web is not None:
                return web
        if bucket == "admin":
            return await self._admin(req, uid, key)
        if not bucket:
            return await self._service(req, gw)
        if not key:
            return await self._bucket(req, gw, bucket)
        return await self._object(req, gw, bucket, key)

    # -- admin ops API (reference RGWRESTMgr_Admin: /admin/user,
    # /admin/bucket, /admin/usage, /admin/metadata/*) ------------------
    async def _admin(self, req: _Request, uid: str, sub: str):
        """The radosgw admin ops REST surface: JSON in/out, reachable
        only by SYSTEM users (the reference gates on the user's
        system flag)."""
        import json as _json

        if uid not in self.system_users:
            raise _HTTPError(403, "AccessDenied",
                             "admin API requires a system user")

        def jout(status: int, data) -> tuple[int, dict, bytes]:
            body = _json.dumps(data, default=str).encode()
            return status, {"content-type": "application/json"}, body

        q = req.query
        gw = self.rgw.as_user(None)
        if sub == "user":
            tuid = q.get("uid", "")
            if req.method == "GET":
                if not tuid:
                    return jout(200, await self.users.list())
                return jout(200, await self.users.get(tuid))
            if req.method == "PUT":
                rec = await self.users.create(
                    tuid, q.get("display-name", ""),
                    max_size=int(q.get("max-size", 0) or 0),
                    max_objects=int(q.get("max-objects", 0) or 0))
                return jout(201, rec)
            if req.method == "POST":
                if "suspended" in q:
                    await self.users.set_suspended(
                        tuid, q["suspended"] in ("1", "true", "True"))
                if "max-size" in q or "max-objects" in q:
                    await self.users.set_quota(
                        tuid,
                        max_size=int(q.get("max-size", 0) or 0),
                        max_objects=int(q.get("max-objects", 0) or 0))
                return jout(200, await self.users.get(tuid))
            if req.method == "DELETE":
                await self.users.remove(tuid)
                return jout(200, {"removed": tuid})
        elif sub == "bucket":
            tb = q.get("bucket", "")
            if req.method == "GET":
                if not tb:
                    return jout(200, await gw.list_buckets())
                meta = await gw._bucket_meta(tb)
                nbytes, nobj = await gw._bucket_usage(tb)
                return jout(200, {
                    "bucket": tb, "owner": meta.get("owner", ""),
                    "num_objects": nobj, "size_bytes": nbytes,
                    "index_shards": int(meta.get("index_shards", 1)),
                    "versioning": meta.get("versioning", ""),
                })
            if req.method == "DELETE":
                await gw.delete_bucket(tb)
                return jout(200, {"removed": tb})
        elif sub == "usage":
            if req.method == "GET":
                out = {}
                for b in await gw.list_buckets():
                    try:
                        meta = await gw._bucket_meta(b)
                        nbytes, nobj = await gw._bucket_usage(b)
                    except RGWError:
                        continue
                    u = out.setdefault(meta.get("owner", ""), {
                        "buckets": 0, "objects": 0, "bytes": 0})
                    u["buckets"] += 1
                    u["objects"] += nobj
                    u["bytes"] += nbytes
                return jout(200, out)
        elif sub.startswith("metadata"):
            # rgw_rest_metadata.h: enumerate metadata entries by type
            mtype = sub.partition("/")[2] or q.get("type", "")
            if req.method == "GET":
                if mtype == "user":
                    return jout(200, await self.users.list())
                if mtype == "bucket":
                    return jout(200, await gw.list_buckets())
                return jout(200, ["user", "bucket"])
        raise _HTTPError(405, "MethodNotAllowed",
                         f"{req.method} /admin/{sub}")

    async def _maybe_website(self, req: _Request, gw: RGWLite,
                             bucket: str, key: str):
        """Static-website semantics for anonymous browsers on a
        website-configured bucket (rgw_website.cc): directory paths
        resolve to the index document, missing keys to the error
        document (served WITH a 404).  None = not a website bucket,
        fall through to plain S3 handling."""
        try:
            cfg = (await gw._bucket_meta(bucket)).get("website")
        except RGWError:
            return None
        if not cfg:
            return None
        want = key
        if not want or want.endswith("/"):
            want = want + cfg["index"]
        try:
            got = await gw.get_object(bucket, want)
            return 200, _obj_headers(got), (
                b"" if req.method == "HEAD" else got["data"])
        except RGWError as e:
            if e.code not in ("NoSuchKey", "AccessDenied"):
                raise
        err_key = cfg.get("error")
        if err_key:
            try:
                got = await gw.get_object(bucket, err_key)
                return 404, _obj_headers(got), (
                    b"" if req.method == "HEAD" else got["data"])
            except RGWError:
                pass
        raise _HTTPError(404, "NoSuchKey", want)

    async def _service(self, req: _Request, gw: RGWLite):
        if req.method != "GET":
            raise _HTTPError(405, "MethodNotAllowed", req.method)
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = gw.user or "admin"
        buckets = ET.SubElement(root, "Buckets")
        for name in await gw.list_buckets():
            try:
                meta = await gw._check_bucket(name, "READ")
            except RGWError:
                continue                 # not ours / not readable
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = name
            ET.SubElement(b, "CreationDate").text = _iso(
                meta.get("created", 0.0))
        return self._xml(root)

    async def _bucket(self, req: _Request, gw: RGWLite, bucket: str):
        q = req.query
        if req.method == "PUT":
            if "versioning" in q:
                cfg = ET.fromstring(req.body.decode() or
                                    "<VersioningConfiguration/>")
                status = cfg.findtext(_ns("Status"), default="",
                                      namespaces=None) or \
                    cfg.findtext("Status", default="")
                await gw.put_bucket_versioning(bucket,
                                               status == "Enabled")
                return 200, {}, b""
            if "lifecycle" in q:
                rules = _parse_lifecycle(req.body)
                await gw.put_lifecycle(bucket, rules)
                return 200, {}, b""
            if "policy" in q:
                # PutBucketPolicy: the body is the JSON document
                # itself; bytes go straight to validate (a non-UTF-8
                # body is MalformedPolicy, not a decode crash)
                await gw.put_bucket_policy(bucket, req.body)
                return 204, {}, b""
            if "acl" in q:
                canned = req.header("x-amz-acl", "private")
                await gw.put_bucket_acl(bucket, canned)
                return 200, {}, b""
            if "cors" in q:
                await gw.put_bucket_cors(bucket,
                                         _parse_cors(req.body))
                self._cors_cache.pop(bucket, None)
                return 200, {}, b""
            if "notification" in q:
                # S3 PutBucketNotificationConfiguration REPLACES the
                # whole document (an empty one disables notifications)
                cfg = ET.fromstring(req.body.decode() or
                                    "<NotificationConfiguration/>")
                configs = []
                for tc in (list(cfg.findall(_ns("TopicConfiguration")))
                           or list(cfg.findall("TopicConfiguration"))):
                    topic = (tc.findtext(_ns("Topic"))
                             or tc.findtext("Topic") or "")
                    topic = topic.rsplit(":", 1)[-1]     # arn -> name
                    events = [e.text for e in
                              (tc.findall(_ns("Event"))
                               or tc.findall("Event")) if e.text]
                    if topic:
                        configs.append({"topic": topic,
                                        "events": events})
                await gw.set_bucket_notifications(bucket, configs)
                return 200, {}, b""
            if "object-lock" in q:
                mode, days, years = _parse_lock_config(req.body)
                await gw.put_object_lock_config(bucket, mode,
                                                days=days,
                                                years=years)
                return 200, {}, b""
            if "website" in q:
                doc = ET.fromstring(req.body.decode())
                idx = (doc.findtext(f"{_ns('IndexDocument')}"
                                    f"/{_ns('Suffix')}")
                       or doc.findtext("IndexDocument/Suffix") or "")
                err = (doc.findtext(f"{_ns('ErrorDocument')}"
                                    f"/{_ns('Key')}")
                       or doc.findtext("ErrorDocument/Key") or "")
                await gw.put_bucket_website(bucket, idx, err)
                return 200, {}, b""
            await gw.create_bucket(bucket, object_lock=req.header(
                "x-amz-bucket-object-lock-enabled",
                "").lower() == "true")
            return 200, {"location": f"/{bucket}"}, b""
        if req.method == "DELETE":
            if "cors" in q:
                await gw.delete_bucket_cors(bucket)
                self._cors_cache.pop(bucket, None)
                return 204, {}, b""
            if "lifecycle" in q:
                await gw.delete_lifecycle(bucket)
                return 204, {}, b""
            if "policy" in q:
                await gw.delete_bucket_policy(bucket)
                return 204, {}, b""
            if "website" in q:
                await gw.delete_bucket_website(bucket)
                return 204, {}, b""
            await gw.delete_bucket(bucket)
            return 204, {}, b""
        if req.method == "HEAD":
            # S3 HeadBucket requires s3:ListBucket
            await gw._check_bucket(bucket, "READ",
                                   action="s3:ListBucket")
            return 200, {}, b""
        if req.method == "POST" and "delete" in q:
            return await self._bulk_delete(req, gw, bucket)
        if req.method != "GET":
            raise _HTTPError(405, "MethodNotAllowed", req.method)
        if "cors" in q:
            rules = await gw.get_bucket_cors(bucket)
            root = ET.Element("CORSConfiguration", xmlns=XMLNS)
            for rule in rules:
                r = ET.SubElement(root, "CORSRule")
                for o in rule.get("allowed_origins", ()):
                    ET.SubElement(r, "AllowedOrigin").text = o
                for m in rule.get("allowed_methods", ()):
                    ET.SubElement(r, "AllowedMethod").text = m
                for h in rule.get("allowed_headers", ()):
                    ET.SubElement(r, "AllowedHeader").text = h
                for h in rule.get("expose_headers", ()):
                    ET.SubElement(r, "ExposeHeader").text = h
                if rule.get("max_age_seconds") is not None:
                    ET.SubElement(r, "MaxAgeSeconds").text = \
                        str(rule["max_age_seconds"])
            return self._xml(root)
        if "versioning" in q:
            state = await gw.get_bucket_versioning(bucket)
            root = ET.Element("VersioningConfiguration", xmlns=XMLNS)
            if state:
                ET.SubElement(root, "Status").text = \
                    "Enabled" if state == "enabled" else "Suspended"
            return self._xml(root)
        if "versions" in q:
            return await self._list_versions(req, gw, bucket)
        if "uploads" in q:
            root = ET.Element("ListMultipartUploadsResult", xmlns=XMLNS)
            ET.SubElement(root, "Bucket").text = bucket
            for up in await gw.list_multipart_uploads(bucket):
                u = ET.SubElement(root, "Upload")
                ET.SubElement(u, "Key").text = up["key"]
                ET.SubElement(u, "UploadId").text = up["upload_id"]
            return self._xml(root)
        if "website" in q:
            cfg = await gw.get_bucket_website(bucket)
            root = ET.Element("WebsiteConfiguration", xmlns=XMLNS)
            idx = ET.SubElement(root, "IndexDocument")
            ET.SubElement(idx, "Suffix").text = cfg["index"]
            if cfg.get("error"):
                err = ET.SubElement(root, "ErrorDocument")
                ET.SubElement(err, "Key").text = cfg["error"]
            return self._xml(root)
        if "object-lock" in q:
            cfg = await gw.get_object_lock_config(bucket)
            root = ET.Element("ObjectLockConfiguration", xmlns=XMLNS)
            ET.SubElement(root, "ObjectLockEnabled").text = "Enabled"
            if cfg.get("mode"):
                rule = ET.SubElement(root, "Rule")
                dr = ET.SubElement(rule, "DefaultRetention")
                ET.SubElement(dr, "Mode").text = cfg["mode"]
                if cfg.get("days"):
                    ET.SubElement(dr, "Days").text = str(cfg["days"])
                if cfg.get("years"):
                    ET.SubElement(dr, "Years").text = \
                        str(cfg["years"])
            return self._xml(root)
        if "lifecycle" in q:
            rules = await gw.get_lifecycle(bucket)
            if not rules:
                raise _HTTPError(404, "NoSuchLifecycleConfiguration",
                                 bucket)
            root = ET.Element("LifecycleConfiguration", xmlns=XMLNS)
            for rule in rules:
                r = ET.SubElement(root, "Rule")
                ET.SubElement(r, "ID").text = rule.get("id", "")
                ET.SubElement(r, "Prefix").text = rule.get("prefix", "")
                ET.SubElement(r, "Status").text = \
                    rule.get("status", "Enabled")
                for kind, outer, inner in (
                        ("expiration", "Expiration", "Days"),
                        ("noncurrent",
                         "NoncurrentVersionExpiration",
                         "NoncurrentDays"),
                        ("abort_mpu",
                         "AbortIncompleteMultipartUpload",
                         "DaysAfterInitiation")):
                    if f"{kind}_days" in rule:
                        days = int(rule[f"{kind}_days"])
                    elif f"{kind}_seconds" in rule:
                        # S3 XML has no seconds granularity: round a
                        # store-API seconds rule UP to whole days so
                        # the emitted document stays valid and
                        # re-PUTtable (never sharper than the rule)
                        days = max(1, math.ceil(
                            float(rule[f"{kind}_seconds"]) / 86400))
                    else:
                        continue
                    e = ET.SubElement(r, outer)
                    ET.SubElement(e, inner).text = str(days)
                for kind, outer, inner in (
                        ("transition", "Transition", "Days"),
                        ("noncurrent_transition",
                         "NoncurrentVersionTransition",
                         "NoncurrentDays")):
                    cls = rule.get(f"{kind}_class")
                    if not cls:
                        continue
                    if f"{kind}_days" in rule:
                        days = int(rule[f"{kind}_days"])
                    elif f"{kind}_seconds" in rule:
                        days = max(1, math.ceil(
                            float(rule[f"{kind}_seconds"]) / 86400))
                    else:
                        continue
                    e = ET.SubElement(r, outer)
                    ET.SubElement(e, inner).text = str(days)
                    ET.SubElement(e, "StorageClass").text = cls
                if rule.get("tags"):
                    flt = ET.SubElement(r, "Filter")
                    holder = (ET.SubElement(flt, "And")
                              if len(rule["tags"]) > 1 else flt)
                    for k, v in sorted(rule["tags"].items()):
                        t = ET.SubElement(holder, "Tag")
                        ET.SubElement(t, "Key").text = k
                        ET.SubElement(t, "Value").text = v
            return self._xml(root)
        if "notification" in q:
            cfgs = await gw.get_bucket_notification(bucket)
            root = ET.Element("NotificationConfiguration", xmlns=XMLNS)
            for c in cfgs:
                tc = ET.SubElement(root, "TopicConfiguration")
                ET.SubElement(tc, "Topic").text = \
                    f"arn:aws:sns:::{c['topic']}"
                for e in c.get("events", ()):
                    ET.SubElement(tc, "Event").text = e
            return self._xml(root)
        if "policy" in q:
            import json as _json

            policy = await gw.get_bucket_policy(bucket)
            return 200, {"content-type": "application/json"}, \
                _json.dumps(policy).encode()
        if "acl" in q:
            acl = await gw.get_bucket_acl(bucket)
            root = ET.Element("AccessControlPolicy", xmlns=XMLNS)
            ET.SubElement(ET.SubElement(root, "Owner"), "ID").text = \
                acl.get("owner", "")
            ET.SubElement(root, "CannedACL").text = \
                acl.get("canned", "private")
            return self._xml(root)
        return await self._list_objects(req, gw, bucket)

    async def _list_objects(self, req: _Request, gw: RGWLite,
                            bucket: str):
        q = req.query
        v2 = q.get("list-type") == "2"
        marker = q.get("continuation-token" if v2 else "marker", "") or \
            q.get("start-after", "")
        max_keys = int(q.get("max-keys", "1000"))
        listing = await gw.list_objects(
            bucket, prefix=q.get("prefix", ""), marker=marker,
            max_keys=max_keys, delimiter=q.get("delimiter", ""),
        )
        root = ET.Element("ListBucketResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = q.get("prefix", "")
        if q.get("delimiter"):
            ET.SubElement(root, "Delimiter").text = q["delimiter"]
        for cp in listing.get("common_prefixes", ()):
            e = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(e, "Prefix").text = cp
        ET.SubElement(root, "IsTruncated").text = \
            "true" if listing["is_truncated"] else "false"
        ET.SubElement(root, "KeyCount" if v2 else "MaxKeys").text = \
            str(len(listing["contents"])
                + len(listing.get("common_prefixes", ()))
                if v2 else max_keys)
        if listing["is_truncated"]:
            tag = "NextContinuationToken" if v2 else "NextMarker"
            ET.SubElement(root, tag).text = listing["next_marker"]
        for c in listing["contents"]:
            e = ET.SubElement(root, "Contents")
            ET.SubElement(e, "Key").text = c["key"]
            ET.SubElement(e, "Size").text = str(c["size"])
            ET.SubElement(e, "ETag").text = f'"{c["etag"]}"'
            ET.SubElement(e, "LastModified").text = _iso(c["mtime"])
            ET.SubElement(e, "StorageClass").text = \
                c.get("storage_class", "STANDARD")
        return self._xml(root)

    async def _list_versions(self, req: _Request, gw: RGWLite,
                             bucket: str):
        versions = await gw.list_object_versions(
            bucket, prefix=req.query.get("prefix", ""))
        root = ET.Element("ListVersionsResult", xmlns=XMLNS)
        ET.SubElement(root, "Name").text = bucket
        for v in versions:
            tag = "DeleteMarker" if v["delete_marker"] else "Version"
            e = ET.SubElement(root, tag)
            ET.SubElement(e, "Key").text = v["key"]
            ET.SubElement(e, "VersionId").text = v["version_id"]
            ET.SubElement(e, "IsLatest").text = \
                "true" if v["is_latest"] else "false"
            ET.SubElement(e, "LastModified").text = _iso(v["mtime"])
            if not v["delete_marker"]:
                ET.SubElement(e, "Size").text = str(v["size"])
                ET.SubElement(e, "ETag").text = f'"{v["etag"]}"'
                ET.SubElement(e, "StorageClass").text = \
                    v.get("storage_class", "STANDARD")
        return self._xml(root)

    async def _bulk_delete(self, req: _Request, gw: RGWLite,
                           bucket: str):
        doc = ET.fromstring(req.body.decode())
        root = ET.Element("DeleteResult", xmlns=XMLNS)
        for obj in doc.iter():
            if not obj.tag.endswith("Object"):
                continue
            key = obj.findtext(_ns("Key")) or obj.findtext("Key") or ""
            try:
                await gw.delete_object(bucket, key)
                d = ET.SubElement(root, "Deleted")
                ET.SubElement(d, "Key").text = key
            except RGWError as e:
                er = ET.SubElement(root, "Error")
                ET.SubElement(er, "Key").text = key
                ET.SubElement(er, "Code").text = e.code
        return self._xml(root)

    async def _object(self, req: _Request, gw: RGWLite, bucket: str,
                      key: str):
        q = req.query
        if req.method == "POST":
            if "uploads" in q:
                kms_alg, kms_key = _sse_kms_headers(req)
                upload_id = await gw.initiate_multipart(
                    bucket, key,
                    content_type=req.header("content-type",
                                            "binary/octet-stream"),
                    metadata=_meta_headers(req),
                    lock=_lock_headers(req),
                    sse=kms_alg, kms_key_id=kms_key,
                    storage_class=req.header("x-amz-storage-class"),
                )
                root = ET.Element("InitiateMultipartUploadResult",
                                  xmlns=XMLNS)
                ET.SubElement(root, "Bucket").text = bucket
                ET.SubElement(root, "Key").text = key
                ET.SubElement(root, "UploadId").text = upload_id
                return self._xml(root)
            if "uploadId" in q:
                parts = _parse_complete(req.body)
                done = await gw.complete_multipart(bucket, key,
                                                   q["uploadId"], parts)
                root = ET.Element("CompleteMultipartUploadResult",
                                  xmlns=XMLNS)
                ET.SubElement(root, "Key").text = key
                ET.SubElement(root, "ETag").text = f'"{done["etag"]}"'
                hdrs = {}
                if done.get("version_id"):
                    hdrs["x-amz-version-id"] = done["version_id"]
                status, xh, body = self._xml(root)
                xh.update(hdrs)
                return status, xh, body
            raise _HTTPError(400, "InvalidArgument", "bad POST")
        if req.method == "PUT":
            if "tagging" in q:
                await gw.put_object_tagging(
                    bucket, key, _parse_tagging(req.body),
                    version_id=q.get("versionId"))
                return 200, {}, b""
            if "retention" in q:
                mode, until = _parse_retention(req.body)
                await gw.put_object_retention(
                    bucket, key, mode, until,
                    version_id=q.get("versionId"),
                    bypass_governance=req.header(
                        "x-amz-bypass-governance-retention",
                        "").lower() == "true")
                return 200, {}, b""
            if "legal-hold" in q:
                status = _parse_legal_hold(req.body)
                await gw.put_object_legal_hold(
                    bucket, key, status,
                    version_id=q.get("versionId"))
                return 200, {}, b""
            if "partNumber" in q and "uploadId" in q:
                src = req.header("x-amz-copy-source")
                if src:
                    # UploadPartCopy: source object (+ optional
                    # x-amz-copy-source-range, inclusive bounds)
                    sb, _, sk = src.lstrip("/").partition("/")
                    rng = None
                    rh = req.header("x-amz-copy-source-range")
                    if rh:
                        if not rh.startswith("bytes="):
                            # a malformed range must not silently
                            # become a whole-object copy
                            raise _HTTPError(400, "InvalidArgument",
                                             f"bad range {rh!r}")
                        a, _, b = rh[6:].partition("-")
                        try:
                            rng = (int(a), int(b))
                        except ValueError:
                            raise _HTTPError(400, "InvalidRange", rh)
                    part = await gw.upload_part_copy(
                        bucket, key, q["uploadId"],
                        int(q["partNumber"]), sb,
                        urllib.parse.unquote(sk), src_range=rng,
                        sse_key=_sse_key_headers(req),
                        src_sse_key=_copy_source_sse_key(req))
                    root = ET.Element("CopyPartResult", xmlns=XMLNS)
                    ET.SubElement(root, "ETag").text = \
                        f'"{part["etag"]}"'
                    return self._xml(root)
                part = await gw.upload_part(
                    bucket, key, q["uploadId"], int(q["partNumber"]),
                    req.body, sse_key=_sse_key_headers(req),
                )
                return 200, {"etag": f'"{part["etag"]}"'}, b""
            src = req.header("x-amz-copy-source")
            if src:
                sb, _, sk = src.lstrip("/").partition("/")
                kms_alg, kms_key = _sse_kms_headers(req)
                out = await gw.copy_object(
                    sb, urllib.parse.unquote(sk), bucket, key,
                    src_sse_key=_copy_source_sse_key(req),
                    sse_key=_sse_key_headers(req),
                    sse=kms_alg, kms_key_id=kms_key,
                    storage_class=req.header("x-amz-storage-class"))
                root = ET.Element("CopyObjectResult", xmlns=XMLNS)
                ET.SubElement(root, "ETag").text = f'"{out["etag"]}"'
                return self._xml(root)
            sse_key = _sse_key_headers(req)
            kms_alg, kms_key = _sse_kms_headers(req)
            if kms_alg is not None and sse_key is not None:
                raise _HTTPError(400, "InvalidArgument",
                                 "SSE-C and x-amz-server-side-"
                                 "encryption are mutually exclusive")
            htags = _header_tags(req)
            if htags:
                # validate AND authorize before any body lands: S3
                # requires s3:PutObjectTagging to set tags on PUT,
                # and a tag error must not surface post-creation
                RGWLite.validate_tags(htags)
                meta_b = await gw._check_bucket(
                    bucket, "WRITE", action="s3:PutObjectTagging",
                    key=key)
            if req.stream is not None:
                out = await self._streaming_put(req, gw, bucket, key,
                                                sse_key, kms_alg,
                                                kms_key)
                if htags:
                    # attach to OUR upload only (etag-guarded: a
                    # racing overwrite must not inherit them); a
                    # racing delete means there is nothing to tag —
                    # the PUT itself still succeeded
                    try:
                        await gw._tag_update(bucket, meta_b, key,
                                             htags,
                                             expect_etag=out["etag"])
                    except RGWError as e:
                        if e.code != "NoSuchKey":
                            raise
            else:
                out = await gw.put_object(
                    bucket, key, req.body,
                    content_type=req.header("content-type",
                                            "binary/octet-stream"),
                    metadata=_meta_headers(req),
                    if_none_match=req.header("if-none-match") == "*",
                    sse_key=sse_key,
                    lock=_lock_headers(req),
                    tags=htags,
                    sse=kms_alg, kms_key_id=kms_key,
                    storage_class=req.header("x-amz-storage-class"),
                )
            hdrs = {"etag": f'"{out["etag"]}"'}
            if out.get("version_id"):
                hdrs["x-amz-version-id"] = out["version_id"]
            if sse_key is not None:
                hdrs["x-amz-server-side-encryption-customer-algorithm"] \
                    = "AES256"
            if kms_alg is not None:
                hdrs["x-amz-server-side-encryption"] = kms_alg
                if kms_alg == "aws:kms":
                    hdrs["x-amz-server-side-encryption-aws-kms-key-id"] \
                        = kms_key or RGWLite.DEFAULT_KMS_KEY
            return 200, hdrs, b""
        if req.method == "DELETE":
            if "tagging" in q:
                await gw.delete_object_tagging(
                    bucket, key, version_id=q.get("versionId"))
                return 204, {}, b""
            if "uploadId" in q:
                await gw.abort_multipart(bucket, key, q["uploadId"])
                return 204, {}, b""
            if "versionId" in q:
                await gw.delete_object_version(
                    bucket, key, q["versionId"],
                    bypass_governance=req.header(
                        "x-amz-bypass-governance-retention",
                        "").lower() == "true")
                return 204, {}, b""
            await gw.delete_object(bucket, key)
            return 204, {}, b""
        if req.method in ("GET", "HEAD"):
            if "retention" in q and req.method == "GET":
                ret = await gw.get_object_retention(
                    bucket, key, version_id=q.get("versionId"))
                root = ET.Element("Retention", xmlns=XMLNS)
                ET.SubElement(root, "Mode").text = ret["mode"]
                ET.SubElement(root, "RetainUntilDate").text = \
                    time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                  time.gmtime(ret["until"]))
                return self._xml(root)
            if "legal-hold" in q and req.method == "GET":
                st = await gw.get_object_legal_hold(
                    bucket, key, version_id=q.get("versionId"))
                root = ET.Element("LegalHold", xmlns=XMLNS)
                ET.SubElement(root, "Status").text = st
                return self._xml(root)
            if "tagging" in q and req.method == "GET":
                tags = await gw.get_object_tagging(
                    bucket, key, version_id=q.get("versionId"))
                root = ET.Element("Tagging", xmlns=XMLNS)
                ts = ET.SubElement(root, "TagSet")
                for k, v in sorted(tags.items()):
                    t = ET.SubElement(ts, "Tag")
                    ET.SubElement(t, "Key").text = k
                    ET.SubElement(t, "Value").text = v
                return self._xml(root)
            if "versionId" in q:
                sse_key = _sse_key_headers(req)
                if req.method == "HEAD":
                    entry = await gw.head_object_version(
                        bucket, key, q["versionId"])
                    sse_check(entry, sse_key)
                    hdrs = _obj_headers({**entry, "data": b""})
                    hdrs["x-amz-version-id"] = q["versionId"]
                    return 200, hdrs, b""
                got = await gw.get_object_version(
                    bucket, key, q["versionId"], sse_key=sse_key)
                hdrs = _obj_headers(got)
                hdrs["x-amz-version-id"] = q["versionId"]
                return 200, hdrs, got["data"]
            sse_key = _sse_key_headers(req)
            if req.method == "HEAD":
                entry = await gw.head_object(bucket, key)
                sse_check(entry, sse_key)
                return 200, _obj_headers({**entry, "data": b""}), b""
            entry = await gw.head_object(bucket, key)
            rng = _parse_range(req.header("range"))
            if rng is not None and rng[0] == "suffix":
                size = int(entry["size"])
                rng = (max(0, size - int(rng[1])), size - 1)
            if int(entry["size"]) >= _STREAM_MIN:
                # large bodies stream straight from RADOS to the socket
                entry, gen = await gw.stream_object(
                    bucket, key, range_=rng, sse_key=sse_key,
                    chunk=_STREAM_CHUNK, entry=entry)
                hdrs = _obj_headers({**entry, "data": b""})
                if entry.get("version_id"):
                    hdrs["x-amz-version-id"] = entry["version_id"]
                size = int(entry["size"])
                if rng is not None:
                    end = min(rng[1], size - 1)
                    length = max(0, end - rng[0] + 1)
                    hdrs["content-range"] = \
                        f"bytes {rng[0]}-{end}/{size}"
                    hdrs["content-length"] = str(length)
                    return 206, hdrs, gen
                hdrs["content-length"] = str(size)
                return 200, hdrs, gen
            got = await gw.get_object(bucket, key, range_=rng,
                                      sse_key=sse_key)
            hdrs = _obj_headers(got)
            if got.get("version_id"):
                hdrs["x-amz-version-id"] = got["version_id"]
            if rng is not None:
                end = min(rng[1], got["size"] - 1)
                hdrs["content-range"] = \
                    f"bytes {rng[0]}-{end}/{got['size']}"
                hdrs["content-length"] = str(len(got["data"]))
                return 206, hdrs, got["data"]
            return 200, hdrs, got["data"]
        raise _HTTPError(405, "MethodNotAllowed", req.method)

    async def _streaming_put(self, req: _Request, gw: RGWLite,
                             bucket: str, key: str,
                             sse_key: bytes | None,
                             kms_alg: str | None = None,
                             kms_key: str | None = None) -> dict:
        """Drain the socket body straight into an RGWLite streaming
        session, hashing as it goes; the declared x-amz-content-sha256
        is enforced at the end (a signed-over hash that lied about the
        body must not publish the object — same guard as the buffered
        path, applied post-stream like S3 does)."""
        sp = await gw.begin_put(
            bucket, key, req.content_length,
            content_type=req.header("content-type",
                                    "binary/octet-stream"),
            metadata=_meta_headers(req),
            if_none_match=req.header("if-none-match") == "*",
            lock=_lock_headers(req),
            storage_class=req.header("x-amz-storage-class"),
        )
        if sse_key is not None:
            sp.set_sse_key(sse_key)
        elif kms_alg is not None:
            dk, rec = await gw._kms_begin(kms_alg, kms_key)
            sp.set_sse_kms(dk, rec)
        declared = req.header("x-amz-content-sha256")
        sha = (hashlib.sha256()
               if declared and declared != "UNSIGNED-PAYLOAD" else None)
        try:
            remaining = req.content_length
            while remaining:
                chunk = await req.stream.readexactly(
                    min(_STREAM_CHUNK, remaining))
                req.stream_consumed += len(chunk)
                remaining -= len(chunk)
                if sha is not None:
                    sha.update(chunk)
                await sp.write(chunk)
        except (Exception, asyncio.CancelledError):
            await sp.abort()
            raise
        if sha is not None and sha.hexdigest() != declared:
            await sp.abort()
            raise _HTTPError(400, "XAmzContentSHA256Mismatch",
                             "payload hash mismatch")
        return await sp.complete()

    @staticmethod
    def _xml(root: ET.Element):
        body = ET.tostring(root, xml_declaration=True,
                           encoding="unicode").encode()
        return 200, {"content-type": "application/xml"}, body


# -- helpers ---------------------------------------------------------------
def _ns(tag: str) -> str:
    return f"{{{XMLNS}}}{tag}"


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _meta_headers(req: _Request) -> dict[str, str]:
    return {k[len("x-amz-meta-"):]: v for k, v in req.headers.items()
            if k.startswith("x-amz-meta-")}


_SSE_PREFIX = "x-amz-server-side-encryption-customer-"


def _sse_kms_headers(req: _Request) -> tuple[str | None, str | None]:
    """Server-managed encryption headers (rgw_crypt.cc SSE-KMS /
    SSE-S3): x-amz-server-side-encryption ∈ {aws:kms, AES256} plus the
    optional x-amz-server-side-encryption-aws-kms-key-id."""
    alg = req.header("x-amz-server-side-encryption")
    if not alg:
        return None, None
    if alg not in ("aws:kms", "AES256"):
        raise _HTTPError(400, "InvalidArgument",
                         f"unsupported server-side encryption {alg!r}")
    key_id = req.header(
        "x-amz-server-side-encryption-aws-kms-key-id") or None
    if key_id and alg != "aws:kms":
        raise _HTTPError(400, "InvalidArgument",
                         "a KMS key id requires aws:kms")
    return alg, key_id


def _copy_source_sse_key(req: _Request) -> bytes | None:
    """The copy-source SSE-C key triple (x-amz-copy-source-server-
    side-encryption-customer-*): identical validation to the
    destination's, by construction."""
    return _sse_key_headers(
        req, "x-amz-copy-source-server-side-encryption-customer-")


def _sse_key_headers(req: _Request,
                     prefix: str | None = None) -> bytes | None:
    """Parse an S3 SSE-C header triple (rgw_crypt.cc
    rgw_s3_prepare_encrypt): algorithm must be AES256, the key is
    base64, and the md5 header (when sent) must match the key.
    ``prefix``: the copy-source variant's header namespace."""
    import base64

    pfx = prefix or _SSE_PREFIX
    alg = req.header(pfx + "algorithm")
    if not alg:
        return None
    if alg != "AES256":
        raise _HTTPError(400, "InvalidArgument",
                         f"unsupported SSE-C algorithm {alg!r}")
    try:
        key = base64.b64decode(req.header(pfx + "key"),
                               validate=True)
    except Exception:
        raise _HTTPError(400, "InvalidArgument", "bad SSE-C key")
    if len(key) != 32:
        raise _HTTPError(400, "InvalidArgument",
                         "SSE-C key must be 256 bits")
    md5h = req.header(pfx + "key-md5")
    if md5h and base64.b64encode(
            hashlib.md5(key).digest()).decode() != md5h:
        raise _HTTPError(400, "InvalidArgument", "SSE-C key md5 mismatch")
    return key


def _obj_headers(got: dict) -> dict[str, str]:
    hdrs = {
        "content-type": got.get("content_type", "binary/octet-stream"),
        "etag": f'"{got.get("etag", "")}"',
        "last-modified": formatdate(got.get("mtime", 0.0), usegmt=True),
        "content-length": str(len(got.get("data", b""))
                              or got.get("size", 0)),
    }
    for k, v in (got.get("meta") or {}).items():
        hdrs[f"x-amz-meta-{k}"] = str(v)
    if got.get("storage_class"):
        # only non-STANDARD classes are stored; S3 likewise omits the
        # header for STANDARD objects
        hdrs["x-amz-storage-class"] = got["storage_class"]
    ret = got.get("retention")
    if ret:
        hdrs["x-amz-object-lock-mode"] = ret["mode"]
        hdrs["x-amz-object-lock-retain-until-date"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(float(ret["until"])))
    if got.get("legal_hold"):
        hdrs["x-amz-object-lock-legal-hold"] = "ON"
    sse = got.get("sse")
    if sse and sse.get("wrapped") is not None:
        # KMS-managed (SSE-KMS / SSE-S3): server-side headers, never
        # the customer-key ones
        hdrs["x-amz-server-side-encryption"] = sse.get("alg", "aws:kms")
        if sse.get("alg") == "aws:kms":
            hdrs["x-amz-server-side-encryption-aws-kms-key-id"] = \
                sse.get("key_id", "")
    elif sse:
        import base64

        hdrs[_SSE_PREFIX + "algorithm"] = sse.get("alg", "AES256")
        # the wire form of the header is base64(md5), matching what the
        # client sent; the index stores the hex digest
        try:
            hdrs[_SSE_PREFIX + "key-md5"] = base64.b64encode(
                bytes.fromhex(sse.get("key_md5", ""))).decode()
        except ValueError:
            pass
    return hdrs


def _parse_range(value: str) -> tuple[int, int] | tuple[str, int] | None:
    """'bytes=a-b' -> (a, b); 'bytes=a-' -> (a, huge); 'bytes=-n' ->
    ("suffix", n).  Anything malformed (multi-range, garbage) returns
    None: RFC 7233 allows ignoring Range and serving the full body."""
    if not value.startswith("bytes="):
        return None
    start_s, _, end_s = value[len("bytes="):].partition("-")
    try:
        if not start_s:
            n = int(end_s)
            return ("suffix", n) if n > 0 else None
        return int(start_s), int(end_s) if end_s else (1 << 62)
    except ValueError:
        return None


def _parse_complete(body: bytes) -> list[tuple[int, str]]:
    doc = ET.fromstring(body.decode())
    parts: list[tuple[int, str]] = []
    for el in doc.iter():
        if not el.tag.endswith("Part"):
            continue
        num = el.findtext(_ns("PartNumber")) or \
            el.findtext("PartNumber") or "0"
        etag = (el.findtext(_ns("ETag")) or el.findtext("ETag")
                or "").strip('"')
        parts.append((int(num), etag))
    return parts


def _parse_cors(body: bytes) -> list[dict]:
    """CORSConfiguration XML -> rule dicts (namespaced or not)."""
    cfg = ET.fromstring(body.decode() or "<CORSConfiguration/>")

    def texts(rule, tag):
        return [e.text for e in (rule.findall(_ns(tag))
                                 or rule.findall(tag)) if e.text]

    rules = []
    for r in (list(cfg.findall(_ns("CORSRule")))
              or list(cfg.findall("CORSRule"))):
        rule = {
            "allowed_origins": texts(r, "AllowedOrigin"),
            "allowed_methods": texts(r, "AllowedMethod"),
        }
        for tag, field in (("AllowedHeader", "allowed_headers"),
                           ("ExposeHeader", "expose_headers")):
            vals = texts(r, tag)
            if vals:
                rule[field] = vals
        age = (r.findtext(_ns("MaxAgeSeconds"))
               or r.findtext("MaxAgeSeconds"))
        if age:
            rule["max_age_seconds"] = int(age)
        rules.append(rule)
    return rules


def _lock_headers(req: _Request) -> dict | None:
    """x-amz-object-lock-{mode,retain-until-date,legal-hold} on PUT
    object: the new version's explicit lock state."""
    mode = req.header("x-amz-object-lock-mode")
    raw = req.header("x-amz-object-lock-retain-until-date")
    hold = req.header("x-amz-object-lock-legal-hold", "").upper()
    if not mode and not raw and not hold:
        return None
    lock: dict = {}
    if mode or raw:
        if not (mode and raw):
            raise _HTTPError(400, "InvalidArgument",
                             "mode and retain-until-date go "
                             "together")
        try:
            until = calendar.timegm(time.strptime(
                raw.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S"))
        except ValueError:
            raise _HTTPError(400, "InvalidArgument",
                             f"bad retain-until-date {raw!r}")
        lock["mode"] = mode
        lock["until"] = float(until)
    if hold == "ON":
        lock["legal_hold"] = True
    return lock


def _parse_retention(body: bytes) -> tuple[str, float]:
    doc = ET.fromstring(body.decode())
    mode = doc.findtext(_ns("Mode")) or doc.findtext("Mode") or ""
    raw = doc.findtext(_ns("RetainUntilDate")) or \
        doc.findtext("RetainUntilDate") or ""
    try:
        until = calendar.timegm(time.strptime(
            raw.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S"))
    except ValueError:
        raise _HTTPError(400, "MalformedXML",
                         f"bad RetainUntilDate {raw!r}")
    return mode, float(until)


def _parse_legal_hold(body: bytes) -> bool:
    doc = ET.fromstring(body.decode())
    st = (doc.findtext(_ns("Status")) or doc.findtext("Status")
          or "").upper()
    if st not in ("ON", "OFF"):
        raise _HTTPError(400, "MalformedXML", f"bad status {st!r}")
    return st == "ON"


def _parse_lock_config(body: bytes) -> tuple[str | None, int, int]:
    doc = ET.fromstring(body.decode())
    dr = doc.find(f"{_ns('Rule')}/{_ns('DefaultRetention')}")
    if dr is None:
        dr = doc.find("Rule/DefaultRetention")
    if dr is None:
        return None, 0, 0
    mode = dr.findtext(_ns("Mode")) or dr.findtext("Mode") or ""
    days = int(dr.findtext(_ns("Days")) or dr.findtext("Days") or 0)
    years = int(dr.findtext(_ns("Years"))
                or dr.findtext("Years") or 0)
    return mode, days, years


def _parse_tagging(body: bytes) -> dict[str, str]:
    """Tagging XML -> {key: value}."""
    cfg = ET.fromstring(body.decode() or "<Tagging/>")
    ts = (cfg.find(_ns("TagSet")) if cfg.find(_ns("TagSet"))
          is not None else cfg.find("TagSet"))
    tags: dict[str, str] = {}
    for t in (list(ts.findall(_ns("Tag"))) or list(ts.findall("Tag"))
              ) if ts is not None else ():
        k = t.findtext(_ns("Key")) or t.findtext("Key") or ""
        v = t.findtext(_ns("Value")) or t.findtext("Value") or ""
        if k:
            tags[k] = v
    return tags


def _header_tags(req: _Request) -> dict[str, str]:
    """The x-amz-tagging header: URL-encoded key=value pairs."""
    raw = req.header("x-amz-tagging")
    if not raw:
        return {}
    return {urllib.parse.unquote_plus(k): urllib.parse.unquote_plus(v)
            for k, _, v in (p.partition("=")
                            for p in raw.split("&")) if k}


def _parse_lifecycle(body: bytes) -> list[dict]:
    doc = ET.fromstring(body.decode())
    rules = []
    for el in doc.iter():
        if not el.tag.endswith("Rule"):
            continue
        rule = {
            "id": el.findtext(_ns("ID")) or el.findtext("ID") or "",
            "prefix": (el.findtext(_ns("Prefix"))
                       or el.findtext("Prefix")
                       or el.findtext(f"{_ns('Filter')}/{_ns('Prefix')}")
                       or el.findtext("Filter/Prefix")
                       or el.findtext(f"{_ns('Filter')}/{_ns('And')}"
                                      f"/{_ns('Prefix')}")
                       or el.findtext("Filter/And/Prefix") or ""),
            "status": (el.findtext(_ns("Status"))
                       or el.findtext("Status") or "Enabled"),
        }
        # each action element maps to its own rule field; an absent
        # element must stay absent (a defaulted 0-day expiration
        # would expire the whole prefix immediately)
        for xml_path, field in (
                (("Expiration", "Days"), "expiration_days"),
                (("NoncurrentVersionExpiration", "NoncurrentDays"),
                 "noncurrent_days"),
                (("AbortIncompleteMultipartUpload",
                  "DaysAfterInitiation"), "abort_mpu_days"),
                (("Transition", "Days"), "transition_days"),
                (("NoncurrentVersionTransition", "NoncurrentDays"),
                 "noncurrent_transition_days")):
            outer, inner = xml_path
            v = el.findtext(f"{_ns(outer)}/{_ns(inner)}") or \
                el.findtext(f"{outer}/{inner}")
            if v is not None:
                try:
                    rule[field] = int(v)
                except ValueError:
                    # a non-numeric <Days> is the CLIENT's document
                    # error: 400 MalformedXML, never an unhandled
                    # ValueError turning into a 500
                    raise _HTTPError(
                        400, "MalformedXML",
                        f"{outer}/{inner}: {v!r} is not an integer"
                    ) from None
        # unsupported action variants must be REJECTED, not dropped:
        # silently ignoring <Date> would disable the expiry or
        # transition the client asked for on a date we never check
        for outer in ("Expiration", "Transition",
                      "NoncurrentVersionExpiration",
                      "NoncurrentVersionTransition"):
            if el.find(f"{_ns(outer)}/{_ns('Date')}") is not None or \
                    el.find(f"{outer}/Date") is not None:
                raise _HTTPError(
                    501, "NotImplemented",
                    f"{outer}/Date is not supported; use Days")
        if el.find(f"{_ns('Expiration')}/"
                   f"{_ns('ExpiredObjectDeleteMarker')}") is not None \
                or el.find("Expiration/ExpiredObjectDeleteMarker") \
                is not None:
            raise _HTTPError(501, "NotImplemented",
                             "ExpiredObjectDeleteMarker is not "
                             "supported")
        for outer, field in (
                ("Transition", "transition_class"),
                ("NoncurrentVersionTransition",
                 "noncurrent_transition_class")):
            v = el.findtext(f"{_ns(outer)}/{_ns('StorageClass')}") or \
                el.findtext(f"{outer}/StorageClass")
            if v:
                rule[field] = v
        # <Filter><Tag> / <Filter><And><Tag>...: dropping a tag
        # filter silently would expire objects it was protecting
        tags = {}
        for tag_el in el.iter():
            if tag_el.tag.endswith("Tag"):
                k = (tag_el.findtext(_ns("Key"))
                     or tag_el.findtext("Key") or "")
                v = (tag_el.findtext(_ns("Value"))
                     or tag_el.findtext("Value") or "")
                if k:
                    tags[k] = v
        if tags:
            rule["tags"] = tags
        rules.append(rule)
    return rules
