"""Push-mode bucket-notification endpoints.

Counterpart of ceph_tpu/services/rgw_push.py: the same module over the
port's imports.

The RGWPubSubEndpoint role (reference src/rgw/rgw_pubsub_push.h:20,
745-LoC impl in rgw_pubsub_push.cc): scheme-dispatched endpoint
objects that deliver one event and report success per their ack
level.  This image ships no AMQP/Kafka client libraries, so the
endpoint family is http(s) — the reference's RGWPubSubHTTPEndpoint —
delivered with a minimal asyncio HTTP/1.1 POST.  Retry / backoff /
dead-letter live in the caller (services/rgw.py's per-topic push
worker, the rgw_notify.cc persistent-topic semantics).

Ack levels (the reference's ack-level endpoint arg):
- "broker": a 2xx response is required (default);
- "none": fire-and-forget — the connection + request must succeed but
  any status acks.
"""

from __future__ import annotations

import asyncio
import ssl as ssl_mod
import urllib.parse


class DeliveryError(Exception):
    """One delivery attempt failed.  ``connected`` distinguishes an
    endpoint that ANSWERED and rejected (dead-letter material after
    retries) from one that was unreachable (keep retrying with backoff
    — the reference's persistent queues retry within the retention
    window rather than discarding while a consumer is down)."""

    def __init__(self, msg: str, connected: bool = False):
        super().__init__(msg)
        self.connected = connected


async def _http_post(url: str, body: bytes,
                     timeout: float = 5.0) -> int:
    u = urllib.parse.urlsplit(url)
    if u.scheme not in ("http", "https"):
        raise DeliveryError(f"unsupported scheme {u.scheme!r}")
    host = u.hostname or ""
    port = u.port or (443 if u.scheme == "https" else 80)
    ctx = ssl_mod.create_default_context() if u.scheme == "https" \
        else None
    writer = None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port, ssl=ctx), timeout)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        req = (f"POST {path} HTTP/1.1\r\n"
               f"Host: {host}\r\n"
               "Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n"
               "Connection: close\r\n\r\n").encode() + body
        writer.write(req)
        await asyncio.wait_for(writer.drain(), timeout)
        status_line = await asyncio.wait_for(reader.readline(), timeout)
        parts = status_line.split()
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
            raise DeliveryError(f"bad status line {status_line!r}",
                                connected=True)
        return int(parts[1])
    except DeliveryError:
        raise
    except (OSError, ValueError, asyncio.TimeoutError) as e:
        raise DeliveryError(f"POST {url}: {e}") from e
    finally:
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except (OSError, ssl_mod.SSLError):
                pass


class PushEndpoint:
    """Scheme-dispatched endpoint (RGWPubSubEndpoint::create role)."""

    def __init__(self, url: str, ack_level: str = "broker",
                 timeout: float = 5.0):
        self.url = url
        self.ack_level = ack_level
        self.timeout = timeout

    @staticmethod
    def make(url: str, ack_level: str = "broker",
             timeout: float = 5.0) -> "PushEndpoint":
        scheme = urllib.parse.urlsplit(url).scheme
        if scheme in ("http", "https"):
            return HTTPPushEndpoint(url, ack_level, timeout)
        raise ValueError(
            f"unsupported push endpoint scheme {scheme!r} "
            "(http/https supported; amqp/kafka need client libraries "
            "this image does not ship)")

    async def send(self, payload: bytes) -> None:
        raise NotImplementedError


class HTTPPushEndpoint(PushEndpoint):
    async def send(self, payload: bytes) -> None:
        status = await _http_post(self.url, payload, self.timeout)
        if self.ack_level != "none" and not 200 <= status < 300:
            raise DeliveryError(f"endpoint answered {status}",
                                connected=True)
