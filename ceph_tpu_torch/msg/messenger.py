"""Asyncio Messenger with ProtocolV2-style framing and policies.

Counterpart of ceph_tpu/msg/messenger.py: the same module over the
port's imports.

Surface mirrors reference src/msg/Messenger.h / Connection.h / Dispatcher.h /
Policy.h; the wire discipline mirrors src/msg/async/ProtocolV2.cc: banner +
handshake (entity, connect_seq, in_seq), then crc-protected frames carrying
seq + piggybacked ack. Lossless-peer policy reconnects and replays unacked
messages after a drop (the acceptor keeps the Connection object and swaps in
the new stream, reference ProtocolV2 session-retry); lossy-client policy
tears down and notifies the dispatcher (ms_handle_reset).

Transports: ``tcp://host:port`` over asyncio sockets, and ``local://name``
over in-process queue streams (the MemStore analog for networking — hundreds
of endpoints in one process, no kernel sockets), both under the same framing
so fault injection (ms_inject_socket_failures, reference
src/common/options.cc:1075) exercises the real protocol paths.
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Protocol

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.crc32c import crc32c
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.common.perf import CounterType, PerfCounters
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.common.tracing import (
    LoopLabel,
    SpanCtx,
    Tracer,
    hold_loop_trace,
    untraced_context,
    watch_trace_probability,
)
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.msg.message import Message

log = Dout("ms")

BANNER = b"ceph-tpu msgr v2\n"
_FRAME_HDR = struct.Struct("<QQII")      # seq, ack, payload_len, payload_crc
_AAD = struct.Struct("<QQI")             # secure mode: header fields as AAD
_LEN = struct.Struct("<I")

_RECONNECT_DELAY = 0.02
_MAX_RECONNECT_DELAY = 1.0
# the messenger's loop time while the loop is traced: a message's
# encode, then its frame's CRC and write (the writer task); a frame's
# read, CRC check and decode (the reader task)
_SEND = LoopLabel("msgr:send")
_RECV = LoopLabel("msgr:recv")


def _recv_done(msg: Message) -> None:
    """The reader task keeps ``msgr:recv`` through a traced message's
    hand-off to its ``msgr:dispatch`` span, and lets go before an
    untraced one's dispatch: that is its handler's work, and the tasks
    the handler starts must not inherit the label."""
    if not (isinstance(msg.data, dict) and "tctx" in msg.data):
        _RECV.release()


class MessengerError(ConnectionError):
    pass


# ---------------------------------------------------------------------------
# addressing

@dataclass(frozen=True)
class EntityAddr:
    """``local://name`` or ``tcp://host:port``."""
    scheme: str
    host: str
    port: int = 0

    @classmethod
    def parse(cls, addr: str) -> "EntityAddr":
        scheme, _, rest = addr.partition("://")
        if scheme == "local":
            return cls("local", rest)
        if scheme == "tcp":
            host, _, port = rest.rpartition(":")
            return cls("tcp", host, int(port))
        raise ValueError(f"bad address {addr!r}")

    def __str__(self) -> str:
        if self.scheme == "local":
            return f"local://{self.host}"
        return f"tcp://{self.host}:{self.port}"


# ---------------------------------------------------------------------------
# streams: one byte-pipe interface over tcp sockets or in-process queues

class Stream(Protocol):
    async def read_exactly(self, n: int) -> bytes: ...
    def write(self, data: bytes) -> None: ...
    async def drain(self) -> None: ...
    def close(self) -> None: ...


class TcpStream:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._r, self._w = reader, writer

    async def read_exactly(self, n: int) -> bytes:
        try:
            return await self._r.readexactly(n)
        except (asyncio.IncompleteReadError, OSError) as e:
            raise MessengerError(str(e)) from e

    def write(self, data: bytes) -> None:
        self._w.write(data)

    async def drain(self) -> None:
        try:
            await self._w.drain()
        except OSError as e:
            raise MessengerError(str(e)) from e

    def close(self) -> None:
        try:
            self._w.close()
        except Exception:
            pass


class QueueStream:
    """One direction-pair of in-process byte queues."""

    def __init__(self, rx: asyncio.Queue, tx: asyncio.Queue):
        self._rx, self._tx = rx, tx
        self._buf = bytearray()
        self._closed = False

    @classmethod
    def pair(cls) -> tuple["QueueStream", "QueueStream"]:
        a, b = asyncio.Queue(), asyncio.Queue()
        return cls(a, b), cls(b, a)

    async def read_exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = await self._rx.get()
            if chunk is None:
                raise MessengerError("stream closed by peer")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def write(self, data: bytes) -> None:
        if self._closed:
            raise MessengerError("stream closed")
        self._tx.put_nowait(bytes(data))

    async def drain(self) -> None:
        if self._closed:
            raise MessengerError("stream closed")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._tx.put_nowait(None)


# local:// listener namespace (reset between tests)
_LOCAL_LISTENERS: dict[str, "Messenger"] = {}


def reset_local_namespace() -> None:
    _LOCAL_LISTENERS.clear()


# ---------------------------------------------------------------------------
# policy + dispatcher

@dataclass(frozen=True)
class Policy:
    """Per-peer-type delivery contract (reference src/msg/Policy.h)."""
    lossy: bool = False         # drop state on failure vs reconnect+replay
    server: bool = False        # never initiates reconnect
    # dispatch-throttle budget for this peer type; None = the
    # ms_dispatch_throttle_bytes config default (Policy.h throttler_bytes)
    throttler_bytes: int | None = None

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False, server=False)

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True, server=False)

    @classmethod
    def stateless_server(cls) -> "Policy":
        return cls(lossy=True, server=True)

    @classmethod
    def lossless_server(cls) -> "Policy":
        return cls(lossy=False, server=True)


class Dispatcher(Protocol):
    async def ms_dispatch(self, conn: "Connection", msg: Message) -> None: ...

    def ms_handle_reset(self, conn: "Connection") -> None:
        """Lossy connection died; state is gone."""

    def ms_handle_connect(self, conn: "Connection") -> None:
        """New session established."""


# ---------------------------------------------------------------------------
# connection

class Connection:
    """One peer session. Survives stream replacement when lossless."""

    def __init__(self, msgr: "Messenger", peer_name: str, peer_addr: str,
                 policy: Policy, initiator: bool):
        self.msgr = msgr
        self.peer_name = peer_name          # may be "" until handshake
        self.peer_nonce = 0                 # peer instance id (handshake)
        self.peer_addr = peer_addr
        self.policy = policy
        self.initiator = initiator
        self.out_seq = 0
        self.in_seq = 0
        self.connect_seq = 0
        self._stream: Optional[Stream] = None
        self._out: asyncio.Queue = asyncio.Queue()
        self._sent_unacked: deque[tuple[int, bytes]] = deque()
        self._tasks: list[asyncio.Task] = []
        self._closed = False
        self._ready = asyncio.Event()
        # (AESGCM, tx_nonce_prefix, rx_nonce_prefix) when secure mode
        # negotiated (crypto_onwire role); None = plaintext frames
        self._onwire = None

    # -- public api ------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        """Queue for ordered delivery (Connection::send_message)."""
        if self._closed:
            raise MessengerError(f"connection to {self.peer_addr} closed")
        self.out_seq += 1
        with _SEND:
            payload = encode(msg.to_wire())
        if not self.policy.lossy:
            self._sent_unacked.append((self.out_seq, payload))
        self._out.put_nowait((self.out_seq, payload))

    def mark_down(self) -> None:
        """Hard-close; no reconnect (Connection::mark_down)."""
        self._closed = True
        self._teardown_stream()
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        self.msgr._forget(self)

    @property
    def is_closed(self) -> bool:
        return self._closed

    # -- internals -------------------------------------------------------
    def _teardown_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        self._ready.clear()

    def _attach(self, stream: Stream, peer_in_seq: int) -> None:
        """Adopt a fresh stream: purge acked, queue replay of the rest.
        The queue OBJECT is reused — a writer task blocked in get() on it
        must wake when the replay lands, so never swap in a new Queue."""
        self._stream = stream
        self.connect_seq += 1
        while self._sent_unacked and self._sent_unacked[0][0] <= peer_in_seq:
            self._sent_unacked.popleft()
        pending: list[tuple[int, bytes]] = list(self._sent_unacked)
        seen = {seq for seq, _ in pending}
        while not self._out.empty():
            item = self._out.get_nowait()
            if item[0] not in seen:
                pending.append(item)
        for item in pending:
            self._out.put_nowait(item)
        self._ready.set()

    def _start_io(self) -> None:
        # the I/O tasks start with no span ambient: a session dialled
        # inside a traced op must not keep that op's span
        self._tasks = [
            asyncio.create_task(self._writer_loop(),
                                context=untraced_context()),
            asyncio.create_task(self._reader_loop(),
                                context=untraced_context()),
        ]

    def _stop_io(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []

    async def _writer_loop(self) -> None:
        _SEND.hold()
        try:
            while not self._closed:
                await self._ready.wait()
                seq, payload = await self._out.get()
                stream = self._stream
                if stream is None:
                    # stream died between wait and get: requeue and re-wait
                    self._out.put_nowait((seq, payload))
                    self._ready.clear()
                    continue
                try:
                    self.msgr._maybe_inject_failure()
                    wire = payload
                    if self._onwire is not None:
                        # AES-GCM per frame, nonce = direction prefix +
                        # seq.  The header (seq, ack, length) rides as
                        # AAD: CRC alone would let an active attacker
                        # rewrite the ack and silently purge unreplayed
                        # messages from a lossless session.
                        ack = self.in_seq
                        aad = _AAD.pack(seq, ack, len(payload) + 16)
                        wire = self._onwire[0].encrypt(
                            self._onwire[1] + seq.to_bytes(8, "little"),
                            payload, aad,
                        )
                        hdr = _FRAME_HDR.pack(seq, ack, len(wire),
                                              crc32c(0xFFFFFFFF, wire))
                    else:
                        hdr = _FRAME_HDR.pack(
                            seq, self.in_seq, len(wire),
                            crc32c(0xFFFFFFFF, wire),
                        )
                    stream.write(hdr + wire)
                    await stream.drain()
                except MessengerError as e:
                    self._out.put_nowait((seq, payload))
                    self._on_stream_failure(e)
        except asyncio.CancelledError:
            pass

    async def _reader_loop(self) -> None:
        try:
            while not self._closed:
                await self._ready.wait()
                stream = self._stream
                if stream is None:
                    self._ready.clear()
                    continue
                _RECV.hold()
                try:
                    raw = await stream.read_exactly(_FRAME_HDR.size)
                    seq, ack, length, crc = _FRAME_HDR.unpack(raw)
                    payload = await stream.read_exactly(length)
                except MessengerError as e:
                    self._on_stream_failure(e)
                    continue
                if crc32c(0xFFFFFFFF, payload) != crc:
                    self._on_stream_failure(MessengerError("bad frame crc"))
                    continue
                if self._onwire is not None:
                    try:
                        payload = self._onwire[0].decrypt(
                            self._onwire[2]
                            + seq.to_bytes(8, "little"),
                            payload, _AAD.pack(seq, ack, length),
                        )
                    except Exception:
                        # InvalidTag: tampered frame OR tampered header
                        # (aad covers seq/ack/length) or key mismatch
                        self._on_stream_failure(
                            MessengerError("onwire auth failed")
                        )
                        continue
                while self._sent_unacked and self._sent_unacked[0][0] <= ack:
                    self._sent_unacked.popleft()
                if seq <= self.in_seq:
                    continue                      # replayed duplicate
                try:
                    msg = Message.from_wire(decode(payload), seq)
                except (ValueError, TypeError, KeyError, IndexError,
                        struct.error) as e:
                    # crc-valid but malformed payload: treat as a stream
                    # failure, not a reader-task crash
                    self._on_stream_failure(
                        MessengerError(f"bad payload: {e}")
                    )
                    continue
                _recv_done(msg)
                self.in_seq = seq
                throttle = self.msgr._dispatch_throttle(self)
                if throttle is not None:
                    # Backpressure while the message is in DISPATCH
                    # (decode -> handler entry).  Handlers that detach
                    # long work into tasks leave dispatch quickly; the
                    # op-lifetime memory bound for those is the OSD's
                    # client-message throttle (osd daemon), the same
                    # two-layer split as the reference's dispatch
                    # throttle + osd_client_message_size_cap.
                    await throttle.acquire(length)
                    try:
                        await self.msgr._deliver(self, msg)
                    finally:
                        throttle.release(length)
                else:
                    await self.msgr._deliver(self, msg)
        except asyncio.CancelledError:
            pass

    def _on_stream_failure(self, exc: Exception) -> None:
        if self._closed or self._stream is None:
            return
        log.dout(10, "connection %s -> %s: stream failed: %s",
                  self.msgr.name, self.peer_addr, exc)
        self._teardown_stream()
        if self.policy.lossy:
            self._closed = True
            self._stop_io_soon()
            self.msgr._forget(self)
            self.msgr._notify_reset(self)
        elif self.initiator:
            asyncio.get_running_loop().create_task(
                self._reconnect_loop(), context=untraced_context())
        # else: lossless acceptor goes standby; initiator will come back

    def _stop_io_soon(self) -> None:
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()
        self._tasks = []

    async def _reconnect_loop(self) -> None:
        delay = _RECONNECT_DELAY
        while not self._closed and self._stream is None:
            await asyncio.sleep(delay * (0.5 + random.random()))
            delay = min(delay * 2, _MAX_RECONNECT_DELAY)
            try:
                await self.msgr._dial(self)
                return
            except (MessengerError, OSError, ValueError) as e:
                log.dout(10, "reconnect %s -> %s failed: %s",
                          self.msgr.name, self.peer_addr, e)


# ---------------------------------------------------------------------------
# messenger

class Messenger:
    """Binds an address, accepts sessions, hands out Connections."""

    def __init__(self, name: str, conf=None, nonce: int | None = None):
        self.name = name                    # entity name, e.g. "osd.3"
        self.conf = conf
        self.nonce = nonce if nonce is not None else random.getrandbits(32)
        self.my_addr: Optional[EntityAddr] = None
        self.dispatcher: Optional[Dispatcher] = None
        self.default_policy = Policy.lossless_peer()
        self.policies: dict[str, Policy] = {}     # peer entity type -> policy
        self._conns: dict[str, Connection] = {}   # peer addr str -> conn
        # (peer name, peer nonce) -> conn
        self._accepted: dict[tuple[str, int], Connection] = {}
        self._dialing: dict[str, asyncio.Future] = {}  # in-flight connects
        self._server: Optional[asyncio.base_events.Server] = None
        self._rng = random.Random()
        self._stopped = False
        self._throttles: dict[str, "Throttle"] = {}  # peer type ->
        # dispatch-hop observability: how long ms_dispatch holds each
        # delivered message (histogram, us), and — for messages whose
        # payload carries a trace context — a span for the hop, so
        # queueing/dispatch time shows up inside the op's trace tree
        self.perf = PerfCounters(f"{name}:msgr")
        self.perf.add("dispatch", CounterType.U64)
        self.perf.add("dispatch_latency_us", CounterType.HISTOGRAM)
        self.tracer = Tracer(name)
        watch_trace_probability(conf, self._sync_loop_trace)

    # -- setup -----------------------------------------------------------
    def set_dispatcher(self, d: Dispatcher) -> None:
        self.dispatcher = d

    def _sync_loop_trace(self, *_) -> None:
        """Trace the event loop's steps while this entity samples ops
        (``trace_probability`` above 0) and runs."""
        try:
            prob = float(self.conf["trace_probability"] or 0.0) \
                if self.conf is not None else 0.0
        except KeyError:
            prob = 0.0
        hold_loop_trace(self, prob > 0 and not self._stopped)

    def set_policy(self, entity_type: str, policy: Policy) -> None:
        """Policy for peers whose name starts with ``entity_type.``"""
        self.policies[entity_type] = policy

    def _policy_for(self, peer_name: str) -> Policy:
        etype = peer_name.split(".", 1)[0]
        return self.policies.get(etype, self.default_policy)

    def _dispatch_throttle(self, conn: Connection):
        """Shared per-peer-type dispatch throttle (Policy throttlers):
        bounds bytes sitting in dispatch so a flood from one entity
        class backpressures its sockets instead of ballooning memory."""
        etype = conn.peer_name.split(".", 1)[0] if conn.peer_name else ""
        throttle = self._throttles.get(etype)
        if throttle is None:
            limit = conn.policy.throttler_bytes
            if limit is None:
                limit = (self.conf["ms_dispatch_throttle_bytes"]
                         if self.conf else 0)
            if not limit:
                return None
            throttle = Throttle(f"msgr-dispatch-{etype or 'any'}", limit)
            self._throttles[etype] = throttle
        return throttle

    def throttle_dump(self) -> dict:
        return {name: t.dump() for name, t in self._throttles.items()}

    async def bind(self, addr: str) -> None:
        a = EntityAddr.parse(addr)
        if a.scheme == "local":
            if a.host in _LOCAL_LISTENERS:
                raise MessengerError(f"{addr} already bound")
            _LOCAL_LISTENERS[a.host] = self
        else:
            self._server = await asyncio.start_server(
                self._on_tcp_accept, a.host, a.port or None
            )
            if a.port == 0:
                a = EntityAddr(
                    "tcp", a.host, self._server.sockets[0].getsockname()[1]
                )
        self.my_addr = a
        self._sync_loop_trace()

    async def shutdown(self) -> None:
        self._stopped = True
        self._sync_loop_trace()
        for conn in list(self._conns.values()) + list(self._accepted.values()):
            conn.mark_down()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if (self.my_addr and self.my_addr.scheme == "local"
                and _LOCAL_LISTENERS.get(self.my_addr.host) is self):
            del _LOCAL_LISTENERS[self.my_addr.host]

    # -- outgoing --------------------------------------------------------
    async def connect(self, addr: str, peer_name: str = "") -> Connection:
        """Get-or-create the session to ``addr``. Concurrent callers share
        one dial (no duplicate connect_seq-0 sessions racing each other).
        A lossless connection is returned even when the first dial fails:
        messages queue and the reconnect loop delivers them once the peer
        is reachable (the reference's lazy-connect semantics); a lossy
        connect failure raises."""
        conn = self._conns.get(addr)
        if conn is not None and not conn.is_closed:
            return conn
        pending = self._dialing.get(addr)
        if pending is not None:
            return await asyncio.shield(pending)
        fut = asyncio.get_running_loop().create_future()
        self._dialing[addr] = fut
        try:
            policy = (self._policy_for(peer_name) if peer_name
                      else self.default_policy)
            conn = Connection(self, peer_name, addr, policy, initiator=True)
            try:
                await self._dial(conn)
            except (MessengerError, OSError) as e:
                if policy.lossy:
                    conn._closed = True
                    raise
                log.dout(10, "%s: initial dial to %s failed (%s); "
                         "queueing for reconnect", self.name, addr, e)
                asyncio.get_running_loop().create_task(
                    conn._reconnect_loop(), context=untraced_context()
                )
            self._conns[addr] = conn
            conn._start_io()
        except BaseException as e:
            if not fut.done():
                # a CancelledError belongs to THIS caller only — waiters
                # sharing the dial get a ConnectionError, not cancellation
                shared = (MessengerError(f"dial to {addr} cancelled")
                          if isinstance(e, asyncio.CancelledError) else e)
                fut.set_exception(shared)
                fut.exception()     # mark retrieved for the no-waiter case
            raise
        finally:
            del self._dialing[addr]
        if not fut.done():
            fut.set_result(conn)
        return conn

    async def send_to(self, addr: str, msg: Message,
                      peer_name: str = "") -> Connection:
        conn = await self.connect(addr, peer_name)
        conn.send_message(msg)
        return conn

    async def _dial(self, conn: Connection) -> None:
        self._sync_loop_trace()
        a = EntityAddr.parse(conn.peer_addr)
        self._maybe_inject_failure("msgr.dial")
        if a.scheme == "local":
            target = _LOCAL_LISTENERS.get(a.host)
            if target is None:
                raise MessengerError(f"no listener at {conn.peer_addr}")
            ours, theirs = QueueStream.pair()
            stream: Stream = ours
            accept_task = asyncio.create_task(
                target._accept_stream(theirs, str(a)),
                context=untraced_context(),
            )
        else:
            reader, writer = await asyncio.open_connection(a.host, a.port)
            stream = TcpStream(reader, writer)
            accept_task = None
        try:
            ours, peer = await self._handshake(stream, conn.in_seq,
                                               conn.connect_seq)
            conn.peer_name = peer["entity"]
            conn.peer_nonce = int(peer.get("nonce", 0))
            conn._onwire = self._derive_onwire(ours, peer)
            if conn._onwire is not None:
                # server confirms first; our confirm completes the
                # mutual key proof before any state is trusted
                await self._exchange_confirm(stream, conn._onwire,
                                             send_first=False)
        except MessengerError:
            # covers the secure-mode checks too: a leaked accept task
            # would otherwise keep a dead server-side session alive
            if accept_task is not None:
                accept_task.cancel()
            raise
        conn._attach(stream, peer["in_seq"])
        if self.dispatcher is not None:
            self.dispatcher.ms_handle_connect(conn)

    # -- secure mode (reference msg/async/crypto_onwire.{h,cc}: AES-GCM
    # on-wire encryption negotiated in the handshake) --------------------
    def _secure_wanted(self) -> bool:
        return bool(self.conf and self.conf["ms_secure_mode"])

    def _onwire_secret(self) -> str:
        # DELIBERATELY the shared deployment key only: per-entity cephx
        # keys differ on each end, so deriving from them would yield
        # mismatched GCM keys that fail every frame with no diagnostic
        # (per-entity secure mode needs ticket-negotiated session keys)
        return self.conf["auth_shared_key"] if self.conf else ""

    _CONFIRM_NONCE = (2**64 - 1).to_bytes(8, "little")
    _CONFIRM_TEXT = b"ceph-tpu-onwire-confirm"

    def _confirm_blob(self, onwire) -> bytes:
        aes, tx, _ = onwire
        return aes.encrypt(tx + self._CONFIRM_NONCE,
                           self._CONFIRM_TEXT, None)

    def _verify_confirm(self, onwire, blob: bytes) -> None:
        aes, _, rx = onwire
        try:
            if aes.decrypt(rx + self._CONFIRM_NONCE, blob, None) \
                    == self._CONFIRM_TEXT:
                return
        except Exception:
            pass
        raise MessengerError("onwire key confirmation failed")

    async def _exchange_confirm(self, stream: Stream, onwire,
                                send_first: bool) -> None:
        """Mutual key confirmation: each side proves it derived the
        same GCM key BEFORE any handshake field is acted upon — a
        keyless attacker can complete the plaintext hello exchange but
        never this, so forged in_seq/connect_seq values are discarded
        with the connection instead of purging/resetting live session
        state."""
        mine = self._confirm_blob(onwire)
        if send_first:
            stream.write(_LEN.pack(len(mine)) + mine)
            await stream.drain()
        (n,) = _LEN.unpack(await stream.read_exactly(_LEN.size))
        if n > 256:
            raise MessengerError("oversized confirm")
        self._verify_confirm(onwire, await stream.read_exactly(n))
        if not send_first:
            stream.write(_LEN.pack(len(mine)) + mine)
            await stream.drain()

    def _setup_onwire(self, conn: Connection, ours: dict,
                      theirs: dict) -> None:
        conn._onwire = self._derive_onwire(ours, theirs)

    def _derive_onwire(self, ours: dict, theirs: dict):
        """Derive per-connection AES-256-GCM state after the handshake.
        Both sides HKDF the deployment secret over the canonicalized
        FULL hello pair: the per-session random salts make every
        (re)connection's key fresh (seq-based nonces can never repeat
        under one key), and binding entity/nonce/in_seq/connect_seq
        into the derivation means a tampered handshake yields
        mismatched keys — frames fail authentication instead of the
        peer acting on forged session state."""
        want = self._secure_wanted()
        if bool(theirs.get("secure")) != want:
            raise MessengerError(
                "secure-mode mismatch with peer "
                f"{theirs.get('entity')!r} (ours={want})"
            )
        if not want:
            return None
        secret = self._onwire_secret()
        if not secret:
            raise MessengerError(
                "ms_secure_mode requires auth_shared_key"
            )
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        from cryptography.hazmat.primitives.kdf.hkdf import HKDF

        def canon(h: dict) -> tuple:
            return (str(h.get("entity")), int(h.get("nonce", 0)),
                    int(h.get("in_seq", 0)),
                    int(h.get("connect_seq", -1)),
                    str(h.get("session_salt", "")))

        pair = sorted([canon(ours), canon(theirs)])
        key = HKDF(
            algorithm=hashes.SHA256(), length=32,
            salt=b"ceph-tpu-onwire-v1",
            info=repr(pair).encode(),
        ).derive(secret.encode())
        lower = canon(ours) == pair[0]
        tx = b"\x00\x00\x00" + (b"\x00" if lower else b"\x01")
        rx = b"\x00\x00\x00" + (b"\x01" if lower else b"\x00")
        return (AESGCM(key), tx, rx)

    def _make_hello(self, in_seq: int, connect_seq: int) -> dict:
        hello = {
            "entity": self.name, "nonce": self.nonce, "in_seq": in_seq,
            "connect_seq": connect_seq,
            "secure": self._secure_wanted(),
        }
        if hello["secure"]:
            # fresh per-session randomness: every (re)connection's GCM
            # key differs, so seq-based nonces never repeat under a key
            import secrets

            hello["session_salt"] = secrets.token_hex(16)
        return hello

    async def _handshake(self, stream: Stream, in_seq: int,
                         connect_seq: int) -> tuple[dict, dict]:
        ours = self._make_hello(in_seq, connect_seq)
        hello = encode(ours)
        stream.write(BANNER + _LEN.pack(len(hello)) + hello)
        await stream.drain()
        banner = await stream.read_exactly(len(BANNER))
        if banner != BANNER:
            raise MessengerError(f"bad banner {banner!r}")
        (n,) = _LEN.unpack(await stream.read_exactly(_LEN.size))
        try:
            peer = decode(await stream.read_exactly(n))
        except (ValueError, TypeError, KeyError, IndexError,
                struct.error) as e:
            # a truncated/garbled hello raises codec errors, not just
            # MessengerError — must not escape as a reader-task crash
            raise MessengerError(f"bad handshake payload: {e}") from e
        if not isinstance(peer, dict) or "entity" not in peer:
            raise MessengerError("bad handshake payload")
        return ours, peer

    # -- incoming --------------------------------------------------------
    async def _on_tcp_accept(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        peername = writer.get_extra_info("peername") or ("?", 0)
        await self._accept_stream(
            TcpStream(reader, writer), f"tcp-in://{peername[0]}:{peername[1]}"
        )

    async def _accept_stream(self, stream: Stream, hint: str) -> None:
        if self._stopped:
            stream.close()
            return
        if fp.ACTIVE:
            try:
                await fp.fire("msgr.accept")
            except fp.FailPointError as e:
                log.dout(10, "%s: accept rejected by failpoint: %s",
                         self.name, e)
                stream.close()
                return
        try:
            # read peer hello first so our reply can ride session state
            banner = await stream.read_exactly(len(BANNER))
            if banner != BANNER:
                raise MessengerError(f"bad banner {banner!r}")
            (n,) = _LEN.unpack(await stream.read_exactly(_LEN.size))
            peer = decode(await stream.read_exactly(n))
            peer_name = str(peer["entity"])
            # session identity is (entity, nonce) — the reference's
            # addr+nonce. Name alone would let two concurrent clients
            # with the same entity name (or a restarted daemon) reset
            # each other's live sessions in a loop.
            akey = (peer_name, int(peer.get("nonce", 0)))
            existing = self._accepted.get(akey)
            reset = existing is not None \
                and peer.get("connect_seq", 0) == 0
            reuse = (existing is not None and not reset
                     and not existing.is_closed)
            # NOTHING destructive happens yet: in secure mode the peer
            # must first prove it derived the same key, or a keyless
            # attacker replaying/forging a hello could reset a live
            # session (connect_seq=0) or purge its unacked queue
            ours = self._make_hello(
                existing.in_seq if reuse else 0, -1
            )
            hello = encode(ours)
            stream.write(BANNER + _LEN.pack(len(hello)) + hello)
            await stream.drain()
            onwire = self._derive_onwire(ours, peer)
            if onwire is not None:
                await self._exchange_confirm(stream, onwire,
                                             send_first=True)
            if reset:
                # peer started a NEW session (its connect_seq reset):
                # our old session state is stale — drop it (ProtocolV2
                # RESETSESSION semantics)
                existing.mark_down()
            if reuse:
                conn = existing
                conn._stop_io()
                conn._teardown_stream()
                fresh = False
            else:
                conn = Connection(
                    self, peer_name, hint, self._policy_for(peer_name),
                    initiator=False,
                )
                conn.peer_nonce = akey[1]
                conn._accept_key = akey
                self._accepted[akey] = conn
                fresh = True
            conn._onwire = onwire
            conn._attach(stream, peer["in_seq"])
            conn._start_io()
            if fresh and self.dispatcher is not None:
                self.dispatcher.ms_handle_connect(conn)
        except (MessengerError, KeyError, TypeError, ValueError,
                IndexError, struct.error) as e:
            log.dout(10, "%s: accept failed: %s", self.name, e)
            stream.close()

    # -- delivery --------------------------------------------------------
    async def _deliver(self, conn: Connection, msg: Message) -> None:
        if fp.ACTIVE:
            try:
                await fp.fire("msgr.deliver")
            except fp.FailPointError as e:
                log.dout(10, "%s: dropping %s (failpoint: %s)",
                         self.name, msg.type, e)
                return
        delay_max = self.conf["ms_inject_delay_max"] if self.conf else 0.0
        if delay_max:
            await asyncio.sleep(self._rng.random() * delay_max)
        if self.dispatcher is None:
            log.dout(1, "%s: no dispatcher, dropping %s", self.name, msg.type)
            return
        tctx = (SpanCtx.from_wire(msg.data.get("tctx"))
                if isinstance(msg.data, dict) else None)
        t0 = time.perf_counter()
        try:
            if tctx is not None:
                with self.tracer.span("msgr:dispatch", parent=tctx,
                                      ambient=True, type=msg.type):
                    await self.dispatcher.ms_dispatch(conn, msg)
            else:
                await self.dispatcher.ms_dispatch(conn, msg)
        except Exception:
            log.derr("%s: dispatch of %s failed", self.name, msg.type)
        finally:
            self.perf.inc("dispatch")
            self.perf.hinc("dispatch_latency_us",
                           (time.perf_counter() - t0) * 1e6)

    def _maybe_inject_failure(self, point: str = "msgr.send") -> None:
        # named failpoints are the unified injection path; the legacy
        # ms_inject_socket_failures knob remains a per-messenger alias
        if fp.ACTIVE:
            try:
                fp.fire_sync(point)
            except fp.FailPointError as e:
                raise MessengerError(
                    f"injected socket failure ({e})") from None
        n = self.conf["ms_inject_socket_failures"] if self.conf else 0
        if n and self._rng.randrange(n) == 0:
            raise MessengerError("injected socket failure")

    def _forget(self, conn: Connection) -> None:
        if self._conns.get(conn.peer_addr) is conn:
            del self._conns[conn.peer_addr]
        akey = getattr(conn, "_accept_key", None)
        if akey is not None and self._accepted.get(akey) is conn:
            del self._accepted[akey]

    def _notify_reset(self, conn: Connection) -> None:
        if self.dispatcher is not None:
            self.dispatcher.ms_handle_reset(conn)
