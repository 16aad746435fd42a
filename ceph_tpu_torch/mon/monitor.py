"""Monitor daemon: sessions, command routing, subscriptions, liveness.

Counterpart of ceph_tpu/mon/monitor.py: the same module over the
port's imports.

Reference src/mon/Monitor.{h,cc}: elections fix a leader; the leader owns
paxos proposals and mutating commands; peons serve reads and forward
mutations (Monitor::forward_request_leader), with replies routed back;
all daemons keep subscriptions (osdmap/config/monmap) that the monitor
pushes on every commit; leases double as quorum liveness. Auth is a
shared-key challenge/response (CephX-lite: proves key possession without
sending it; the full ticket infrastructure of src/auth/cephx is not
replicated).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import secrets

from ceph_tpu_torch.common import failpoint as fp
from ceph_tpu_torch.common.lockdep import DLock
from ceph_tpu_torch.common.config import ConfigProxy
from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.mon.auth_monitor import AuthMonitor, cap_allows
from ceph_tpu_torch.mon.config_monitor import ConfigMonitor
from ceph_tpu_torch.mon.election import Elector
from ceph_tpu_torch.mon.health_monitor import HealthMonitor
from ceph_tpu_torch.mon.log_monitor import LogMonitor
from ceph_tpu_torch.mon.mds_monitor import MDSMonitor
from ceph_tpu_torch.mon.mgr_stat import MgrStatMonitor
from ceph_tpu_torch.mon.osd_monitor import OSDMonitor
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.mon.service import EPERM_RC, CommandResult, EINVAL_RC
from ceph_tpu_torch.mon.sync import MonSync
from ceph_tpu_torch.mon.store import MonitorDBStore, StoreTransaction
from ceph_tpu_torch.common.events import EventJournal
from ceph_tpu_torch.common.tracing import Tracer
from ceph_tpu_torch.msg.codec import encode as codec_encode
from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy

log = Dout("mon")

EAGAIN_RC = -11


def auth_proof(key: str, entity: str, nonce: str) -> str:
    return hmac.new(
        key.encode(), f"{entity}:{nonce}".encode(), hashlib.sha256
    ).hexdigest()


def sign_mon_message(key: str, mtype: str, data: dict) -> str:
    """HMAC over the canonical codec form of a mon-internal message, so
    election/paxos/forward traffic can't be injected by merely claiming a
    mon entity name in the messenger handshake. (Replay of a captured
    message is bounded by the pn/epoch/version staleness checks in the
    paxos and election handlers.)"""
    body = codec_encode(
        [mtype, {k: data[k] for k in data if k != "sig"}]
    )
    return hmac.new(key.encode(), body, hashlib.sha256).hexdigest()


class MonSession:
    def __init__(self, conn: Connection):
        self.conn = conn
        self.entity = conn.peer_name
        self.authenticated = False
        self.challenge: str | None = None
        self.caps: dict[str, str] = {}       # cephx: the entity's caps
        self.subs: dict[str, int] = {}       # what -> epoch client has


class Monitor:
    def __init__(self, name: str, monmap: dict[str, str],
                 conf: ConfigProxy | None = None,
                 store_path: str | None = None):
        self.name = name                      # short name, e.g. "a"
        self.monmap = dict(monmap)            # name -> addr
        self.conf = conf or ConfigProxy()
        self.store = MonitorDBStore(store_path)
        self.msgr = Messenger(f"mon.{name}", self.conf)
        self.msgr.set_policy("client", Policy.stateless_server())
        self.msgr.set_policy("osd", Policy.stateless_server())
        self.msgr.set_policy("mgr", Policy.stateless_server())
        self.msgr.set_dispatcher(self)
        self.elector = Elector(self)
        self.elector.on_win = self._on_win
        self.elector.on_lose = self._on_lose
        self.paxos = Paxos(self, self.store)
        self.paxos.on_commit = self._on_paxos_commit
        # span collector: paxos commits record here; ``trace collect``
        # pulls the ring via the "dump_traces" mon command
        self.tracer = Tracer(f"mon.{name}")
        self.paxos.tracer = self.tracer
        # flight recorder: map commits and health-check transitions
        # land here; snapshotted into forensic bundles via the
        # "dump_events" mon command
        self.journal = EventJournal(
            f"mon.{name}", size=int(self.conf["event_journal_size"]))
        self.sync = MonSync(self)
        self.osd_monitor = OSDMonitor(self)
        self.config_monitor = ConfigMonitor(self)
        self.auth_monitor = AuthMonitor(self)
        self.log_monitor = LogMonitor(self)
        self.health_monitor = HealthMonitor(self)
        self.mgr_stat = MgrStatMonitor(self)
        self.mds_monitor = MDSMonitor(self)
        self.services = {
            "osd": self.osd_monitor, "config": self.config_monitor,
            "auth": self.auth_monitor, "log": self.log_monitor,
            "health": self.health_monitor, "mgr": self.mgr_stat,
            "fs": self.mds_monitor,
        }
        # cluster-log entries queued by local subsystems (health
        # transitions etc.), drained into one paxos propose per tick
        self._pending_logs: list[dict] = []
        self.sessions: dict[int, MonSession] = {}
        self._routes: dict[int, tuple[Connection, dict]] = {}
        self._next_rtid = 0
        self._last_lease = 0.0                # peon: last lease seen
        self._lease_acks: dict[str, float] = {}
        # serializes stage-pending -> encode -> propose so two concurrent
        # mutations can't both build epoch N+1 and lose one's changes
        self._mutate_lock = DLock("mon-mutate")
        self._tasks: list[asyncio.Task] = []
        self._send_tasks: set[asyncio.Task] = set()
        self._genesis_inflight = False
        self._propose_timer: asyncio.Task | None = None
        self._stopped = False

    # -- identity ---------------------------------------------------------
    @property
    def rank(self) -> int:
        return sorted(self.monmap).index(self.name)

    def rank_of(self, name: str) -> int:
        return sorted(self.monmap).index(name)

    def peer_names(self) -> list[str]:
        return [n for n in self.monmap if n != self.name]

    @property
    def is_leader(self) -> bool:
        return (not self.elector.electing
                and self.elector.leader == self.name)

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> None:
        if self.cephx and not self.conf["auth_admin_key"]:
            # mon-internal signing derives from this key under cephx;
            # without it peer identity would rest on the client-chosen
            # handshake name
            raise ValueError(
                "auth_cluster_required=cephx requires auth_admin_key "
                "(the mon keyring)"
            )
        fp.apply_conf(self.conf)
        await self.msgr.bind(self.monmap[self.name])
        for svc in self.services.values():
            svc.refresh()
        self.elector.start()
        self._tasks.append(asyncio.create_task(self._tick_loop()))
        run_dir = self.conf["admin_socket_dir"]
        if run_dir:
            from ceph_tpu_torch.common.admin_socket import AdminSocket

            sock = AdminSocket(f"mon.{self.name}")
            sock.register("mon_status", lambda: {
                "name": self.name, "rank": self.rank,
                "quorum": self.elector.quorum,
                "leader": self.elector.leader,
                "election_epoch": self.elector.epoch,
                "paxos_last_committed": self.paxos.last_committed,
            }, "monitor state")
            sock.register("quorum_status", lambda: {
                "quorum": self.elector.quorum,
                "leader": self.elector.leader,
            }, "quorum view")
            sock.register("config show", self.conf.show,
                          "live configuration")
            sock.register("health", self.health_monitor.summary,
                          "aggregated health")
            from ceph_tpu_torch.common.log import recent_lines
            sock.register("log dump", recent_lines,
                          "recent log ring (crash context)")
            sock.register("events dump", lambda: {
                "stats": self.journal.stats(),
                "events": self.journal.snapshot(),
            }, "flight-recorder event journal (full ring)")
            fp.register_admin_commands(sock)
            await sock.start(run_dir)
            self.admin_socket = sock
        else:
            self.admin_socket = None

    async def shutdown(self) -> None:
        self._stopped = True
        self.elector.stop()
        self.sync.stop()
        if self._propose_timer is not None:
            self._propose_timer.cancel()
        for t in self._tasks:
            t.cancel()
        for t in list(self._send_tasks):
            t.cancel()
        if getattr(self, "admin_socket", None) is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        await self.msgr.shutdown()
        self.store.close()

    def bootstrap(self) -> None:
        """Quorum is suspect: call a new election (Monitor::bootstrap)."""
        if self._stopped:
            return
        if self.sync.syncing:
            # mid-store-sync our state is unusable for elections; the
            # sync completion path bootstraps when the store is whole
            return
        self.paxos.ready = False
        self.elector.start()

    # -- messaging helpers ------------------------------------------------
    def _internal_key(self) -> str:
        """The mon-cluster-internal signing key: the legacy shared key,
        or (cephx) the admin bootstrap key every monitor holds (the mon.
        keyring role) — signing must NOT turn off just because the
        legacy key is empty."""
        return (self.conf["auth_shared_key"]
                or (self.conf["auth_admin_key"] if self.cephx else ""))

    def send_mon(self, peer: str, msg: Message) -> None:
        msg.data.setdefault("from", self.name)
        key = self._internal_key()
        if key:
            msg.data["sig"] = sign_mon_message(key, msg.type, msg.data)
        addr = self.monmap.get(peer)
        if addr is None:
            return

        async def _send():
            try:
                await self.msgr.send_to(addr, msg, f"mon.{peer}")
            except (ConnectionError, OSError) as e:
                log.dout(10, "%s: send to mon.%s failed: %s",
                         self.name, peer, e)

        task = asyncio.get_running_loop().create_task(_send())
        self._send_tasks.add(task)
        task.add_done_callback(self._send_tasks.discard)

    # -- election/paxos callbacks -----------------------------------------
    async def _on_win(self) -> None:
        self._lease_acks = {}
        await self.paxos.leader_init()

    async def _on_lose(self) -> None:
        self.osd_monitor.pending = None
        self._last_lease = asyncio.get_running_loop().time()
        await self.paxos.peon_init()

    async def _on_paxos_commit(self) -> None:
        for svc in self.services.values():
            svc.refresh()
        self._push_subscriptions()
        if (self.is_leader and self.paxos.ready
                and self.osd_monitor.osdmap.epoch == 0
                and not self._genesis_inflight):
            self._genesis_inflight = True
            asyncio.get_running_loop().create_task(self._propose_genesis())

    async def _propose_genesis(self) -> None:
        try:
            # under _mutate_lock: a concurrently staged boot incremental
            # must serialize on a distinct epoch, not race genesis to
            # epoch 1 and silently overwrite it
            async with self._mutate_lock:
                if self.store.get_int("osdmap", "last_committed") > 0:
                    return
                tx = StoreTransaction()
                for svc in self.services.values():
                    svc.create_initial(tx)
                log.dout(1, "%s: creating genesis cluster maps", self.name)
                await self.paxos.propose(tx)
        except ConnectionError:
            pass
        finally:
            self._genesis_inflight = False

    async def propose_pending(self) -> None:
        """Commit any staged OSDMonitor incremental / FSMap change."""
        tx = StoreTransaction()
        changed = self.osd_monitor.encode_pending(tx)
        changed = self.mds_monitor.encode_pending(tx) or changed
        if changed:
            await self.paxos.propose(tx)

    # -- tick / leases -----------------------------------------------------
    async def _tick_loop(self) -> None:
        interval = self.conf["mon_tick_interval"]
        lease_int = self.conf["mon_lease_interval"]
        lease = self.conf["mon_lease"]
        loop = asyncio.get_running_loop()
        last_lease_sent = 0.0
        self._last_lease = loop.time()
        while not self._stopped:
            try:
                await asyncio.sleep(min(interval, lease_int))
            except asyncio.CancelledError:
                return
            now = loop.time()
            if self.is_leader:
                if now - last_lease_sent >= lease_int:
                    last_lease_sent = now
                    for peer in self.elector.quorum:
                        if peer != self.name:
                            # baseline so a peer that never acks is
                            # eventually declared dead
                            self._lease_acks.setdefault(peer, now)
                            self.send_mon(peer, Message("paxos_lease", {
                                "lc": self.paxos.last_committed,
                            }))
                dead = [
                    p for p in self.elector.quorum
                    if p != self.name
                    and now - self._lease_acks.get(p, now) > lease * 3
                ]
                if dead:
                    log.dout(1, "%s: lost contact with %s, re-electing",
                             self.name, dead)
                    self.bootstrap()
                    continue
                try:
                    async with self._mutate_lock:
                        await self.osd_monitor.tick()
                        await self.mds_monitor.tick()
                        if self.cephx:
                            tx = StoreTransaction()
                            if self.auth_monitor.maybe_rotate(tx):
                                await self.paxos.propose(tx)
                        # health transitions -> cluster log + mute expiry
                        logs, mutations = \
                            self.health_monitor.tick_transitions()
                        self._pending_logs.extend(logs)
                        if self._pending_logs or mutations:
                            tx = StoreTransaction()
                            self.log_monitor.stage_entries(
                                self._pending_logs, tx
                            )
                            self._pending_logs = []
                            for key, val in mutations.items():
                                tx.put(self.health_monitor.prefix, key,
                                       val)
                            if not tx.empty():
                                await self.paxos.propose(tx)
                except ConnectionError:
                    pass
            elif self.elector.in_quorum():
                if now - self._last_lease > lease * 3:
                    log.dout(1, "%s: lease expired, re-electing", self.name)
                    self.bootstrap()
                elif self._pending_logs and \
                        self.elector.leader is not None:
                    # peon-queued cluster-log entries ride to the leader
                    entries, self._pending_logs = self._pending_logs, []
                    self.send_mon(
                        self.elector.leader, Message("mon_forward", {
                            "rtid": 0, "itype": "log",
                            "idata": {"entries": entries},
                            "reply_type": "",
                        })
                    )

    # -- dispatcher -------------------------------------------------------
    def ms_handle_connect(self, conn: Connection) -> None:
        pass

    def ms_handle_reset(self, conn: Connection) -> None:
        self.sessions.pop(id(conn), None)

    def _session(self, conn: Connection) -> MonSession:
        s = self.sessions.get(id(conn))
        if s is None:
            s = MonSession(conn)
            self.sessions[id(conn)] = s
        return s

    def _is_mon_peer(self, conn: Connection, msg: Message) -> bool:
        sender = msg.data.get("from", "")
        if sender not in self.monmap or conn.peer_name != f"mon.{sender}":
            return False
        key = self._internal_key()
        if key:
            want = sign_mon_message(key, msg.type, msg.data)
            if not hmac.compare_digest(want,
                                       str(msg.data.get("sig", ""))):
                log.derr("%s: bad mon message signature from %s (%s)",
                         self.name, sender, msg.type)
                return False
        return True

    async def ms_dispatch(self, conn: Connection, msg: Message) -> None:
        t = msg.type
        if t.startswith("election_"):
            if self._is_mon_peer(conn, msg):
                await self.elector.handle(msg)
            return
        if t.startswith("paxos_"):
            if self._is_mon_peer(conn, msg):
                await self._dispatch_paxos(msg)
            return
        if t.startswith("mon_sync_"):
            if self._is_mon_peer(conn, msg):
                await self._dispatch_sync(msg)
            return
        if t == "mon_forward":
            # forwarded ops can block on a paxos commit whose accepts ride
            # this very connection — never run them inside the reader loop
            if self._is_mon_peer(conn, msg):
                asyncio.get_running_loop().create_task(
                    self._handle_forward(conn, msg)
                )
            return
        if t == "mon_route_reply":
            if self._is_mon_peer(conn, msg):
                self._handle_route_reply(msg)
            return
        session = self._session(conn)
        if t == "auth":
            self._handle_auth(session, msg)
            return
        if not session.authenticated and (self.conf["auth_shared_key"]
                                          or self.cephx):
            session.conn.send_message(Message(
                "auth_bad", {"reason": "unauthenticated"}
            ))
            return
        loop = asyncio.get_running_loop()
        if t == "mon_subscribe":
            self._handle_subscribe(session, msg)
        elif t == "mon_command":
            # commands block on commits: keep the reader loop free
            loop.create_task(self._handle_command(session.conn, msg.data,
                                                  session))
        elif t == "osd_boot":
            if self._osd_identity_ok(session, msg.data.get("id")):
                loop.create_task(
                    self._handle_osd_boot(session.conn, msg.data)
                )
        elif t == "osd_failure":
            if self._osd_identity_ok(session, None):
                loop.create_task(self._handle_osd_failure(msg.data))
        elif t == "osd_beacon":
            # MOSDBeacon: periodic daemon health digest (slow-op
            # counts) feeding the SLOW_OPS health check; fire-and-
            # forget, identity-gated like failure reports
            if self._osd_identity_ok(session, msg.data.get("id")):
                loop.create_task(self._handle_osd_beacon(msg.data))
        elif t == "mds_beacon":
            # MMDSBeacon: liveness + registration.  Every mon acks with
            # its fsmap view of the sender's state — the daemon detects
            # standby->active transitions from the ack stream even when
            # the leader's one-shot takeover notify was lost.
            loop.create_task(self._handle_mds_beacon(msg.data))
            info = self.mds_monitor.mds.get(str(msg.data.get("name")))
            if info is not None:
                self._reply(conn, Message("mds_beacon_ack", {
                    "state": info["state"],
                    "rank": int(info.get("rank", 0)),
                    "epoch": self.mds_monitor.epoch,
                }))
        elif t == "log":
            # MLog: daemons submit cluster-log batches.  The entries'
            # 'who' is forced to the PROVEN session entity so a client
            # cannot forge attribution into the operator's log.
            entries = [
                {**e, "who": session.entity}
                for e in msg.data.get("entries", ())
                if isinstance(e, dict)
            ]
            loop.create_task(self._handle_log({"entries": entries}))
        else:
            log.dout(5, "%s: ignoring %s from %s", self.name, t,
                     conn.peer_name)

    def _osd_identity_ok(self, session: MonSession,
                         claimed_id) -> bool:
        """Boot/failure reports come from OSD daemons: under cephx the
        PROVEN session entity must be an osd (and a boot must name its
        own id) — a low-privilege client must not mark OSDs down or
        boot fakes."""
        if not self.cephx:
            return True
        etype, _, eid = session.entity.partition(".")
        if etype != "osd":
            log.derr("%s: dropping osd report from %s", self.name,
                     session.entity)
            return False
        if claimed_id is not None and str(claimed_id) != eid:
            log.derr("%s: %s tried to boot osd.%s", self.name,
                     session.entity, claimed_id)
            return False
        return True

    async def _dispatch_sync(self, msg: Message) -> None:
        t = msg.type
        if t == "mon_sync_advise":
            self.sync.maybe_start(msg.data["from"],
                                  int(msg.data["lc"]))
        elif t == "mon_sync_start":
            await self.sync.handle_start(msg)
        elif t == "mon_sync_chunk":
            await self.sync.handle_chunk(msg)
        elif t == "mon_sync_chunk_ack":
            await self.sync.handle_ack(msg)

    async def _dispatch_paxos(self, msg: Message) -> None:
        if self.sync.syncing:
            # a half-replaced store must neither accept nor share paxos
            # state; the completion path re-elects and catches up
            return
        if msg.type == "paxos_lease":
            # only the mon we believe leads may extend our lease — a lease
            # from anyone else means quorum views diverged
            if msg.data["from"] == self.elector.leader:
                self._last_lease = asyncio.get_running_loop().time()
                self.send_mon(msg.data["from"],
                              Message("paxos_lease_ack", {}))
            return
        if msg.type == "paxos_lease_ack":
            self._lease_acks[msg.data["from"]] = \
                asyncio.get_running_loop().time()
            return
        handler = {
            "paxos_collect": self.paxos.handle_collect,
            "paxos_last": self.paxos.handle_last,
            "paxos_begin": self.paxos.handle_begin,
            "paxos_accept": self.paxos.handle_accept,
            "paxos_commit": self.paxos.handle_commit,
            "paxos_nak": self.paxos.handle_nak,
        }.get(msg.type)
        if handler is not None:
            await handler(msg)

    # -- auth -------------------------------------------------------------
    @property
    def cephx(self) -> bool:
        return self.conf["auth_cluster_required"] == "cephx"

    def _handle_auth(self, session: MonSession, msg: Message) -> None:
        entity = str(msg.data.get("entity", session.entity))
        if self.cephx:
            self._handle_auth_cephx(session, entity, msg)
            return
        key = self.conf["auth_shared_key"]
        if not key:
            session.authenticated = True
            session.conn.send_message(Message("auth_reply", {"ok": True}))
            return
        proof = msg.data.get("proof")
        if proof is None:
            session.challenge = secrets.token_hex(16)
            session.conn.send_message(Message(
                "auth_challenge", {"nonce": session.challenge}
            ))
            return
        want = (auth_proof(key, entity, session.challenge)
                if session.challenge else None)
        if want is not None and hmac.compare_digest(want, str(proof)):
            session.authenticated = True
            session.conn.send_message(Message("auth_reply", {"ok": True}))
        else:
            session.conn.send_message(Message(
                "auth_reply", {"ok": False, "reason": "bad proof"}
            ))

    def _handle_auth_cephx(self, session: MonSession, entity: str,
                           msg: Message) -> None:
        """Per-entity challenge/response against the AuthMonitor key
        database; success issues an OSD service ticket + session key
        (the CephxServiceTicket grant)."""
        key = self.auth_monitor.get_key(entity)
        proof = msg.data.get("proof")
        if proof is None:
            session.challenge = secrets.token_hex(16)
            session.conn.send_message(Message(
                "auth_challenge", {"nonce": session.challenge}
            ))
            return
        want = (auth_proof(key, entity, session.challenge)
                if key and session.challenge else None)
        if want is None or not hmac.compare_digest(want, str(proof)):
            session.conn.send_message(Message(
                "auth_reply", {"ok": False, "reason": "bad credentials"}
            ))
            return
        session.authenticated = True
        # bind the PROVEN identity: gates must never trust the client-
        # chosen messenger handshake name
        session.entity = entity
        session.caps = {
            s: str(c)
            for s, c in self.auth_monitor.get_caps(entity).items()
        }
        reply = {"ok": True, "caps": dict(session.caps)}
        issued = self.auth_monitor.issue_osd_ticket(entity)
        if issued is not None:
            reply["osd_ticket"], reply["osd_session_key"] = issued
        session.conn.send_message(Message("auth_reply", reply))

    # -- subscriptions ----------------------------------------------------
    def _handle_subscribe(self, session: MonSession, msg: Message) -> None:
        for what, have in msg.data.get("what", {}).items():
            session.subs[what] = int(have)
        self._push_to_session(session)

    def _push_subscriptions(self) -> None:
        for session in list(self.sessions.values()):
            self._push_to_session(session)

    def _push_to_session(self, session: MonSession) -> None:
        if session.conn.is_closed:
            self.sessions.pop(id(session.conn), None)
            return
        subs = session.subs
        try:
            if "monmap" in subs and subs["monmap"] < 1:
                session.conn.send_message(Message("mon_map", {
                    "epoch": 1, "mons": dict(self.monmap),
                }))
                subs["monmap"] = 1
            if "osdmap" in subs:
                cur = self.osd_monitor.osdmap.epoch
                if cur > subs["osdmap"]:
                    incs = self.osd_monitor.incrementals_since(
                        subs["osdmap"]
                    ) if subs["osdmap"] > 0 else []
                    data = {"epoch": cur, "incrementals": incs}
                    if not incs:
                        data["full"] = self.osd_monitor.full_map_dict()
                    session.conn.send_message(Message("osd_map", data))
                    subs["osdmap"] = cur
            if "config" in subs:
                # versioned by paxos commit count: re-pushed after any
                # commit that could have changed the config db
                lc = max(1, self.paxos.last_committed)
                if lc > subs["config"]:
                    session.conn.send_message(Message("config", {
                        "values": self.config_monitor.snapshot(),
                    }))
                    subs["config"] = lc
        except ConnectionError:
            self.sessions.pop(id(session.conn), None)

    # -- commands ---------------------------------------------------------
    def _route_service(self, cmd: dict):
        prefix = str(cmd.get("prefix", ""))
        word = prefix.split(" ", 1)[0]
        # pgmap-digest reads and mgr-module surfaces live on the
        # mgr-stat service (PGMap / balancer / progress / crash)
        if word in ("pg", "df", "balancer", "progress", "crash",
                    "device", "telemetry", "orch", "insights",
                    "snap-schedule", "rbd", "iostat", "ts"):
            return self.mgr_stat
        if prefix.startswith("osd perf "):
            # mgr osd_perf_query module surface, not the OSDMonitor
            return self.mgr_stat
        if word == "config-key":
            return self.config_monitor
        if word == "mds":
            return self.mds_monitor
        return self.services.get(word)

    def _mon_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "status":
            om = self.osd_monitor.osdmap
            return CommandResult(data={
                "mon": {
                    "quorum": self.elector.quorum,
                    "leader": self.elector.leader,
                    "epoch": self.elector.epoch,
                },
                "osdmap": {
                    "epoch": om.epoch,
                    "num_osds": len(om.osds),
                    "num_up_osds": sum(
                        1 for o in om.osds.values() if o.up
                    ),
                    "num_in_osds": sum(
                        1 for o in om.osds.values() if o.in_cluster
                    ),
                    "num_pools": len(om.pools),
                },
                "pgmap": self.mgr_stat.pgmap_summary(),
                "health": self.health_monitor.summary(),
            })
        if name == "osd pool autoscale-status":
            return self.mgr_stat.preprocess_command(cmd)
        if name == "quorum_status":
            return CommandResult(data={
                "quorum": self.elector.quorum,
                "leader": self.elector.leader,
                "election_epoch": self.elector.epoch,
            })
        if name == "mon dump":
            return CommandResult(data={
                "epoch": 1, "mons": dict(self.monmap),
            })
        if name == "dump_traces":
            # this mon's span rings (daemon + messenger): one shard of
            # a cluster-wide ``trace collect`` reassembly
            tid = cmd.get("trace_id") or None
            return CommandResult(data={
                "spans": (self.tracer.dump(tid)
                          + self.msgr.tracer.dump(tid)),
            })
        if name == "dump_events":
            # this mon's flight-recorder ring (plus the process
            # journal: failpoint/chaos/mesh events shared by every
            # co-located daemon) — one shard of a forensic bundle
            from ceph_tpu_torch.common.events import proc_journal
            w = cmd.get("window_s")
            w = float(w) if w else None
            return CommandResult(data={
                "events": self.journal.snapshot(w),
                "proc_events": proc_journal().snapshot(w),
                "stats": self.journal.stats(),
            })
        return None

    def cluster_log(self, level: str, message: str,
                    who: str | None = None) -> None:
        """Queue a cluster-log entry; the next tick commits it (leader)
        or forwards it to the leader (peon).  Bounded: under a long
        election the oldest entries are dropped, not the process."""
        if len(self._pending_logs) >= 1000:
            del self._pending_logs[0]
        self._pending_logs.append({
            "who": who or f"mon.{self.name}",
            "level": level, "message": message,
        })

    def _preprocess_local(self, cmd: dict) -> CommandResult | None:
        svc = self._route_service(cmd)
        if svc is not None:
            r = svc.preprocess_command(cmd)
            if r is not None:
                return r
        return self._mon_command(cmd)

    async def _run_command(self, cmd: dict,
                           skip_preprocess: bool = False
                           ) -> CommandResult:
        if not skip_preprocess:
            r = self._preprocess_local(cmd)
            if r is not None:
                return r
        svc = self._route_service(cmd)
        if svc is None:
            return CommandResult(
                EINVAL_RC, f"unknown command {cmd.get('prefix')!r}"
            )
        if not self.is_leader:
            return CommandResult(EAGAIN_RC, "not leader")
        async with self._mutate_lock:
            tx = StoreTransaction()
            result = svc.prepare_command(cmd, tx)
            if result.rc == 0:
                self.osd_monitor.encode_pending(tx)
                if not tx.empty():
                    try:
                        await self.paxos.propose(tx)
                    except ConnectionError:
                        return CommandResult(EAGAIN_RC,
                                             "lost quorum mid-commit")
        return result

    def _caps_deny(self, session: MonSession | None, cmd: dict,
                   mutating: bool) -> CommandResult | None:
        """cephx MonCap enforcement: reads need any mon cap; anything
        that stages a mutation needs 'allow *' (or 'allow rw')."""
        if not self.cephx or session is None:
            return None
        prefix = str(cmd.get("prefix", ""))
        mon_cap = session.caps.get("mon", "")
        if prefix == "auth service-secrets":
            # service daemons only: the rotating secrets let the holder
            # verify and mint session keys
            etype = session.entity.split(".", 1)[0]
            if etype in ("osd", "mds", "mgr") or                     cap_allows(mon_cap, write=True):
                return None
            return CommandResult(EPERM_RC, "not a service daemon")
        if prefix.startswith("auth"):
            # key-database access exposes secrets: admin-only
            # (the reference gates auth commands behind dedicated caps)
            if cap_allows(mon_cap, write=True):
                return None
            return CommandResult(
                EPERM_RC, f"auth commands need 'allow *' mon caps"
            )
        if not cap_allows(mon_cap, write=mutating):
            return CommandResult(
                EPERM_RC,
                f"entity {session.entity!r} lacks mon caps for "
                f"{prefix!r}",
            )
        return None

    async def _handle_command(self, conn: Connection, data: dict,
                              session: MonSession | None = None) -> None:
        cmd = data.get("cmd", {})
        tid = data.get("tid", 0)
        # preprocess ONCE: the result both classifies mutating-ness for
        # the caps check and serves the read fast path
        pre = self._preprocess_local(cmd)
        denied = self._caps_deny(session, cmd, mutating=pre is None)
        if denied is not None:
            self._reply(conn, Message("mon_command_reply",
                                      {"tid": tid, **denied.to_wire()}))
            return
        if not (self.is_leader or self.elector.in_quorum()):
            # even reads must not be served from a partitioned monitor's
            # stale state
            result = CommandResult(EAGAIN_RC, "not in quorum")
        elif cmd.get("prefix") == "auth service-secrets":
            result = CommandResult(
                data={str(e): s for e, s in
                      self.auth_monitor.secrets_snapshot().items()}
            )
        elif pre is not None:
            result = pre
        elif self.is_leader:
            result = await self._run_command(cmd, skip_preprocess=True)
        elif (self.elector.leader is not None
                and not self.elector.electing):
            self._forward(conn, "mon_command", data,
                          "mon_command_reply")
            return
        else:
            result = CommandResult(EAGAIN_RC, "no quorum")
        self._reply(conn, Message("mon_command_reply",
                                  {"tid": tid, **result.to_wire()}))

    def _reply(self, conn: Connection, msg: Message) -> None:
        try:
            conn.send_message(msg)
        except ConnectionError:
            pass

    # -- forwarding (peon -> leader) --------------------------------------
    def _forward(self, conn: Connection, itype: str, idata: dict,
                 reply_type: str) -> None:
        self._next_rtid += 1
        rtid = self._next_rtid
        self._routes[rtid] = (conn, idata)
        self.send_mon(self.elector.leader, Message("mon_forward", {
            "rtid": rtid, "itype": itype, "idata": idata,
            "reply_type": reply_type,
        }))

    async def _handle_forward(self, conn: Connection, msg: Message) -> None:
        itype = msg.data["itype"]
        idata = msg.data["idata"]
        rtid = msg.data["rtid"]
        reply_type = msg.data.get("reply_type", "")
        if itype == "mon_command":
            result = await self._run_command(idata.get("cmd", {}))
            payload = {"tid": idata.get("tid", 0), **result.to_wire()}
        elif itype == "osd_boot":
            payload = await self._prepare_boot(idata)
        elif itype == "osd_failure":
            await self._prepare_failure(idata)
            payload = None
        elif itype == "log":
            await self._handle_log(idata)
            payload = None
        elif itype == "mds_beacon":
            await self._handle_mds_beacon(idata)
            payload = None
        elif itype == "osd_beacon":
            await self._handle_osd_beacon(idata)
            payload = None
        else:
            payload = None
        if reply_type and payload is not None:
            self.send_mon(msg.data["from"], Message("mon_route_reply", {
                "rtid": rtid, "reply_type": reply_type, "payload": payload,
            }))

    def _handle_route_reply(self, msg: Message) -> None:
        route = self._routes.pop(int(msg.data["rtid"]), None)
        if route is None:
            return
        conn, _ = route
        self._reply(conn, Message(msg.data["reply_type"],
                                  dict(msg.data["payload"])))

    # -- osd boot / failure ------------------------------------------------
    async def _prepare_boot(self, data: dict) -> dict:
        osd_id = int(data["id"])
        interval = float(self.conf["paxos_propose_interval"])
        async with self._mutate_lock:
            changed = self.osd_monitor.prepare_boot(
                osd_id, str(data["addr"]), str(data.get("host", ""))
            )
            if changed and interval <= 0:
                try:
                    await self.propose_pending()
                except ConnectionError:
                    return {"epoch": 0}
        if changed and interval > 0:
            # paxos_propose_interval: a 200-OSD boot storm staged one
            # propose per daemon would burn one paxos round + full
            # subscription fan-out PER OSD; the debounce folds every
            # boot that lands inside the window into one epoch.  The
            # ack needs no committed epoch — send_boot polls the map.
            self._propose_soon(interval)
        return {"epoch": self.osd_monitor.osdmap.epoch}

    def _propose_soon(self, delay: float) -> None:
        """Debounced propose_pending: one timer, any mutation staged
        while it runs rides the same commit."""
        if (self._propose_timer is not None
                and not self._propose_timer.done()):
            return

        async def run():
            await asyncio.sleep(delay)
            async with self._mutate_lock:
                try:
                    await self.propose_pending()
                except ConnectionError:
                    pass

        self._propose_timer = asyncio.get_running_loop().create_task(run())

    async def _handle_osd_boot(self, conn: Connection, data: dict) -> None:
        if self.is_leader:
            payload = await self._prepare_boot(data)
            self._reply(conn, Message("osd_boot_ack", payload))
        elif self.elector.leader is not None:
            self._forward(conn, "osd_boot", data, "osd_boot_ack")

    async def _prepare_failure(self, data: dict) -> None:
        interval = float(self.conf["paxos_propose_interval"])
        async with self._mutate_lock:
            changed = self.osd_monitor.prepare_failure(
                int(data["target"]), str(data.get("reporter", "")),
                float(data.get("failed_for", 0.0)),
            )
            if changed and interval <= 0:
                try:
                    await self.propose_pending()
                except ConnectionError:
                    pass
        if changed and interval > 0:
            # failure storms (rack pull) coalesce like boot storms do
            self._propose_soon(interval)

    async def _handle_mds_beacon(self, data: dict) -> None:
        name = str(data.get("name", ""))
        addr = str(data.get("addr", ""))
        fs = str(data.get("fs", ""))
        if not name or not addr:
            return
        if self.is_leader:
            try:
                async with self._mutate_lock:
                    if self.mds_monitor.handle_beacon(
                            name, addr, fs,
                            float(data.get("load", 0.0))):
                        await self.propose_pending()
            except ConnectionError:
                pass
        elif self.elector.leader is not None:
            self.send_mon(self.elector.leader, Message("mon_forward", {
                "rtid": 0, "itype": "mds_beacon", "idata": data,
                "reply_type": "",
            }))

    async def _handle_osd_beacon(self, data: dict) -> None:
        """Slow-op digest from an OSD.  Leader-local ephemeral state
        (no paxos propose — the reports age out on their own and are
        re-sent every heartbeat, so losing them on an election costs
        one beacon interval, not correctness)."""
        if self.is_leader:
            self.osd_monitor.note_beacon(data)
        elif self.elector.leader is not None:
            self.send_mon(self.elector.leader, Message("mon_forward", {
                "rtid": 0, "itype": "osd_beacon", "idata": data,
                "reply_type": "",
            }))

    async def _handle_log(self, data: dict) -> None:
        entries = [e for e in data.get("entries", [])
                   if isinstance(e, dict)]
        if not entries:
            return
        if self.is_leader:
            try:
                async with self._mutate_lock:
                    tx = StoreTransaction()
                    if self.log_monitor.stage_entries(entries, tx):
                        await self.paxos.propose(tx)
            except ConnectionError:
                pass
        elif self.elector.leader is not None:
            self.send_mon(self.elector.leader, Message("mon_forward", {
                "rtid": 0, "itype": "log",
                "idata": {"entries": entries}, "reply_type": "",
            }))

    async def _handle_osd_failure(self, data: dict) -> None:
        if self.is_leader:
            await self._prepare_failure(data)
        elif self.elector.leader is not None:
            self.send_mon(self.elector.leader, Message("mon_forward", {
                "rtid": 0, "itype": "osd_failure", "idata": data,
                "reply_type": "",
            }))
