"""AuthMonitor: the replicated key/caps database + CephX-lite tickets.

Counterpart of ceph_tpu/mon/auth_monitor.py: the same module over the
port's imports.

Reference src/mon/AuthMonitor.cc (entity key database, ``ceph auth
get-or-create/get/ls/caps/rm``) + src/auth/cephx/CephxProtocol.h:165-190
(ticket infrastructure) + CephxKeyServer rotating service secrets:

- Every ENTITY (client.x, osd.N, mds.a, ...) has its own secret key and
  a caps map ({"mon": "allow *", "osd": "allow rw pool=foo"}), stored in
  the monitor's replicated store via the PaxosService pattern.
- After a client proves possession of its entity key (challenge/
  response — the key never travels), the monitor issues an OSD SERVICE
  TICKET: a MAC-sealed blob naming the entity, its osd caps, an expiry,
  and a nonce, plus a SESSION KEY derived from the rotating service
  secret. OSDs hold the service secrets (fetched over their own
  authenticated mon session), so they can verify the ticket's MAC and
  re-derive the session key without talking to the monitor — the
  defining CephX property. (Tickets are authenticated, not encrypted:
  the -lite trust model is MAC integrity, matching the framework's
  unencrypted transport.)
- Service secrets ROTATE (CephxKeyServer rotating secrets): epoch-
  numbered, the previous epoch stays valid for one TTL so in-flight
  tickets survive a rotation.

Caps grammar (OSDCap/MonCap reduced): ``allow *`` | ``allow rw`` |
``allow r``, with an optional ``pool=<name>`` restriction for osd caps.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import secrets
import time

from ceph_tpu_torch.mon.service import (
    EINVAL_RC,
    ENOENT_RC,
    EPERM_RC,
    CommandResult,
    PaxosService,
)
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import encode as codec_encode

PREFIX = "auth"


def _mac(key: str, payload: bytes) -> str:
    return hmac.new(key.encode(), payload, hashlib.sha256).hexdigest()


def canonical(d: dict) -> bytes:
    """Deterministic byte form for MACs (sorted-key codec encoding)."""
    return codec_encode([[k, d[k]] for k in sorted(d)])


# -- caps ------------------------------------------------------------------

def parse_cap(spec: str) -> dict:
    """``allow *`` / ``allow rw [pool=name] [namespace=ns]`` ->
    {"perm": "*"|"rw"|"r", "pool": name|None, "namespace": ns|None}.
    No namespace clause matches every namespace; ``namespace=`` (empty)
    matches only the default one (reference OSDCap nspace semantics)."""
    parts = str(spec).split()
    if not parts or parts[0] != "allow" or len(parts) < 2:
        raise ValueError(f"bad cap spec {spec!r}")
    perm = parts[1]
    if perm not in ("*", "rw", "r"):
        raise ValueError(f"bad cap perm {perm!r}")
    pool = None
    namespace = None
    for extra in parts[2:]:
        if extra.startswith("pool="):
            pool = extra[len("pool="):]
        elif extra.startswith("namespace="):
            namespace = extra[len("namespace="):]
        else:
            raise ValueError(f"bad cap qualifier {extra!r}")
    return {"perm": perm, "pool": pool, "namespace": namespace}


def cap_allows(spec: str, write: bool, pool: str | None = None,
               namespace: str | None = None) -> bool:
    """Does a cap spec permit this access? Empty spec denies."""
    if not spec:
        return False
    try:
        cap = parse_cap(spec)
    except ValueError:
        return False
    if cap["pool"] is not None and pool is not None \
            and cap["pool"] != pool:
        return False
    if cap["namespace"] is not None and namespace is not None \
            and cap["namespace"] != namespace:
        return False
    if cap["perm"] == "*":
        return True
    if write:
        return cap["perm"] == "rw"
    return cap["perm"] in ("r", "rw")


# -- ticket sealing --------------------------------------------------------

def seal_ticket(secret: str, entity: str, caps_osd: str,
                epoch: int, ttl: float) -> tuple[dict, str]:
    """Build (ticket blob, session_key). The blob's MAC binds every
    field under the epoch's service secret; the session key is derived
    from the secret + nonce so the OSD can recompute it from the blob
    alone (CephxServiceTicket semantics)."""
    fields = {
        "entity": entity,
        "caps": caps_osd,
        "epoch": epoch,
        "expires": time.time() + ttl,
        "nonce": secrets.token_hex(16),
    }
    blob = dict(fields)
    blob["mac"] = _mac(secret, canonical(fields))
    session_key = _mac(secret, b"session:" + canonical(fields))
    return blob, session_key


def verify_ticket(secrets_by_epoch: dict[int, str],
                  blob: dict) -> tuple[str, str, str] | None:
    """OSD-side check: (entity, osd_caps, session_key) or None."""
    try:
        epoch = int(blob["epoch"])
        secret = secrets_by_epoch.get(epoch)
        if secret is None:
            return None
        fields = {k: blob[k]
                  for k in ("entity", "caps", "epoch", "expires", "nonce")}
        if not hmac.compare_digest(
            _mac(secret, canonical(fields)), str(blob.get("mac", ""))
        ):
            return None
        if float(blob["expires"]) < time.time():
            return None
        session_key = _mac(secret, b"session:" + canonical(fields))
        return str(blob["entity"]), str(blob["caps"]), session_key
    except (KeyError, TypeError, ValueError):
        return None


# -- the service -----------------------------------------------------------

class AuthMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.entities: dict[str, dict] = {}   # name -> {key, caps}
        self.service_secrets: dict[int, dict] = {}  # epoch -> {secret, created}
        self.secret_epoch = 0

    # -- state -------------------------------------------------------------
    def refresh(self) -> None:
        self.entities = {}
        self.service_secrets = {}
        for key in self.store.keys(PREFIX):
            raw = self.store.get(PREFIX, key) or b"{}"
            if key.startswith("entity/"):
                self.entities[key[len("entity/"):]] = json.loads(raw)
            elif key.startswith("secret/"):
                self.service_secrets[int(key[len("secret/"):])] = \
                    json.loads(raw)
        self.secret_epoch = max(self.service_secrets, default=0)

    def create_initial(self, tx: StoreTransaction) -> None:
        # under cephx the Monitor refuses to start without this key
        # (it doubles as the mon-internal signing key); outside cephx a
        # generated value is fine (the database is then unused)
        admin_key = (self.mon.conf["auth_admin_key"]
                     or secrets.token_hex(16))
        tx.put(PREFIX, "entity/client.admin", json.dumps({
            "key": admin_key,
            "caps": {"mon": "allow *", "osd": "allow *", "mds": "allow *"},
        }).encode())
        tx.put(PREFIX, "secret/1", json.dumps({
            "secret": secrets.token_hex(16), "created": time.time(),
        }).encode())

    def get_key(self, entity: str) -> str | None:
        info = self.entities.get(entity)
        return None if info is None else str(info.get("key", "")) or None

    def get_caps(self, entity: str) -> dict:
        info = self.entities.get(entity) or {}
        return dict(info.get("caps", {}))

    def secrets_snapshot(self) -> dict[int, str]:
        return {e: str(s["secret"])
                for e, s in self.service_secrets.items()}

    def current_secret(self) -> tuple[int, str] | None:
        if not self.secret_epoch:
            return None
        return (self.secret_epoch,
                str(self.service_secrets[self.secret_epoch]["secret"]))

    def issue_osd_ticket(self, entity: str) -> tuple[dict, str] | None:
        cur = self.current_secret()
        if cur is None:
            return None
        epoch, secret = cur
        caps_osd = str(self.get_caps(entity).get("osd", ""))
        ttl = self.mon.conf["auth_service_secret_ttl"]
        return seal_ticket(secret, entity, caps_osd, epoch, ttl)

    # -- rotation (leader tick) ---------------------------------------------
    def maybe_rotate(self, tx: StoreTransaction) -> bool:
        """Stage a secret rotation when the current epoch has aged a TTL;
        keep current + previous (in-flight tickets stay verifiable for
        one more TTL — the rotating-secrets window)."""
        ttl = self.mon.conf["auth_service_secret_ttl"]
        cur = self.service_secrets.get(self.secret_epoch)
        if cur is not None and time.time() - float(cur["created"]) < ttl:
            return False
        new_epoch = self.secret_epoch + 1
        tx.put(PREFIX, f"secret/{new_epoch}", json.dumps({
            "secret": secrets.token_hex(16), "created": time.time(),
        }).encode())
        for old in list(self.service_secrets):
            if old < new_epoch - 1:
                tx.erase(PREFIX, f"secret/{old}")
        return True

    # -- commands -----------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "auth get":
            entity = str(cmd.get("entity", ""))
            info = self.entities.get(entity)
            if info is None:
                return CommandResult(ENOENT_RC, f"no entity {entity!r}")
            return CommandResult(data={"entity": entity, **info})
        if name == "auth ls":
            return CommandResult(data={
                e: {"caps": i.get("caps", {})}
                for e, i in sorted(self.entities.items())
            })
        if name == "auth get-or-create":
            entity = str(cmd.get("entity", ""))
            info = self.entities.get(entity)
            if info is not None:
                return CommandResult(data={"entity": entity, **info})
            return None                     # fall through to create
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        if name == "auth get-or-create":
            entity = str(cmd.get("entity", ""))
            if not entity or "." not in entity:
                return CommandResult(
                    EINVAL_RC, f"bad entity name {entity!r}"
                )
            caps = {str(s): str(c)
                    for s, c in (cmd.get("caps") or {}).items()}
            for spec in caps.values():
                try:
                    parse_cap(spec)
                except ValueError as e:
                    return CommandResult(EINVAL_RC, str(e))
            info = {"key": secrets.token_hex(16), "caps": caps}
            tx.put(PREFIX, f"entity/{entity}",
                   json.dumps(info).encode())
            return CommandResult(data={"entity": entity, **info})
        if name == "auth caps":
            entity = str(cmd.get("entity", ""))
            if entity not in self.entities:
                return CommandResult(ENOENT_RC, f"no entity {entity!r}")
            caps = {str(s): str(c)
                    for s, c in (cmd.get("caps") or {}).items()}
            for spec in caps.values():
                try:
                    parse_cap(spec)
                except ValueError as e:
                    return CommandResult(EINVAL_RC, str(e))
            info = dict(self.entities[entity])
            info["caps"] = caps
            tx.put(PREFIX, f"entity/{entity}",
                   json.dumps(info).encode())
            return CommandResult(outs=f"updated caps for {entity}")
        if name == "auth rm":
            entity = str(cmd.get("entity", ""))
            if entity == "client.admin":
                return CommandResult(EPERM_RC, "refusing to remove admin")
            if entity not in self.entities:
                return CommandResult(ENOENT_RC, f"no entity {entity!r}")
            tx.erase(PREFIX, f"entity/{entity}")
            return CommandResult(outs=f"removed {entity}")
        return super().prepare_command(cmd, tx)
