"""ConfigMonitor: the centralized config database + config-key store.

Counterpart of ceph_tpu/mon/config_monitor.py: the same module over the
port's imports.

Reference src/mon/ConfigMonitor.cc: ``ceph config set/get/rm/dump`` stores
options in the monitor store; every daemon receives the merged snapshot at
session start and on each change (MConfig delivery, MonClient.cc:432).
``config-key`` is the separate free-form key/value namespace
(reference src/mon/ConfigKeyService.cc) that mgr modules and tools use
for arbitrary persisted blobs.
"""

from __future__ import annotations

from ceph_tpu_torch.mon.service import ENOENT_RC, CommandResult, PaxosService
from ceph_tpu_torch.mon.store import StoreTransaction

PREFIX = "config"
KEY_PREFIX = "confkey"


class ConfigMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.values: dict[str, str] = {}

    def refresh(self) -> None:
        self.values = {
            key: (self.store.get(PREFIX, key) or b"").decode()
            for key in self.store.keys(PREFIX)
        }

    def snapshot(self) -> dict[str, str]:
        return dict(self.values)

    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "config dump":
            return CommandResult(data=self.snapshot())
        if name == "config get":
            key = cmd.get("name", "")
            if key not in self.values:
                return CommandResult(ENOENT_RC, f"{key!r} not set")
            return CommandResult(data=self.values[key])
        if name == "config-key get":
            raw = self.store.get(KEY_PREFIX, cmd.get("key", ""))
            if raw is None:
                return CommandResult(ENOENT_RC,
                                     f"no key {cmd.get('key')!r}")
            return CommandResult(data=raw.decode("utf-8", "replace"))
        if name == "config-key ls":
            return CommandResult(data=sorted(self.store.keys(KEY_PREFIX)))
        if name == "config-key exists":
            key = cmd.get("key", "")
            return CommandResult(
                data=self.store.get(KEY_PREFIX, key) is not None
            )
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        if name == "config set":
            key, value = cmd["name"], str(cmd["value"])
            # validate against the local schema when the option is known
            opt = self.mon.conf.schema().get(key)
            if opt is not None:
                try:
                    opt.validate(value)
                except ValueError as e:
                    return CommandResult(ENOENT_RC, str(e))
            tx.put(PREFIX, key, value.encode())
            return CommandResult(outs=f"set {key} = {value}")
        if name == "config rm":
            key = cmd["name"]
            tx.erase(PREFIX, key)
            return CommandResult(outs=f"removed {key}")
        if name == "config-key set":
            key = str(cmd["key"])
            tx.put(KEY_PREFIX, key, str(cmd.get("value", "")).encode())
            return CommandResult(outs=f"set {key}")
        if name == "config-key rm":
            key = str(cmd["key"])
            tx.erase(KEY_PREFIX, key)
            return CommandResult(outs=f"removed {key}")
        return super().prepare_command(cmd, tx)
