"""Orchestrator mgr module: declarative service placement.

Counterpart of ceph_tpu/services/orchestrator.py: the same module over the
port's imports.

Reference src/pybind/mgr/orchestrator (the ``ceph orch`` surface) +
src/pybind/mgr/cephadm (the backend that converges the cluster onto the
declared specs).  The reference stores ServiceSpecs in the mon
config-key store and a serve loop creates/removes daemons until the
running set matches; ``orch ls`` shows specs vs running, ``orch ps``
the daemon inventory.

Here the same split: ``orch apply/rm/daemon rm`` are monitor commands
(mon/mgr_stat.py) that persist specs as ``orch/spec/<type>`` keys in
the config-key store (durable, survives any daemon restart); this
module reconciles each cycle through a pluggable backend.  The
in-process backend drives DevCluster (the cephadm-on-localhost role:
vstart.py plays ssh+systemd).  Divergence from the reference: commands
are handled mon-side and read back via the mgr digest instead of being
forwarded mon->mgr over MCommand — this framework's mgr modules act
through mon state, not a private command channel.

Spec JSON: {"service_type": "osd"|"mds"|"rgw", "count": N,
            "unmanaged": bool, "deleted": bool}.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.mon.mgr_stat import ORCH_RM_PREFIX as RM_PREFIX
from ceph_tpu_torch.mon.mgr_stat import ORCH_SPEC_PREFIX as SPEC_PREFIX
from ceph_tpu_torch.services.mgr_modules import MgrModule

SERVICE_TYPES = ("osd", "mds", "rgw")


class OrchBackend:
    """What the orchestrator needs from the deployment substrate (the
    cephadm ssh/podman surface, scoped to daemon lifecycle)."""

    def hosts(self) -> list[str]:
        raise NotImplementedError

    def list_daemons(self) -> list[dict]:
        """[{"name": "osd.3", "type": "osd", "id": "3", "host": h}]"""
        raise NotImplementedError

    async def add_daemon(self, service_type: str) -> str:
        """Create one daemon of the type; returns its name."""
        raise NotImplementedError

    async def rm_daemon(self, name: str) -> bool:
        raise NotImplementedError


class DevClusterBackend(OrchBackend):
    """Drives a DevCluster (vstart.py): daemons live in this process,
    created/destroyed through the same hooks the Thrasher uses."""

    def __init__(self, cluster):
        self.cluster = cluster

    def hosts(self) -> list[str]:
        hosts = {f"host{i}" for i in self.cluster.osds}
        hosts.add("localhost")
        return sorted(hosts)

    def list_daemons(self) -> list[dict]:
        out = []
        for i in sorted(self.cluster.osds):
            out.append({"name": f"osd.{i}", "type": "osd",
                        "id": str(i), "host": f"host{i}"})
        for name in sorted(self.cluster.mdss):
            out.append({"name": f"mds.{name}", "type": "mds",
                        "id": name, "host": "localhost"})
        for name in sorted(self.cluster.mgrs):
            out.append({"name": f"mgr.{name}", "type": "mgr",
                        "id": name, "host": "localhost"})
        for fe in self.cluster.rgws:
            oid = getattr(fe, "_orch_id", 0)
            out.append({"name": f"rgw.{oid}", "type": "rgw",
                        "id": str(oid), "host": "localhost"})
        return out

    async def add_daemon(self, service_type: str) -> str:
        c = self.cluster
        if service_type == "osd":
            new_id = max(c.osds, default=-1) + 1
            new_id = max(new_id, c.n_osds)   # never reuse a killed slot
            await c.start_osd(new_id)
            return f"osd.{new_id}"
        if service_type == "mds":
            n = 0
            while f"o{n}" in c.mdss:
                n += 1
            await c.start_mds(name=f"o{n}")
            return f"mds.o{n}"
        if service_type == "rgw":
            fe, _users = await c.start_rgw()
            return f"rgw.{fe._orch_id}"
        raise ValueError(f"unsupported service type {service_type!r}")

    async def rm_daemon(self, name: str) -> bool:
        c = self.cluster
        stype, _, did = name.partition(".")
        if stype == "osd" and did.isdigit() and int(did) in c.osds:
            await c.kill_osd(int(did))
            return True
        if stype == "mds" and did in c.mdss:
            mds = c.mdss.pop(did)
            await mds.shutdown()
            return True
        if stype == "rgw" and did.isdigit():
            for j, fe in enumerate(c.rgws):
                if getattr(fe, "_orch_id", None) == int(did):
                    c.rgws.pop(j)
                    await fe.stop()
                    await fe._rados.shutdown()
                    return True
        return False


class Orchestrator(MgrModule):
    """Reconciliation loop: converge running daemons onto the specs in
    the config-key store, one action per service per cycle (bounded
    churn, like the balancer's one-move rule)."""

    name = "orchestrator"

    def __init__(self, mgr, backend: OrchBackend | None = None):
        super().__init__(mgr)
        self.backend = backend
        self.last_actions: list[str] = []

    async def _kv(self, prefix_cmd: str, **kw) -> dict:
        return await self.mgr.monc.command(prefix_cmd, **kw)

    async def _load_specs(self) -> dict[str, dict]:
        r = await self._kv("config-key ls")
        if r["rc"] != 0:
            return {}
        specs: dict[str, dict] = {}
        for key in r["data"]:
            if not key.startswith(SPEC_PREFIX):
                continue
            g = await self._kv("config-key get", key=key)
            if g["rc"] != 0:
                continue
            try:
                specs[key[len(SPEC_PREFIX):]] = json.loads(g["data"])
            except ValueError:
                continue
        return specs

    async def _pending_removals(self) -> list[str]:
        r = await self._kv("config-key ls")
        if r["rc"] != 0:
            return []
        return [k[len(RM_PREFIX):] for k in r["data"]
                if k.startswith(RM_PREFIX)]

    async def serve_once(self) -> None:
        if self.backend is None:
            return
        self.last_actions = []
        daemons = self.backend.list_daemons()
        # imperative removals first (orch daemon rm): consume tombstones
        for name in await self._pending_removals():
            ok = await self.backend.rm_daemon(name)
            await self._kv("config-key rm", key=RM_PREFIX + name)
            self.last_actions.append(
                f"daemon rm {name}" if ok
                else f"daemon rm {name}: not found")
            daemons = self.backend.list_daemons()
        for stype, spec in sorted((await self._load_specs()).items()):
            if spec.get("unmanaged"):
                continue
            running = [d for d in daemons if d["type"] == stype]
            target = 0 if spec.get("deleted") else int(
                spec.get("count", 0))
            if len(running) < target:
                name = await self.backend.add_daemon(stype)
                self.last_actions.append(f"add {name}")
            elif len(running) > target:
                victim = running[-1]["name"]
                await self.backend.rm_daemon(victim)
                self.last_actions.append(f"rm {victim}")
            elif spec.get("deleted"):
                # fully drained: retire the spec
                await self._kv("config-key rm",
                               key=SPEC_PREFIX + stype)
                self.last_actions.append(f"retired spec {stype}")

    def digest_contrib(self) -> dict:
        if self.backend is None:
            return {"orchestrator": {"available": False}}
        return {"orchestrator": {
            "available": True,
            "hosts": self.backend.hosts(),
            "daemons": self.backend.list_daemons(),
            "last_actions": self.last_actions,
        }}
