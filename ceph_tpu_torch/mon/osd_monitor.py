"""OSDMonitor: the OSD map service.

Counterpart of ceph_tpu/mon/osd_monitor.py: the same module over the
port's imports, except that the mon builds the codecs it validates
profiles with on the CPU (``device="cpu"``): a mon reads only the chunk
counts and never codes data.

Reference src/mon/OSDMonitor.cc: boot handling, failure reports with
reporter/grace logic (prepare_failure :3243 / check_failure :3129),
down->out aging, pool and erasure-code-profile commands, and epoch
publication. Every epoch stores both the full map and the incremental so
subscribers catch up with deltas (OSDMap.h:354 Incremental).
"""

from __future__ import annotations

import time

from ceph_tpu_torch.common.log import Dout
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.mon.service import (
    EBUSY_RC,
    EEXIST_RC,
    EINVAL_RC,
    ENOENT_RC,
    CommandResult,
    PaxosService,
)
from ceph_tpu_torch.mon.store import StoreTransaction
from ceph_tpu_torch.msg.codec import decode, encode
from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap, PoolInfo
from ceph_tpu_torch.placement.crush_map import CrushMap

log = Dout("mon")

PREFIX = "osdmap"
DEFAULT_PROFILE = {"plugin": "jax_rs", "k": "2", "m": "2",
                   "technique": "reed_sol_van"}


def _bootstrap_crush() -> CrushMap:
    crush = CrushMap()
    crush.add_bucket("default", "root")
    crush.create_replicated_rule("replicated_rule", failure_domain="host")
    return crush


class OSDMonitor(PaxosService):
    prefix = PREFIX

    def __init__(self, mon):
        super().__init__(mon)
        self.osdmap = OSDMap()
        self.pending: Incremental | None = None
        # failure bookkeeping: target osd -> {reporter: report time}
        self.failure_reports: dict[int, dict[str, float]] = {}
        self.down_pending_out: dict[int, float] = {}
        # slow-op beacons (leader-local, ephemeral): osd id ->
        # {"inflight": n, "total": n, "t": monotonic receive time}.
        # Drives the SLOW_OPS health check; re-sent every heartbeat,
        # so stale entries just age out.
        self.slow_op_reports: dict[int, dict] = {}
        # map-commit waiters (wait_map): woken on every refreshed epoch
        self._map_waiters: list = []
        # per-epoch decode caches: after a commit, EVERY subscriber
        # session is answered from incrementals_since/full_map_dict, so
        # at 200 OSDs one epoch means 200 identical store decodes /
        # to_dict walks without these.  Committed epochs are immutable
        # and the wire layer re-encodes per send, so sharing is safe.
        self._inc_cache: dict[int, dict] = {}
        self._full_cache: tuple[int, dict | None] = (0, None)

    # -- state ------------------------------------------------------------
    def refresh(self) -> None:
        last = self.store.get_int(PREFIX, "last_committed")
        if last <= self.osdmap.epoch:
            return
        raw = self.store.get(PREFIX, f"full_{last}")
        if raw is not None:
            self.osdmap = OSDMap.from_dict(decode(raw))
            jr = getattr(self.mon, "journal", None)
            if jr is not None:
                jr.emit("map.commit", epoch=self.osdmap.epoch,
                        up=sum(1 for o in self.osdmap.osds.values()
                               if o.up))
        for ev in self._map_waiters:
            ev.set()
        for osd, info in self.osdmap.osds.items():
            if info.up:
                self.failure_reports.pop(osd, None)
                self.down_pending_out.pop(osd, None)
            elif info.in_cluster and osd not in self.down_pending_out:
                self.down_pending_out[osd] = time.monotonic()

    async def wait_map(self, pred, timeout: float = 30.0):
        """Event-wait (no polling) until ``pred(osdmap)`` holds: every
        committed epoch wakes waiters from refresh(), so the wait ends
        the moment the map changes — tests and tooling watching for a
        mark-down/mark-up stop depending on sleep granularity and
        wall-clock budgets.  ``timeout`` is a safety bound only."""
        import asyncio

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            # subscribe BEFORE testing the predicate: a refresh landing
            # between the test and the wait must not be missed
            ev = asyncio.Event()
            self._map_waiters.append(ev)
            try:
                if pred(self.osdmap):
                    return self.osdmap
                await asyncio.wait_for(
                    ev.wait(), max(0.0, deadline - loop.time()))
            finally:
                self._map_waiters.remove(ev)

    def create_initial(self, tx: StoreTransaction) -> None:
        # the genesis incremental carries the crush map so a map history
        # replayed purely from incrementals is complete
        inc = Incremental(1, new_crush=_bootstrap_crush().to_dict())
        m = OSDMap()
        m.apply_incremental(inc)
        self._stage(tx, m, inc)

    KEEP_EPOCHS = 200      # default map history window (conf-overridable)

    def _keep_epochs(self) -> int:
        """mon_osdmap_keep_epochs: how many epochs of full/incremental
        history the store retains (OSDMonitor's mon_min_osdmap_epochs
        trim role).  A direct KEEP_EPOCHS override on the instance
        (tests, tools) beats the conf value."""
        if "KEEP_EPOCHS" in self.__dict__:
            return max(1, int(self.KEEP_EPOCHS))
        try:
            return max(1, int(self.mon.conf["mon_osdmap_keep_epochs"]))
        except KeyError:
            return self.KEEP_EPOCHS

    def first_committed(self) -> int:
        """Oldest epoch whose full map + incremental are still stored
        (the trim horizon).  0 on legacy stores that predate the key —
        callers treat that as 'unknown, probe the store'."""
        return self.store.get_int(PREFIX, "first_committed")

    def _stage(self, tx: StoreTransaction, new_map: OSDMap,
               inc: Incremental) -> None:
        tx.put(PREFIX, f"full_{new_map.epoch}", encode(new_map.to_dict()))
        tx.put(PREFIX, f"inc_{inc.epoch}", encode(inc.to_dict()))
        tx.put(PREFIX, "last_committed", new_map.epoch)
        keep = self._keep_epochs()
        horizon = max(1, new_map.epoch - keep + 1)
        first = self.first_committed()
        if first <= 0:
            # legacy store / fresh sync: bound the sweep — anything
            # below one whole window before the horizon was already
            # trimmed (or never written) by the previous owner
            first = max(1, horizon - keep)
        if horizon > first:
            # multi-epoch trim: a DR restart or paxos sync can land the
            # map many epochs ahead of the last trim point, so erase
            # the WHOLE stale range, not just one epoch per commit
            for e in range(first, horizon):
                tx.erase(PREFIX, f"full_{e}")
                tx.erase(PREFIX, f"inc_{e}")
            self._inc_cache = {k: v for k, v in self._inc_cache.items()
                               if k >= horizon}
        tx.put(PREFIX, "first_committed", max(first, horizon))

    def _pending(self) -> Incremental:
        if self.pending is None or self.pending.epoch != self.osdmap.epoch + 1:
            self.pending = Incremental(self.osdmap.epoch + 1)
        return self.pending

    def encode_pending(self, tx: StoreTransaction) -> bool:
        """Apply + stage the pending incremental; False if nothing to do."""
        inc = self.pending
        if inc is None:
            return False
        self.pending = None
        preview = OSDMap.from_dict(self.osdmap.to_dict())
        preview.apply_incremental(inc)
        self._stage(tx, preview, inc)
        return True

    def incrementals_since(self, epoch: int) -> list[dict]:
        """Replayable incrementals (epoch, last]; [] when the gap is not
        replayable so the caller falls back to a full map.  A subscriber
        whose epoch predates the trim horizon is answered O(1) off the
        first_committed key instead of probing the store per epoch."""
        first = self.first_committed()
        if first > 0 and epoch + 1 < first:
            return []              # predates the trimmed horizon
        out = []
        for e in range(epoch + 1, self.osdmap.epoch + 1):
            d = self._inc_cache.get(e)
            if d is None:
                raw = self.store.get(PREFIX, f"inc_{e}")
                if raw is None:
                    return []      # gap (trimmed): caller sends full map
                d = decode(raw)
                self._inc_cache[e] = d
            out.append(d)
        if len(self._inc_cache) > 2 * self._keep_epochs():
            # bound on peons too, where _stage's trim never runs
            horizon = self.osdmap.epoch - self._keep_epochs()
            self._inc_cache = {k: v for k, v in self._inc_cache.items()
                               if k > horizon}
        return out

    def full_map_dict(self) -> dict:
        e = self.osdmap.epoch
        if self._full_cache[0] != e or self._full_cache[1] is None:
            self._full_cache = (e, self.osdmap.to_dict())
        return self._full_cache[1]

    # -- boot / failure ---------------------------------------------------
    def prepare_boot(self, osd_id: int, addr: str, host: str) -> bool:
        """MOSDBoot: mark up, ensure crush location (OSDMonitor boot)."""
        if "noup" in self.osdmap.flags:
            log.dout(1, "noup set: ignoring boot from osd.%d", osd_id)
            return False
        if self.osdmap.epoch == 0:
            # genesis race: concurrent boots can reach the leader
            # before _propose_genesis commits the initial map, and the
            # empty epoch-0 crush has no "default" root to hang the
            # host bucket on; the OSD's send_boot loop retries until
            # the post-genesis map shows it up
            return False
        info = self.osdmap.osds.get(osd_id)
        if info is not None and info.up and info.addr == addr:
            return False        # no change: don't stage an empty epoch
        self.mon.cluster_log("info", f"osd.{osd_id} boot ({addr})")
        pending = self._pending()
        pending.new_up[osd_id] = addr
        if info is None:
            # noin: a new OSD registers but stays OUT until the
            # operator weights it in
            pending.new_weights[osd_id] = (
                0 if "noin" in self.osdmap.flags else 0x10000
            )
        crush = self.osdmap.crush
        if osd_id >= crush.max_device or not any(
            osd_id in b.items for b in crush.buckets.values()
        ):
            new_crush = (CrushMap.from_dict(pending.new_crush)
                         if pending.new_crush else
                         CrushMap.from_dict(crush.to_dict()))
            host_name = host or f"host-{osd_id}"
            if host_name not in new_crush.names:
                b = new_crush.add_bucket(host_name, "host")
                new_crush.add_item("default", b)
            if osd_id not in new_crush.buckets[
                new_crush.names[host_name]
            ].items:
                new_crush.add_item(host_name, osd_id)
            pending.new_crush = new_crush.to_dict()
        return True

    def prepare_failure(self, target: int, reporter: str,
                        failed_for: float) -> bool:
        """MOSDFailure accounting (prepare_failure/check_failure)."""
        if "nodown" in self.osdmap.flags:
            return False
        if not self.osdmap.is_up(target):
            return False
        grace = self.mon.conf["osd_heartbeat_grace"]
        if failed_for < grace:
            return False
        reports = self.failure_reports.setdefault(target, {})
        reports[reporter] = time.monotonic()
        if len(reports) < self.mon.conf["mon_osd_min_down_reporters"]:
            return False
        del self.failure_reports[target]
        self.mon.cluster_log(
            "warn", f"osd.{target} failed ({len(reports)} reporters)"
        )
        pending = self._pending()
        if target not in pending.new_down:
            pending.new_down.append(target)
        return True

    def note_beacon(self, data: dict) -> None:
        """MOSDBeacon digest: remember the sender's slow-op counts for
        the SLOW_OPS health check (ephemeral — never proposed)."""
        try:
            osd = int(data["id"])
        except (KeyError, TypeError, ValueError):
            return
        self.slow_op_reports[osd] = {
            "inflight": int(data.get("slow_inflight", 0) or 0),
            "total": int(data.get("slow_total", 0) or 0),
            "t": time.monotonic(),
        }

    _BEACON_STALE = 60.0    # drop reports older than this (a dead OSD
                            # must not pin SLOW_OPS forever)

    def _slow_op_check(self) -> dict | None:
        now = time.monotonic()
        for osd, rep in list(self.slow_op_reports.items()):
            if (now - rep["t"] > self._BEACON_STALE
                    or not self.osdmap.is_up(osd)):
                del self.slow_op_reports[osd]
        slow = {o: r for o, r in self.slow_op_reports.items()
                if r["inflight"] > 0}
        if not slow:
            return None
        total = sum(r["inflight"] for r in slow.values())
        worst = max(slow, key=lambda o: slow[o]["inflight"])
        return {
            "severity": "HEALTH_WARN",
            "message": (f"{total} slow ops, oldest complaints on "
                        f"osd.{worst} "
                        f"({slow[worst]['inflight']} slow)"),
            "detail": [
                f"osd.{o} has {r['inflight']} slow ops in flight "
                f"({r['total']} lifetime)"
                for o, r in sorted(slow.items())
            ],
        }

    def health_checks(self) -> dict[str, dict]:
        checks: dict[str, dict] = {}
        slow = self._slow_op_check()
        if slow is not None:
            checks["SLOW_OPS"] = slow
        full = sorted(p.name for p in self.osdmap.pools.values()
                      if p.full_quota)
        if full:
            checks["POOL_FULL"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(full)} pool(s) reached quota",
                "detail": [f"pool '{n}' is full (quota)"
                           for n in full],
            }
        down = sorted(
            o for o, i in self.osdmap.osds.items()
            if not i.up and i.in_cluster
        )
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "message": f"{len(down)} osds down",
                "detail": [f"osd.{o} is down" for o in down],
            }
        if self.osdmap.flags:
            checks["OSDMAP_FLAGS"] = {
                "severity": "HEALTH_WARN",
                "message": (", ".join(sorted(self.osdmap.flags))
                            + " flag(s) set"),
            }
        return checks

    async def tick(self) -> None:
        """Leader maintenance: age down OSDs out (down_out_interval)."""
        now = time.monotonic()
        interval = self.mon.conf["mon_osd_down_out_interval"]
        changed = False
        if "noout" in self.osdmap.flags:
            # noout only suppresses the auto-out sweep; quota
            # enforcement still runs
            if self.check_pool_quotas():
                await self.mon.propose_pending()
            return
        for osd, since in list(self.down_pending_out.items()):
            info = self.osdmap.osds.get(osd)
            if info is None or info.up or not info.in_cluster:
                del self.down_pending_out[osd]
                continue
            if now - since >= interval:
                self._pending().new_weights[osd] = 0
                del self.down_pending_out[osd]
                changed = True
                log.dout(1, "osd.%d down too long, marking out", osd)
                self.mon.cluster_log(
                    "warn", f"osd.{osd} marked out after being down "
                    f"{interval:g}s"
                )
        if self.check_pool_quotas():
            changed = True
        if changed:
            await self.mon.propose_pending()

    # -- commands ---------------------------------------------------------
    def preprocess_command(self, cmd: dict) -> CommandResult | None:
        name = cmd.get("prefix", "")
        if name == "osd dump":
            return CommandResult(data=self.osdmap.to_dict())
        if name == "osd stat":
            up = sum(1 for o in self.osdmap.osds.values() if o.up)
            inc = sum(
                1 for o in self.osdmap.osds.values() if o.in_cluster
            )
            return CommandResult(data={
                "epoch": self.osdmap.epoch,
                "num_osds": len(self.osdmap.osds),
                "num_up_osds": up, "num_in_osds": inc,
            })
        if name == "osd df":
            # per-OSD utilization (reference `ceph osd df`): weights
            # from the map, bytes from the mgr's PGMap digest
            used = self.mon.mgr_stat.digest.get("osd_df", {})
            rows = []
            for osd, info in sorted(self.osdmap.osds.items()):
                u = used.get(osd) or used.get(str(osd)) or {}
                rows.append({
                    "id": osd, "up": info.up,
                    "in": info.in_cluster,
                    "weight": round(info.weight / 0x10000, 4),
                    "bytes_used": int(u.get("bytes_used", 0)),
                })
            total = sum(r["bytes_used"] for r in rows)
            return CommandResult(data={"nodes": rows,
                                       "total_bytes_used": total})
        if name == "osd tree":
            return CommandResult(data=self._tree())
        if name == "osd crush class ls":
            return CommandResult(data=self.osdmap.crush.device_classes())
        if name == "osd crush class ls-osd":
            return CommandResult(data=self.osdmap.crush.class_devices(
                str(cmd.get("class", ""))))
        if name == "osd getcrushmap":
            from ceph_tpu_torch.placement.compiler import decompile

            return CommandResult(data=decompile(self.osdmap.crush))
        if name == "osd getmap":
            epoch = int(cmd.get("epoch", self.osdmap.epoch))
            raw = self.store.get(PREFIX, f"full_{epoch}")
            if raw is None:
                return CommandResult(ENOENT_RC, f"no epoch {epoch}")
            return CommandResult(data=decode(raw))
        if name == "osd erasure-code-profile ls":
            return CommandResult(data=sorted(self.osdmap.ec_profiles))
        if name == "osd erasure-code-profile get":
            pname = cmd.get("name", "")
            prof = self.osdmap.ec_profiles.get(pname)
            if prof is None:
                return CommandResult(ENOENT_RC, f"no profile {pname!r}")
            return CommandResult(data=prof)
        if name == "osd pool ls":
            return CommandResult(
                data=[p.name for p in self.osdmap.pools.values()]
            )
        if name == "osd pool get-quota":
            pool = self._pool_by_name(cmd.get("pool", ""))
            if pool is None:
                return CommandResult(ENOENT_RC,
                                     f"no pool {cmd.get('pool')!r}")
            return CommandResult(data={
                "pool": pool.name,
                "quota_max_bytes": pool.quota_max_bytes,
                "quota_max_objects": pool.quota_max_objects,
                "full": pool.full_quota,
            })
        if name == "osd blocklist ls":
            now = time.time()
            return CommandResult(data={
                "blocklist": {k: v for k, v in
                              self.osdmap.blocklist.items()
                              if v > now},
            })
        if name == "osd pool get":
            pool = self._pool_by_name(cmd.get("pool", ""))
            if pool is None:
                return CommandResult(ENOENT_RC,
                                     f"no pool {cmd.get('pool')!r}")
            return CommandResult(data=pool.to_dict())
        return None

    def prepare_command(self, cmd: dict, tx: StoreTransaction
                        ) -> CommandResult:
        name = cmd.get("prefix", "")
        try:
            if name == "osd erasure-code-profile set":
                return self._cmd_profile_set(cmd)
            if name == "osd erasure-code-profile rm":
                return self._cmd_profile_rm(cmd)
            if name == "osd pool create":
                return self._cmd_pool_create(cmd)
            if name == "osd pool delete":
                return self._cmd_pool_delete(cmd)
            if name == "osd pool set":
                return self._cmd_pool_set(cmd)
            if name == "osd pool selfmanaged-snap create":
                return self._cmd_snap_create(cmd)
            if name == "osd pool selfmanaged-snap rm":
                return self._cmd_snap_rm(cmd)
            if name in ("osd out", "osd in", "osd down"):
                return self._cmd_osd_state(name, cmd)
            if name in ("osd crush set-device-class",
                        "osd crush rm-device-class"):
                return self._cmd_device_class(name, cmd)
            if name == "osd crush reweight":
                osd = int(cmd["id"])
                self._pending().new_weights[osd] = int(
                    float(cmd["weight"]) * 0x10000
                )
                return CommandResult(outs=f"reweighted osd.{osd}")
            if name == "osd pg-upmap-items":
                return self._cmd_upmap_items(cmd)
            if name == "osd rm-pg-upmap-items":
                return self._cmd_rm_upmap_items(cmd)
            if name.startswith("osd tier"):
                return self._cmd_tier(name, cmd)
            if name in ("osd set", "osd unset"):
                return self._cmd_flag(name == "osd set", cmd)
            if name == "osd purge":
                return self._cmd_osd_purge(cmd)
            if name == "osd blocklist":
                return self._cmd_blocklist(cmd)
            if name == "osd pool set-quota":
                return self._cmd_pool_quota(cmd)
            if name == "osd setcrushmap":
                return self._cmd_setcrushmap(cmd)
        except (KeyError, ValueError, TypeError) as e:
            return CommandResult(EINVAL_RC, f"bad command args: {e}")
        return CommandResult(EINVAL_RC, f"unrecognized command {name!r}")

    # -- command impls ----------------------------------------------------
    def _pool_by_name(self, name: str) -> PoolInfo | None:
        for p in self.osdmap.pools.values():
            if p.name == name:
                return p
        return None

    def _cmd_profile_set(self, cmd: dict) -> CommandResult:
        pname = cmd["name"]
        profile = {str(k): str(v) for k, v in cmd.get("profile", {}).items()}
        profile.setdefault("plugin", "jax_rs")
        if pname in self.osdmap.ec_profiles and not cmd.get("force"):
            if self.osdmap.ec_profiles[pname] != profile:
                return CommandResult(
                    EEXIST_RC,
                    f"profile {pname!r} exists with different params",
                )
            return CommandResult(outs="unchanged")
        # validate by instantiating the codec (OSDMonitor validates via
        # the loaded plugin before accepting the profile)
        try:
            ErasureCodePluginRegistry.instance().factory(
                profile["plugin"], dict(profile), device="cpu"
            )
        except Exception as e:
            return CommandResult(EINVAL_RC, f"invalid profile: {e}")
        self._pending().new_ec_profiles[pname] = profile
        return CommandResult(outs=f"profile {pname!r} set")

    def _cmd_profile_rm(self, cmd: dict) -> CommandResult:
        pname = cmd["name"]
        for p in self.osdmap.pools.values():
            if p.ec_profile == pname:
                return CommandResult(
                    EINVAL_RC, f"profile {pname!r} in use by {p.name!r}"
                )
        if pname not in self.osdmap.ec_profiles:
            return CommandResult(ENOENT_RC, f"no profile {pname!r}")
        self._pending().removed_ec_profiles.append(pname)
        return CommandResult(outs=f"profile {pname!r} removed")

    def _cmd_pool_create(self, cmd: dict) -> CommandResult:
        name = cmd["pool"]
        existing = self._pool_by_name(name)
        if existing is not None:
            # idempotent like the reference's pool create: a retry after a
            # commit that outran its reply must not surface an error
            return CommandResult(
                outs=f"pool {name!r} already exists",
                data={"pool_id": existing.pool_id},
            )
        pool_type = cmd.get("pool_type", "replicated")
        pg_num = int(
            cmd.get("pg_num", self.mon.conf["osd_pool_default_pg_num"])
        )
        pending = self._pending()
        # ids are never reused after deletion (max_pool_id is monotonic)
        pool_id = max(
            self.osdmap.max_pool_id,
            max((p.pool_id for p in pending.new_pools), default=0),
        ) + 1
        if pool_type == "erasure":
            pname = cmd.get("erasure_code_profile", "default")
            profile = (pending.new_ec_profiles.get(pname)
                       or self.osdmap.ec_profiles.get(pname))
            if profile is None:
                if pname != "default":
                    return CommandResult(ENOENT_RC,
                                         f"no profile {pname!r}")
                profile = dict(DEFAULT_PROFILE)
                pending.new_ec_profiles[pname] = profile
            codec = ErasureCodePluginRegistry.instance().factory(
                profile.get("plugin", "jax_rs"), dict(profile), device="cpu"
            )
            k = codec.get_data_chunk_count()
            n = codec.get_chunk_count()
            rule_name = cmd.get("crush_rule") or f"ec_{pname}"
            if rule_name not in self.osdmap.crush.rules:
                new_crush = (CrushMap.from_dict(pending.new_crush)
                             if pending.new_crush else CrushMap.from_dict(
                                 self.osdmap.crush.to_dict()))
                if rule_name not in new_crush.rules:
                    fd = profile.get("crush-failure-domain", "host")
                    new_crush.create_ec_rule(
                        rule_name, n, failure_domain=fd,
                        root=profile.get("crush-root", "default"),
                        device_class=profile.get("crush-device-class",
                                                 ""),
                    )
                pending.new_crush = new_crush.to_dict()
            pool = PoolInfo(
                pool_id, name, "erasure", size=n,
                min_size=int(cmd.get("min_size", min(k + 1, n))),
                pg_num=pg_num, pgp_num=pg_num,
                crush_rule=rule_name, ec_profile=pname,
            )
        else:
            size = int(
                cmd.get("size", self.mon.conf["osd_pool_default_size"])
            )
            min_size = int(cmd.get("min_size", 0)) \
                or self.mon.conf["osd_pool_default_min_size"] \
                or max(1, size - 1)
            pool = PoolInfo(
                pool_id, name, "replicated", size=size, min_size=min_size,
                pg_num=pg_num, pgp_num=pg_num,
                crush_rule=cmd.get("crush_rule", "replicated_rule"),
            )
        pending.new_pools.append(pool)
        return CommandResult(outs=f"pool {name!r} created",
                             data={"pool_id": pool_id})

    def _cmd_pool_delete(self, cmd: dict) -> CommandResult:
        pool = self._pool_by_name(cmd["pool"])
        if pool is None:
            return CommandResult(ENOENT_RC, f"no pool {cmd['pool']!r}")
        self._pending().removed_pools.append(pool.pool_id)
        return CommandResult(outs=f"pool {pool.name!r} removed")

    def _cmd_pool_set(self, cmd: dict) -> CommandResult:
        # reuse the pending-staged copy: a pool-set in the same epoch
        # as tier/snap commands must compose, not silently win the
        # last-entry-wins apply and revert their fields
        updated = self._staged_pool(cmd["pool"])
        if isinstance(updated, CommandResult):
            return updated
        var, val = cmd["var"], cmd["val"]
        if var == "size":
            updated.size = int(val)
        elif var == "min_size":
            updated.min_size = int(val)
        elif var == "pg_num":
            n = int(val)
            if n == updated.pg_num:
                # no-op: do not stage an epoch for an unchanged value
                return CommandResult(outs=f"pg_num is already {n}")
            if n < 1:
                return CommandResult(EINVAL_RC, "pg_num must be >= 1")
            if n < updated.pg_num:
                # MERGE: only once placement already folded the merge
                # sources onto their targets (pgp_num == n) — the
                # ready-to-merge precondition; every OSD then holds
                # source and target colocated and the fold is local
                cur_pgp = updated.pgp_num or updated.pg_num
                committed = self.osdmap.pools.get(updated.pool_id)
                committed_pgp = (committed.pgp_num or committed.pg_num
                                 if committed else 0)
                if cur_pgp != n or committed_pgp != n:
                    # the COMMITTED map must carry the pgp step too, or
                    # back-to-back set commands would compose into one
                    # epoch and merge before any migration even starts
                    return CommandResult(
                        EINVAL_RC,
                        f"merging requires pgp_num {n} first "
                        f"(committed {committed_pgp}): decrease "
                        "pgp_num, wait for the migration to settle, "
                        "then shrink pg_num")
                blocked = self._merge_unsettled(updated.pool_id)
                if blocked:
                    return CommandResult(
                        EBUSY_RC, f"not ready to merge: {blocked}; "
                        "wait for the migration to settle and retry")
                # merged-away PGs must not leave ghost upmap entries
                # that would re-apply on a future re-split (pg_temp
                # for the pool is already empty: _merge_unsettled
                # blocks while any exists)
                pend = self._pending()
                for (pid, ps) in list(self.osdmap.pg_upmap_items):
                    if pid == updated.pool_id and ps >= n:
                        pend.new_pg_upmap_items[(pid, ps)] = []
                updated.pg_num = n
                updated.pgp_num = n
            else:
                if not updated.pgp_num:
                    # legacy pool in pgp-follows-pg mode: pin placement
                    # to the OLD pg_num or children would move in the
                    # same epoch the split runs (no backfill source)
                    updated.pgp_num = updated.pg_num
                updated.pg_num = n
        elif var == "pgp_num":
            n = int(val)
            cur_pgp = updated.pgp_num or updated.pg_num
            if n == cur_pgp:
                return CommandResult(outs=f"pgp_num is already {n}")
            if n < 1:
                return CommandResult(EINVAL_RC, "pgp_num must be >= 1")
            if n > updated.pg_num:
                return CommandResult(
                    EINVAL_RC, f"pgp_num {n} > pg_num "
                    f"{updated.pg_num}")
            updated.pgp_num = n
        elif var == "pg_autoscale_mode":
            if val not in ("off", "warn", "on"):
                return CommandResult(
                    EINVAL_RC, "pg_autoscale_mode must be "
                    "off|warn|on")
            updated.pg_autoscale_mode = str(val)
        elif var == "hit_set_type":
            if val not in ("", "bloom"):
                return CommandResult(EINVAL_RC,
                                     "hit_set_type must be '' or 'bloom'")
            updated.hit_set_type = str(val)
        elif var == "hit_set_period":
            if not float(val) >= 0:      # rejects negatives AND NaN
                return CommandResult(EINVAL_RC,
                                     "hit_set_period must be >= 0")
            updated.hit_set_period = float(val)
        elif var == "hit_set_count":
            if int(val) < 1:
                return CommandResult(EINVAL_RC,
                                     "hit_set_count must be >= 1")
            updated.hit_set_count = int(val)
        elif var == "target_max_objects":
            updated.target_max_objects = max(0, int(val))
        elif var == "target_max_bytes":
            updated.target_max_bytes = max(0, int(val))
        else:
            return CommandResult(EINVAL_RC, f"cannot set {var!r}")
        return CommandResult(outs=f"set pool {updated.name!r} {var}={val}")

    def _cmd_snap_create(self, cmd: dict) -> CommandResult:
        """Allocate a self-managed snap id (pg_pool_t snap_seq bump; the
        rados_ioctx_selfmanaged_snap_create mon path)."""
        pool = self._pool_by_name(cmd["pool"])
        if pool is None:
            return CommandResult(ENOENT_RC, f"no pool {cmd['pool']!r}")
        if pool.pool_type == "erasure":
            return CommandResult(
                EINVAL_RC, "EC pools do not support self-managed snaps"
            )
        pending = self._pending()
        staged = next((p for p in pending.new_pools
                       if p.pool_id == pool.pool_id), None)
        updated = staged or PoolInfo.from_dict(pool.to_dict())
        updated.snap_seq += 1
        if staged is None:
            pending.new_pools.append(updated)
        return CommandResult(outs=f"snap {updated.snap_seq} created",
                             data={"snapid": updated.snap_seq})

    def _cmd_snap_rm(self, cmd: dict) -> CommandResult:
        pool = self._pool_by_name(cmd["pool"])
        if pool is None:
            return CommandResult(ENOENT_RC, f"no pool {cmd['pool']!r}")
        snapid = int(cmd["snapid"])
        if snapid <= 0 or snapid > pool.snap_seq:
            return CommandResult(ENOENT_RC, f"no snap {snapid}")
        if snapid in pool.removed_snaps:
            return CommandResult(outs=f"snap {snapid} already removed")
        pending = self._pending()
        staged = next((p for p in pending.new_pools
                       if p.pool_id == pool.pool_id), None)
        updated = staged or PoolInfo.from_dict(pool.to_dict())
        updated.removed_snaps = sorted(set(updated.removed_snaps)
                                       | {snapid})
        if staged is None:
            pending.new_pools.append(updated)
        return CommandResult(outs=f"snap {snapid} removed",
                             data={"snapid": snapid})

    def _parse_pgid(self, cmd: dict) -> tuple[int, int] | CommandResult:
        try:
            pid_s, _, ps_s = str(cmd["pgid"]).partition(".")
            pid, ps = int(pid_s), int(ps_s)
        except (KeyError, ValueError):
            return CommandResult(EINVAL_RC,
                                 f"bad pgid {cmd.get('pgid')!r}")
        pool = self.osdmap.pools.get(pid)
        if pool is None:
            return CommandResult(ENOENT_RC, f"no pool {pid}")
        if not 0 <= ps < pool.pg_num:
            return CommandResult(ENOENT_RC, f"pg {pid}.{ps} out of range")
        return pid, ps

    def _cmd_upmap_items(self, cmd: dict) -> CommandResult:
        """``osd pg-upmap-items <pgid> <from> <to> [...]`` — persistent
        up-set remap (OSDMonitor's MOSDPGUpmapItems / balancer upmap
        surface)."""
        pgid = self._parse_pgid(cmd)
        if isinstance(pgid, CommandResult):
            return pgid
        pairs = [(int(a), int(b)) for a, b in cmd.get("mappings", [])]
        if not pairs:
            return CommandResult(EINVAL_RC, "no mappings")
        for _, to in pairs:
            if to not in self.osdmap.osds:
                return CommandResult(ENOENT_RC, f"no osd.{to}")
        self._pending().new_pg_upmap_items[pgid] = pairs
        return CommandResult(outs=f"upmap {pgid[0]}.{pgid[1]} {pairs}")

    def _cmd_rm_upmap_items(self, cmd: dict) -> CommandResult:
        pgid = self._parse_pgid(cmd)
        if isinstance(pgid, CommandResult):
            return pgid
        self._pending().new_pg_upmap_items[pgid] = []
        return CommandResult(outs=f"removed upmap {pgid[0]}.{pgid[1]}")

    def _staged_pool(self, name: str) -> "PoolInfo | CommandResult":
        """A mutable copy of a pool staged into the pending incremental
        (reusing an already-staged copy so multi-field tier commands in
        one epoch compose)."""
        pool = self._pool_by_name(name)
        if pool is None:
            return CommandResult(ENOENT_RC, f"no pool {name!r}")
        pending = self._pending()
        staged = next((p for p in pending.new_pools
                       if p.pool_id == pool.pool_id), None)
        if staged is not None:
            return staged
        updated = PoolInfo.from_dict(pool.to_dict())
        pending.new_pools.append(updated)
        return updated

    def _cmd_tier(self, name: str, cmd: dict) -> CommandResult:
        """Cache-tier wiring (OSDMonitor 'osd tier *' commands):
        add/remove the tier link, set the cache mode, and point the
        base pool's client overlay at the cache."""
        if name == "osd tier add":
            base = self._staged_pool(cmd["pool"])
            cache = self._staged_pool(cmd["tierpool"])
            for r in (base, cache):
                if isinstance(r, CommandResult):
                    return r
            if cache.tier_of >= 0:
                return CommandResult(EINVAL_RC,
                                     f"{cache.name!r} is already a tier")
            if base.tier_of >= 0 or cache.pool_id == base.pool_id:
                return CommandResult(EINVAL_RC, "invalid tier pair")
            cache.tier_of = base.pool_id
            return CommandResult(
                outs=f"{cache.name!r} is now a tier of {base.name!r}"
            )
        if name == "osd tier cache-mode":
            cache = self._staged_pool(cmd["pool"])
            if isinstance(cache, CommandResult):
                return cache
            mode = str(cmd.get("mode", ""))
            if mode not in ("none", "writeback", "readonly"):
                return CommandResult(
                    EINVAL_RC, "mode must be none|writeback|readonly"
                )
            if cache.tier_of < 0:
                return CommandResult(EINVAL_RC,
                                     f"{cache.name!r} is not a tier")
            cache.cache_mode = "" if mode == "none" else mode
            return CommandResult(outs=f"cache-mode {mode}")
        if name == "osd tier set-overlay":
            base = self._staged_pool(cmd["pool"])
            cache = self._staged_pool(cmd["overlaypool"])
            for r in (base, cache):
                if isinstance(r, CommandResult):
                    return r
            if cache.tier_of != base.pool_id:
                return CommandResult(
                    EINVAL_RC,
                    f"{cache.name!r} is not a tier of {base.name!r}"
                )
            if not cache.cache_mode:
                return CommandResult(EINVAL_RC,
                                     "set cache-mode before the overlay")
            base.read_tier = cache.pool_id
            # readonly caches serve reads only: writes keep hitting the
            # base directly (stale-cache caveat matches the reference)
            base.write_tier = (cache.pool_id
                               if cache.cache_mode == "writeback"
                               else -1)
            return CommandResult(outs="overlay set")
        if name == "osd tier remove-overlay":
            base = self._staged_pool(cmd["pool"])
            if isinstance(base, CommandResult):
                return base
            base.read_tier = -1
            base.write_tier = -1
            return CommandResult(outs="overlay removed")
        if name == "osd tier remove":
            base = self._staged_pool(cmd["pool"])
            cache = self._staged_pool(cmd["tierpool"])
            for r in (base, cache):
                if isinstance(r, CommandResult):
                    return r
            if cache.tier_of != base.pool_id:
                return CommandResult(EINVAL_RC, "not a tier of that pool")
            if base.read_tier == cache.pool_id \
                    or base.write_tier == cache.pool_id:
                return CommandResult(EINVAL_RC,
                                     "remove the overlay first")
            cache.tier_of = -1
            cache.cache_mode = ""
            return CommandResult(outs="tier removed")
        return CommandResult(EINVAL_RC, f"unrecognized command {name!r}")

    # every accepted flag is ENFORCED somewhere (noout: tick out-aging;
    # noin: boot weight; noup: boot; nodown: failure reports; pause:
    # OSD op path; norecover/nobackfill: peering recovery gate;
    # norebalance: peering backfill gate for PGs whose motion is pure
    # remap — degraded recovery still runs; noscrub: scrub loop) —
    # accepting a no-op flag would lie to the operator
    def _cmd_setcrushmap(self, cmd: dict) -> CommandResult:
        """``osd setcrushmap`` with the compiler text form (the
        crushtool -c | ceph osd setcrushmap pipeline): the candidate
        map must still satisfy every pool's rule."""
        from ceph_tpu_torch.placement.compiler import CompileError, compile_text

        if self.pending is not None \
                and self.pending.new_crush is not None:
            # e.g. an OSD boot staged a host/bucket insertion this
            # round; replacing it wholesale would silently drop that
            # OSD from CRUSH — the operator retries after the commit
            return CommandResult(
                -11, "crush edits pending in this epoch; retry"
            )
        try:
            new_crush = compile_text(str(cmd.get("map", "")))
        except CompileError as e:
            return CommandResult(EINVAL_RC, f"compile failed: {e}")
        staged = (self.pending.new_pools
                  if self.pending is not None else [])
        for pool in list(self.osdmap.pools.values()) + list(staged):
            if pool.crush_rule not in new_crush.rules:
                return CommandResult(
                    EINVAL_RC,
                    f"pool {pool.name!r} needs rule "
                    f"{pool.crush_rule!r}, absent from the new map",
                )
        self._pending().new_crush = new_crush.to_dict()
        self.mon.cluster_log("warn", "crush map replaced by operator")
        return CommandResult(outs="set crush map")

    FLAGS = ("noout", "noin", "noup", "nodown", "pause", "norecover",
             "nobackfill", "norebalance", "noscrub")

    def _cmd_pool_quota(self, cmd: dict) -> CommandResult:
        """osd pool set-quota <pool> max_bytes|max_objects <val>
        (0 clears).  The limit is staged on the pool; enforcement
        rides the quota sweep against the PGMap digest."""
        pool = self._pool_by_name(cmd.get("pool", ""))
        if pool is None:
            return CommandResult(ENOENT_RC,
                                 f"no pool {cmd.get('pool')!r}")
        field = str(cmd.get("field", ""))
        if field not in ("max_bytes", "max_objects"):
            return CommandResult(EINVAL_RC,
                                 f"field must be max_bytes or "
                                 f"max_objects, not {field!r}")
        val = int(cmd.get("value", 0))
        if val < 0:
            return CommandResult(EINVAL_RC, "value must be >= 0")
        import copy
        updated = copy.deepcopy(pool)
        setattr(updated, f"quota_{field}", val)
        if val == 0 and updated.quota_max_bytes == 0 \
                and updated.quota_max_objects == 0:
            updated.full_quota = False      # cleared limits unfence
        self._pending().new_pools.append(updated)
        return CommandResult(
            outs=f"set-quota {field}={val} on pool {pool.name}")

    def check_pool_quotas(self) -> bool:
        """Compare each pool's usage (PGMap digest) against its
        quota; stage full_quota transitions.  True when a map change
        was staged (OSDMonitor::check_full_pools role)."""
        digest = getattr(self.mon.mgr_stat, "digest", None) or {}
        pstats = digest.get("pools", {})
        changed = False
        for pid, pool in self.osdmap.pools.items():
            if not pool.quota_max_bytes \
                    and not pool.quota_max_objects:
                continue
            st = pstats.get(pid) or pstats.get(str(pid)) or {}
            over = (
                (pool.quota_max_bytes
                 and int(st.get("num_bytes", 0))
                 >= pool.quota_max_bytes)
                or (pool.quota_max_objects
                    and int(st.get("num_objects", 0))
                    >= pool.quota_max_objects))
            if bool(over) == pool.full_quota:
                continue
            import copy
            updated = copy.deepcopy(pool)
            updated.full_quota = bool(over)
            self._pending().new_pools.append(updated)
            changed = True
            self.mon.cluster_log(
                "warn" if over else "info",
                f"pool '{pool.name}' is "
                f"{'full (quota)' if over else 'no longer full'}")
        return changed

    def _cmd_blocklist(self, cmd: dict) -> CommandResult:
        """osd blocklist add/rm (OSDMonitor blocklist role): fence a
        client instance ("entity:nonce") or every instance of an
        entity (bare name) until the expiry walltime.  Expired
        entries are pruned with each staged change."""
        action = str(cmd.get("action", "add"))
        ent = str(cmd.get("entity", ""))
        if not ent:
            return CommandResult(EINVAL_RC, "entity required")
        pending = self._pending()
        now = time.time()
        if action == "add":
            expire = float(cmd.get("expire", 3600.0))
            if expire <= 0:
                return CommandResult(EINVAL_RC, "expire must be > 0")
            pending.new_blocklist[ent] = now + expire
        elif action == "rm":
            if ent not in self.osdmap.blocklist \
                    and ent not in pending.new_blocklist:
                return CommandResult(ENOENT_RC,
                                     f"{ent} not blocklisted")
            pending.new_blocklist.pop(ent, None)
            pending.old_blocklist.append(ent)
        else:
            return CommandResult(EINVAL_RC,
                                 f"unknown action {action!r}")
        for k, until in self.osdmap.blocklist.items():
            # never prune a key being (re-)staged this epoch: apply()
            # runs new_blocklist before old_blocklist, so the prune
            # would delete the fresh entry in the same epoch
            if until <= now and k not in pending.old_blocklist \
                    and k not in pending.new_blocklist:
                pending.old_blocklist.append(k)
        return CommandResult(
            outs=f"blocklist {action} {ent}")

    def _cmd_flag(self, setting: bool, cmd: dict) -> CommandResult:
        """`osd set/unset <flag>` (the CEPH_OSDMAP_* cluster flags)."""
        flag = str(cmd.get("flag", ""))
        if flag not in self.FLAGS:
            return CommandResult(
                EINVAL_RC, f"flag must be one of {self.FLAGS}"
            )
        pending = self._pending()
        # the LAST command wins within one pending epoch: leaving the
        # flag on the opposite list would make apply (set then unset)
        # silently resolve set-after-unset to unset
        if setting:
            if flag in pending.unset_flags:
                pending.unset_flags.remove(flag)
            if flag not in pending.set_flags:
                pending.set_flags.append(flag)
            self.mon.cluster_log("warn", f"osdmap flag {flag} set")
        else:
            if flag in pending.set_flags:
                pending.set_flags.remove(flag)
            if flag not in pending.unset_flags:
                pending.unset_flags.append(flag)
            self.mon.cluster_log("info", f"osdmap flag {flag} unset")
        return CommandResult(
            outs=f"{flag} is {'set' if setting else 'unset'}"
        )

    def _cmd_osd_state(self, name: str, cmd: dict) -> CommandResult:
        ids = [int(i) for i in cmd.get("ids", [])]
        pending = self._pending()
        for osd in ids:
            if osd not in self.osdmap.osds:
                return CommandResult(ENOENT_RC, f"no osd.{osd}")
            if name == "osd out":
                pending.new_weights[osd] = 0
            elif name == "osd in":
                pending.new_weights[osd] = 0x10000
            elif name == "osd down":
                if osd not in pending.new_down:
                    pending.new_down.append(osd)
        return CommandResult(outs=f"{name} {ids}")

    def _cmd_osd_purge(self, cmd: dict) -> CommandResult:
        """``osd purge <id>``: remove a drained OSD from the map and
        its CRUSH device item (the drain-then-remove epilogue).  The
        OSD must already be down AND out — purging live or still-
        weighted daemons would turn planned motion into failure
        repair."""
        osd = int(cmd["id"])
        info = self.osdmap.osds.get(osd)
        if info is None:
            return CommandResult(ENOENT_RC, f"no osd.{osd}")
        if info.up:
            return CommandResult(
                EINVAL_RC, f"osd.{osd} is up; stop it first")
        pending = self._pending()
        weight = pending.new_weights.get(osd, info.weight)
        if weight > 0:
            return CommandResult(
                EINVAL_RC,
                f"osd.{osd} is in; mark it out and wait for motion "
                "to complete first")
        if osd not in pending.removed_osds:
            pending.removed_osds.append(osd)
        new_crush = (CrushMap.from_dict(pending.new_crush)
                     if pending.new_crush else
                     CrushMap.from_dict(self.osdmap.crush.to_dict()))
        if new_crush.remove_item(osd):
            pending.new_crush = new_crush.to_dict()
        self.mon.cluster_log("info", f"osd.{osd} purged")
        return CommandResult(outs=f"purged osd.{osd}")

    def _merge_unsettled(self, pool_id: int) -> str | None:
        """The mon-visible ready-to-merge signals (the reference gates
        per-PG ready_to_merge reports; -lite uses what the mon holds):
        in-flight placement overrides mean the fold migration has not
        settled, and a PGMap digest (when an mgr runs) showing
        degradation means replicas are not yet identical."""
        if any(pid == pool_id for (pid, _ps) in self.osdmap.pg_temp):
            return "pg_temp overrides still active for this pool"
        digest = getattr(self.mon.mgr_stat, "digest", None) or {}
        pools = digest.get("pools") or {}
        pool_stats = pools.get(pool_id) or pools.get(str(pool_id))
        if pool_stats and int(pool_stats.get("degraded", 0)) > 0:
            return "pool has degraded objects"
        for state, count in (digest.get("pgs_by_state") or {}).items():
            if count and any(tok in state for tok in
                             ("peering", "recovering", "backfill",
                              "degraded", "down", "incomplete")):
                return f"cluster has {count} pgs {state}"
        return None

    def _cmd_device_class(self, name: str, cmd: dict) -> CommandResult:
        """``osd crush set-device-class <class> <ids>`` /
        ``rm-device-class <ids>`` (OSDMonitor.cc device-class commands):
        tag devices so class-restricted rules (shadow trees) see them."""
        ids = cmd.get("ids", cmd.get("id"))
        if ids is None:
            return CommandResult(-22, "ids required")
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        cls = str(cmd.get("class", ""))
        if name.endswith("set-device-class") and not cls:
            return CommandResult(-22, "class required")
        pending = self._pending()
        crush = (CrushMap.from_dict(pending.new_crush)
                 if pending.new_crush
                 else CrushMap.from_dict(self.osdmap.crush.to_dict()))
        # known = in a crush bucket OR registered in the OSDMap (the
        # reference checks osdmap.exists(id) and will create the crush
        # item later); truly unknown ids are rejected (-ENOENT) so no
        # phantom entry round-trips in the map forever
        present = {i for b in crush.buckets.values()
                   for i in b.items if i >= 0} | set(self.osdmap.osds)
        done = []
        for raw in ids:
            osd = int(str(raw).removeprefix("osd."))
            if osd not in present:
                return CommandResult(ENOENT_RC,
                                     f"osd.{osd} does not exist")
            crush.set_item_class(
                osd, cls if name.endswith("set-device-class") else "")
            done.append(osd)
        pending.new_crush = crush.to_dict()
        verb = "set" if name.endswith("set-device-class") else "removed"
        return CommandResult(
            outs=f"{verb} class {cls or '(none)'} on osds {done}")

    def _tree(self) -> dict:
        """``osd tree`` output: nested buckets + device states."""
        crush = self.osdmap.crush

        def node(item_id: int):
            if item_id >= 0:
                info = self.osdmap.osds.get(item_id)
                return {
                    "id": item_id, "name": f"osd.{item_id}", "type": "osd",
                    "status": "up" if info and info.up else "down",
                    "reweight": (info.weight / 0x10000) if info else 0.0,
                }
            b = crush.buckets[item_id]
            type_name = next(
                (t for t, i in crush.types.items() if i == b.type_id), "?"
            )
            return {
                "id": b.id, "name": b.name, "type": type_name,
                "children": [node(c) for c in b.items],
            }

        roots = [
            b.id for b in crush.buckets.values()
            if b.id not in crush._parent and not crush.is_shadow(b.id)
        ]
        return {"nodes": [node(r) for r in sorted(roots, reverse=True)]}
