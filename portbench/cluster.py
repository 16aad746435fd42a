"""Boot the cluster a configuration file describes, from the port's
public entry points: ``vstart.DevCluster`` and mon commands through a
``Rados`` client."""

from __future__ import annotations

import asyncio

WAIT_S = 120.0


def settings(config: dict, trace: bool) -> dict:
    """The config overrides a run hands every entity: each key that
    ``DevCluster`` forces for tests back at the schema default, then the
    configuration's own settings, then, in a traced run, every op
    sampled."""
    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.common.config import global_options

    defaults = {o.name: o.default for o in global_options()}
    out = {key: defaults[key] for key in vstart.FAST_TEST_OVERRIDES}
    out.update({key: value for key, (value, _why)
                in config.get("settings", {}).items()})
    if trace:
        out["trace_probability"] = 1.0
    return out


async def until(cond, what: str, timeout: float = WAIT_S,
                every: float = 0.05) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise TimeoutError(f"no {what} in {timeout:.0f} s")
        await asyncio.sleep(every)


async def command(rados, prefix: str, **kw) -> dict:
    r = await rados.mon_command(prefix, timeout=WAIT_S, **kw)
    if r["rc"] != 0:
        raise RuntimeError(f"{prefix}: {r}")
    return r


def pool_active(cluster, pool_id: int, pg_num: int) -> bool:
    """Every PG of the pool is active on its primary."""
    return sum(1 for osd in cluster.osds.values()
               for pgid, pg in osd.pgs.items()
               if pgid.pool == pool_id and pg.is_primary
               and pg.state == "active") == pg_num


class Cluster:
    """A running DevCluster with its admin client and the pools of the
    configuration (name -> pool id)."""

    def __init__(self, config: dict, device, trace: bool):
        self.config = config
        self.device = device
        self.trace = trace
        self.dev = None
        self.rados = None
        self.pools: dict[str, int] = {}

    async def start(self) -> None:
        from ceph_tpu_torch import vstart
        from ceph_tpu_torch.msg import reset_local_namespace
        from ceph_tpu_torch.placement import compiler

        if self.config["store"] != "memstore":
            raise ValueError(f"store {self.config['store']!r}: only "
                             f"memstore is supported")
        reset_local_namespace()
        shape = self.config["cluster"]
        self.dev = vstart.DevCluster(
            n_mons=shape["mons"], n_osds=shape["osds"],
            osds_per_host=shape["osds_per_host"],
            overrides=settings(self.config, self.trace),
            device=self.device)
        await self.dev.start()
        self.rados = await self.dev.client()
        tries = self.config.get("crush", {}).get("choose_total_tries")
        if tries:
            text = compiler.decompile(self.rados.monc.osdmap.crush)
            old = "tunable choose_total_tries 50\n"
            if old not in text:
                raise RuntimeError("the CRUSH map's choose_total_tries "
                                   "is not 50")
            await command(self.rados, "osd setcrushmap", map=text.replace(
                old, f"tunable choose_total_tries {tries}\n"))
        prof = dict(self.config["ec_profile"])
        await command(self.rados, "osd erasure-code-profile set",
                      name=prof.pop("name"), profile=prof)
        for pool in self.config["pools"]:
            kw = {"pg_num": pool["pg_num"]}
            if pool["type"] == "erasure":
                kw.update(pool_type="erasure",
                          erasure_code_profile=pool["profile"])
            else:
                kw.update(pool_type="replicated", size=pool["size"])
            pid = await self.rados.pool_create(pool["name"], **kw)
            self.pools[pool["name"]] = pid
            await until(lambda: pool_active(self.dev, pid, pool["pg_num"]),
                        f"active PGs of {pool['name']}")

    def daemons(self) -> list:
        return list(self.dev.osds.values())

    def tracers(self) -> list:
        """Every span ring of the run: the OSD daemons and their
        messengers, and the admin client's objecter and messenger."""
        out = []
        for osd in self.dev.osds.values():
            out += [osd.tracer, osd.msgr.tracer]
        return out + [self.rados.objecter.tracer, self.rados.msgr.tracer]

    async def kill_osd(self, osd_id: int) -> None:
        """Stop a daemon and mark it down (not out); wait for the map."""
        await self.dev.kill_osd(osd_id)
        await command(self.rados, "osd down", ids=[osd_id])
        await until(lambda: not self.rados.monc.osdmap.is_up(osd_id),
                    f"a map with osd.{osd_id} down")

    async def wait_active(self) -> None:
        for pool in self.config["pools"]:
            pid = self.pools[pool["name"]]
            await until(lambda: pool_active(self.dev, pid, pool["pg_num"]),
                        f"active PGs of {pool['name']}")

    async def stop(self) -> None:
        from ceph_tpu_torch.msg import reset_local_namespace

        try:
            if self.rados is not None:
                await self.rados.shutdown()
            if self.dev is not None:
                await self.dev.stop()
        finally:
            reset_local_namespace()
