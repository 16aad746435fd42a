"""One monitor quorum that mixes the packages, over loopback TCP.

Mons ``a`` and ``c`` are the port's and ``b`` the JAX package's, with
signed mon-internal messages (``auth_shared_key``).  Commits replicate,
and every mon holds the same paxos value at every version and the same
encoded ``OSDMap`` at every epoch.  A peon of either package forwards
commands to a leader of the other: ``b`` to the port's leader ``a``, then,
once ``a`` is killed and the quorum fails over to ``b``, ``c`` to the JAX
package's leader.  Last, a fresh mon of each package syncs its whole store
from a quorum of the other package's mons, past the paxos trim window.
Tolerance 0.

The two packages keep separate ``local://`` namespaces, so every address
here is ``tcp://127.0.0.1:<port>``.
"""

import asyncio

import pytest

from tests.test_torch_mon import (PKGS, PORT, REF, SLACK,
                                  assert_same_values, fast_conf, free_ports,
                                  propose_n, wait_committed, wait_epoch,
                                  wait_for, wait_quorum)


def _monmap(names) -> dict[str, str]:
    return {n: f"tcp://127.0.0.1:{p}"
            for n, p in zip(names, free_ports(len(names)))}


def _assert_same_history(mons, lc: int) -> None:
    """Every mon holds the same paxos value at every version they all
    hold, ``lc`` among them, and the same encoded full OSDMap at every
    epoch."""
    assert_same_values(mons, lc)
    epoch = min(m.osd_monitor.osdmap.epoch for m in mons)
    for e in range(1, epoch + 1):
        fulls = {m.store.get("osdmap", f"full_{e}") for m in mons}
        assert len(fulls) == 1 and None not in fulls, e


def test_mixed_quorum_commits_forwards_and_fails_over():
    key = "k3y"
    kinds = {"a": PORT, "b": REF, "c": PORT}

    async def run():
        monmap = _monmap("abc")
        mons = {}
        for n in "abc":
            pkg = kinds[n]
            mons[n] = pkg.Monitor(n, monmap,
                                  fast_conf(pkg, auth_shared_key=key))
            await mons[n].start()
        a, b, c = mons["a"], mons["b"], mons["c"]
        leader = await wait_quorum([a, b, c], size=3)
        assert leader is a
        await wait_epoch([a, b, c], 1)

        # the JAX package's client, on the JAX package's peon b only:
        # b forwards every mutation to the port's leader a
        rc = REF.MonClient("client.ref", {"b": monmap["b"]},
                           fast_conf(REF, auth_shared_key=key))
        await rc.start()
        for prefix, kw in (
                ("osd pool create", {"pool": "rbd", "pg_num": 8}),
                ("osd erasure-code-profile set",
                 {"name": "p42",
                  "profile": {"plugin": "jax_rs", "k": "4", "m": "2"}}),
                ("osd pool create", {"pool": "ec", "pool_type": "erasure",
                                     "erasure_code_profile": "p42",
                                     "pg_num": 8}),
                ("config set", {"name": "osd_recovery_max_active",
                                "value": "3"}),
                ("log", {"message": "across the packages"})):
            r = await rc.command(prefix, timeout=15 * SLACK, **kw)
            assert r["rc"] == 0, (prefix, r)
        # OSDs boot through the JAX package's MonClient too
        rc.sub_want("osdmap")
        rc.renew_subs()
        for i in range(3):
            await rc.send_boot(i, f"tcp://127.0.0.1:{7000 + i}",
                               host=f"h{i}")
        await a.osd_monitor.wait_map(
            lambda m: all(m.is_up(i) for i in range(3)), timeout=10 * SLACK)
        lc = a.paxos.last_committed
        await wait_committed([a, b, c], lc)
        _assert_same_history([a, b, c], lc)
        pools = {p.name: p.size for p in b.osd_monitor.osdmap.pools.values()}
        assert pools == {"rbd": 3, "ec": 6}
        assert "ec_p42" in c.osd_monitor.osdmap.crush.rules
        await rc.shutdown()

        # kill the port's leader: the quorum fails over to the JAX
        # package's b, and the port's peon c forwards to it
        await a.shutdown()
        new_leader = await wait_quorum([b, c], timeout=15.0 * SLACK)
        assert new_leader is b
        pc = PORT.MonClient("client.port", {"c": monmap["c"]},
                            fast_conf(PORT, auth_shared_key=key))
        await pc.start()
        r = await pc.command("osd pool create", pool="after", pg_num=8,
                             timeout=15 * SLACK)
        assert r["rc"] == 0, r
        r = await pc.command("osd out", ids=[1], timeout=15 * SLACK)
        assert r["rc"] == 0, r
        pc.sub_want("osdmap")
        pc.renew_subs()
        m = await pc.wait_for_map(b.osd_monitor.osdmap.epoch)
        assert m.osds[1].weight == 0
        assert "after" in {p.name for p in m.pools.values()}
        lc = b.paxos.last_committed
        await wait_committed([b, c], lc)
        _assert_same_history([b, c], lc)
        st = await pc.command("quorum_status")
        assert st["data"]["leader"] == "b"
        assert st["data"]["quorum"] == ["b", "c"]
        await pc.shutdown()
        for mon in (b, c):
            await mon.shutdown()

    asyncio.run(run())


@pytest.mark.parametrize("fresh", ["ceph_tpu_torch", "ceph_tpu"])
def test_fresh_mon_syncs_its_store_from_the_other_package(
        tmp_path, monkeypatch, fresh):
    """Mons a and b of one package commit past the trim window; a brand
    new mon c of the other package must copy the whole store from them,
    join the quorum, and follow later commits."""
    new = PKGS[fresh]
    old = REF if new is PORT else PORT
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.paxos, "KEEP_VERSIONS", 20)

    async def run():
        monmap = _monmap("abc")
        paths = {n: str(tmp_path / f"mon.{n}") for n in "abc"}
        ab = []
        for n in "ab":
            mon = old.Monitor(n, monmap, fast_conf(old),
                              store_path=paths[n])
            await mon.start()
            ab.append(mon)
        a, b = ab
        await wait_quorum(ab, size=2)
        await propose_n(a, 30, "hist", old.StoreTransaction)
        lc = a.paxos.last_committed
        assert a.paxos.version_value(1) is None   # trimmed

        c = new.Monitor("c", monmap, fast_conf(new), store_path=paths["c"])
        await c.start()
        await wait_for(lambda: c.paxos.last_committed >= lc,
                       timeout=20.0 * SLACK)
        assert c.store.get("synctest", "hist-0") == b"v0"
        await wait_for(lambda: c.elector.in_quorum(), timeout=20.0 * SLACK)
        await propose_n(a, 3, "after", old.StoreTransaction)
        lc = a.paxos.last_committed
        await wait_committed([a, b, c], lc)
        assert c.store.get("synctest", "after-2") == b"v2"
        _assert_same_history([a, b, c], lc)
        for m in (a, b, c):
            await m.shutdown()

    asyncio.run(run())
