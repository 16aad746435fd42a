"""The port's monitor against the JAX package's, on the CPU.

Every scenario of tests/test_mon.py and test_mon_sync.py that needs no
OSD daemon and no mgr is written once over a package handle (``Pkg``) and
run on each package in turn, each over its own ``local://`` namespace.
The command results must be equal across the packages, and so must the
committed paxos values at every version, byte for byte: the wall clock
and the random draws that land in committed values (the auth database's
secrets and stamps, the cluster log's stamps, the FSMap's creation time,
the blocklist's expiry) are patched to the same fixed sequences in both
packages' modules (``deterministic``).  Last, the ``MonitorDBStore``
directories are read across the packages both ways, WAL replay and torn
tail included.  Tolerance 0.

The helpers here (``Pkg``, ``fast_conf``, ``start_mons``, ``wait_quorum``,
``committed``, ``propose_n``, ``free_ports``) serve the other
tests/test_torch_mon_*.py files and tests/test_torch_client.py too.
"""

import asyncio
import hashlib
import importlib
import itertools
import socket
import time as _time
from types import SimpleNamespace

import pytest

from tests._deps import requires_cryptography

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
# deadlines are three times the reference tests' (the suite runs on six
# workers); every wait ends on an event, never on a wall-clock window
SLACK = 3.0


class Pkg:
    """One package's monitor and client surface."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.monpkg = mod("mon")
        self.Monitor = self.monpkg.Monitor
        self.MonClient = self.monpkg.MonClient
        self.MonitorDBStore = self.monpkg.MonitorDBStore
        self.StoreTransaction = mod("mon.store").StoreTransaction
        self.paxos = mod("mon.paxos")
        self.ConfigProxy = mod("common.config").ConfigProxy
        self.msg = mod("msg")
        self.osd_map = mod("osd.osd_map")
        # the modules whose committed values read the clock or draw
        # random bytes
        self.stamped = [mod(f"mon.{m}") for m in (
            "auth_monitor", "log_monitor", "mds_monitor", "osd_monitor")]

    def reset(self) -> None:
        self.msg.reset_local_namespace()


PKGS = {name: Pkg(name) for name in PKG_NAMES}
REF, PORT = PKGS["ceph_tpu"], PKGS["ceph_tpu_torch"]

FIXED_TIME = 1_750_000_000.0


class _Secrets:
    """``secrets`` with a counter-driven ``token_hex``."""

    def __init__(self):
        self.n = itertools.count()

    def token_hex(self, nbytes: int = 32) -> str:
        seed = f"token-{next(self.n)}".encode()
        return hashlib.sha256(seed).hexdigest()[:2 * nbytes]


def deterministic(pkg: Pkg, monkeypatch) -> None:
    """Fix the wall clock and the random draws of ``pkg``'s mon services
    (monotonic time stays real: it drives the down-out aging and the
    failure-report windows, never a committed value)."""
    clock = SimpleNamespace(time=lambda: FIXED_TIME,
                            monotonic=_time.monotonic)
    draws = _Secrets()
    for m in pkg.stamped:
        monkeypatch.setattr(m, "time", clock)
        if hasattr(m, "secrets"):
            monkeypatch.setattr(m, "secrets", draws)


def fast_conf(pkg: Pkg, **over):
    overrides = {
        "mon_lease": 0.4, "mon_lease_interval": 0.1,
        "mon_election_timeout": 0.3, "mon_tick_interval": 0.1,
        "mon_accept_timeout": 0.5,
    }
    overrides.update(over)
    return pkg.ConfigProxy(overrides=overrides)


async def start_mons(pkg: Pkg, names, conf=None, store_paths=None,
                     monmap=None):
    conf = conf or (lambda: fast_conf(pkg))
    monmap = monmap or {n: f"local://mon.{n}" for n in names}
    mons = []
    for n in names:
        mon = pkg.Monitor(n, monmap, conf(),
                          store_path=store_paths.get(n)
                          if store_paths else None)
        await mon.start()
        mons.append(mon)
    return mons


async def wait_quorum(mons, timeout=10.0 * SLACK, size=None):
    """The leader, once every live mon agrees on it, no election runs,
    its paxos is ready and (with ``size``) the quorum has that many
    members."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    alive = [m for m in mons if not m._stopped]
    while True:
        leaders = {m.elector.leader for m in alive}
        if (len(leaders) == 1 and None not in leaders
                and all(not m.elector.electing for m in alive)
                and any(m.is_leader and m.paxos.ready for m in alive)):
            leader = next(m for m in alive if m.is_leader)
            if size is None or len(leader.elector.quorum) == size:
                return leader
        if loop.time() > deadline:
            raise TimeoutError("no quorum: " + "; ".join(
                elector_state(m) for m in alive))
        await asyncio.sleep(0.02)


def elector_state(mon) -> str:
    """One live mon's election state, for a quorum that never formed."""
    e = mon.elector
    state = ("electing" if e.electing else
             "leader" if mon.is_leader else
             "peon" if e.leader is not None else "probing")
    return (f"{mon.name}: state={state} epoch={e.epoch} "
            f"leader={e.leader} electing={e.electing} "
            f"quorum={e.quorum} paxos.ready={mon.paxos.ready}")


async def wait_epoch(mons, epoch, timeout=10.0 * SLACK):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while any(m.osd_monitor.osdmap.epoch < epoch for m in mons
              if not m._stopped):
        if loop.time() > deadline:
            raise TimeoutError("epoch not reached")
        await asyncio.sleep(0.02)


async def wait_for(cond, timeout=15.0 * SLACK, every=0.02):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        assert loop.time() < deadline, "timeout"
        await asyncio.sleep(every)


async def wait_committed(mons, v, timeout=10.0 * SLACK):
    """Every live mon has committed version ``v``."""
    await wait_for(lambda: all(m.paxos.last_committed >= v
                               for m in mons if not m._stopped), timeout)


def committed(mon) -> dict[int, bytes]:
    """The paxos value ``mon`` holds at every version it kept."""
    return {v: mon.paxos.version_value(v)
            for v in range(1, mon.paxos.last_committed + 1)
            if mon.paxos.version_value(v) is not None}


def assert_same_values(mons, lc: int) -> dict[int, bytes]:
    """Every mon holds the same paxos value at every version that all of
    them still hold, version ``lc`` among them (a leader's tick may
    commit a cluster-log entry past ``lc`` while this reads).  Returns
    the first mon's values."""
    values = [committed(m) for m in mons]
    common = set.intersection(*(set(v) for v in values))
    assert lc in common, (lc, sorted(common)[-3:])
    for m, v in zip(mons[1:], values[1:]):
        assert all(v[x] == values[0][x] for x in common), m.name
    return values[0]


async def propose_n(leader, n, tag, tx_cls):
    """``n`` values proposed on ``leader``, each retried across a quorum
    change (the value is idempotent)."""
    for i in range(n):
        for _ in range(50):
            try:
                await leader.paxos.propose(
                    tx_cls().put("synctest", f"{tag}-{i}", f"v{i}".encode()))
                break
            except ConnectionError:
                await asyncio.sleep(0.1)
        else:
            raise AssertionError(f"propose {tag}-{i} never committed")


def free_ports(n: int) -> list[int]:
    """``n`` loopback TCP ports free at the time of the call."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_on_both(scenario, monkeypatch, *args):
    """``scenario(pkg, *args)`` on each package, in a fresh local://
    namespace and under the fixed clock; returns {root: result}."""
    out = {}
    for name, pkg in PKGS.items():
        with monkeypatch.context() as mp:
            deterministic(pkg, mp)
            pkg.reset()
            try:
                out[name] = asyncio.run(scenario(pkg, *args))
            finally:
                pkg.reset()
    return out


def _untid(value):
    """``value`` without the ``tid`` of each command reply: the client's
    own request counter, which counts a scenario's polls."""
    if isinstance(value, dict):
        return {k: _untid(v) for k, v in value.items() if k != "tid"}
    if isinstance(value, (list, tuple)):
        return type(value)(_untid(v) for v in value)
    return value


def assert_equal_across(out):
    ref, port = _untid(out["ceph_tpu"]), _untid(out["ceph_tpu_torch"])
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key


# ---------------------------------------------------------------------------
# the store, within and across the packages

def _write_store(pkg: Pkg, path: str) -> None:
    s = pkg.MonitorDBStore(path)
    s.apply_transaction(
        pkg.StoreTransaction().put("p", "k1", b"v1").put("p", "k2", 42))
    s.apply_transaction(pkg.StoreTransaction().erase("p", "k1"))
    s.apply_transaction(pkg.StoreTransaction()
                        .put("q", "a", b"\x00\xff" * 300).put("q", "b", 7)
                        .put("r", "x", b"gone"))
    s.apply_transaction(pkg.StoreTransaction().erase_prefix("r"))
    s.close()


def _read_store(pkg: Pkg, path: str) -> dict:
    s = pkg.MonitorDBStore(path)
    try:
        return {p: {k: s.get(p, k) for k in s.keys(p)}
                for p in ("p", "q", "r")}
    finally:
        s.close()


@pytest.mark.parametrize("writer,reader", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu"),
    ("ceph_tpu_torch", "ceph_tpu_torch")])
def test_store_wal_replay_across_packages(tmp_path, writer, reader):
    """A store written by one package replays in the other: puts,
    erases and a prefix erase, the same WAL bytes from either writer."""
    w, r = PKGS[writer], PKGS[reader]
    path = str(tmp_path / "mon.a")
    _write_store(w, path)
    got = _read_store(r, path)
    assert got == {"p": {"k2": b"42"},
                   "q": {"a": b"\x00\xff" * 300, "b": b"7"}, "r": {}}
    s = r.MonitorDBStore(path)
    assert s.get("p", "k1") is None and s.get_int("p", "k2") == 42
    assert list(s.keys("p")) == ["k2"]
    s.close()
    # the same transactions written by the other package give the same
    # WAL bytes
    other = str(tmp_path / "mon.b")
    _write_store(PKGS[reader], other)
    assert (tmp_path / "mon.a" / "store.wal").read_bytes() == \
        (tmp_path / "mon.b" / "store.wal").read_bytes()


@pytest.mark.parametrize("writer,reader", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")])
def test_store_torn_tail_ignored_across_packages(tmp_path, writer, reader):
    """A torn last record written after one package's commits is dropped
    by the other package's replay, and the store stays writable."""
    w, r = PKGS[writer], PKGS[reader]
    path = str(tmp_path / "mon.b")
    s = w.MonitorDBStore(path)
    s.apply_transaction(w.StoreTransaction().put("p", "k", b"good"))
    s.close()
    with open(f"{path}/store.wal", "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")
    s2 = r.MonitorDBStore(path)
    assert s2.get("p", "k") == b"good"
    s2.close()


def test_store_transactions_encode_alike():
    for pkg in (REF, PORT):
        tx = (pkg.StoreTransaction().put("osdmap", "full_3", b"\x01" * 9)
              .put("paxos", "last_committed", 3).erase("logm", "e1")
              .erase_prefix("health"))
        raw = tx.encode()
        assert raw == REF.StoreTransaction.decode(raw).encode()
        assert raw == PORT.StoreTransaction.decode(raw).encode()
    assert (REF.StoreTransaction().put("a", "b", 1).encode()
            == PORT.StoreTransaction().put("a", "b", 1).encode())


# ---------------------------------------------------------------------------
# one monitor

def _logged(mon, text: str) -> bool:
    return any(text in e["message"] for e in mon.log_monitor.entries)


async def _genesis_and_commands(pkg: Pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    await wait_epoch([mon], 1)
    assert "replicated_rule" in mon.osd_monitor.osdmap.crush.rules
    client = pkg.MonClient("client.1", mon.monmap, fast_conf(pkg))
    await client.start()
    results = []

    async def cmd(prefix, **kw):
        r = await client.command(prefix, **kw)
        results.append((prefix, r))
        return r

    assert (await cmd("osd pool create", pool="rbd", pg_num=8))["rc"] == 0
    assert (await cmd("osd pool ls"))["data"] == ["rbd"]
    r = await cmd("osd erasure-code-profile set", name="p42",
                  profile={"plugin": "jax_rs", "k": "4", "m": "2"})
    assert r["rc"] == 0, r
    r = await cmd("osd erasure-code-profile set", name="bad",
                  profile={"plugin": "jax_rs", "k": "0", "m": "2"})
    assert r["rc"] != 0, r
    r = await cmd("osd pool create", pool="ecpool", pool_type="erasure",
                  erasure_code_profile="p42")
    assert r["rc"] == 0, r
    r = await cmd("osd pool get", pool="ecpool")
    assert r["data"]["size"] == 6 and r["data"]["min_size"] == 5
    assert r["data"]["type"] == "erasure"
    assert "ec_p42" in mon.osd_monitor.osdmap.crush.rules
    await cmd("osd pool create", pool="ecdef", pool_type="erasure")
    await cmd("osd erasure-code-profile ls")
    await cmd("osd erasure-code-profile get", name="p42")
    r = await cmd("status")
    assert r["data"]["osdmap"]["num_pools"] == 3
    await cmd("config set", name="osd_recovery_max_active", value="3")
    await cmd("config get", name="osd_recovery_max_active")
    await cmd("config-key set", key="k", value="v")
    await cmd("config-key get", key="k")
    await cmd("log", message="hello world", who="client.test")
    await cmd("log last", num=50)
    await cmd("auth get-or-create", entity="client.x",
              caps={"mon": "allow r"})
    await cmd("auth ls")
    # a flag raises OSDMAP_FLAGS: each health tick's transition is
    # awaited, so the cluster log commits at the same versions each run
    await cmd("osd set", flag="noout")
    await wait_for(lambda: _logged(mon, "(OSDMAP_FLAGS)"))
    await cmd("health")
    await cmd("osd unset", flag="noout")
    await wait_for(lambda: _logged(mon, "Cluster is now healthy"))
    await cmd("osd blocklist", action="add", entity="client.evil")
    await cmd("osd blocklist ls")
    await cmd("osd pool set-quota", pool="rbd", field="max_objects",
              value=10)
    await cmd("osd pool delete", pool="ecdef")
    await cmd("osd dump")
    await cmd("osd getcrushmap")
    await cmd("mon dump")
    await cmd("no such command")
    values = committed(mon)
    await client.shutdown()
    await mon.shutdown()
    return {"results": results, "values": values}


def test_single_mon_genesis_and_commands(monkeypatch):
    out = run_on_both(_genesis_and_commands, monkeypatch)
    assert_equal_across(out)


async def _restart(pkg: Pkg, root):
    paths = {"a": f"{root}/{pkg.root}/mon.a"}
    (mon,) = await start_mons(pkg, ["a"], store_paths=paths)
    await wait_quorum([mon])
    client = pkg.MonClient("client.1", mon.monmap, fast_conf(pkg))
    await client.start()
    r = await client.command("osd pool create", pool="persist")
    assert r["rc"] == 0
    epoch = mon.osd_monitor.osdmap.epoch
    before = committed(mon)
    await client.shutdown()
    await mon.shutdown()
    pkg.reset()
    (mon2,) = await start_mons(pkg, ["a"], store_paths=paths)
    await wait_quorum([mon2])
    assert mon2.osd_monitor.osdmap.epoch == epoch
    pools = [p.name for p in mon2.osd_monitor.osdmap.pools.values()]
    assert pools == ["persist"]
    after = committed(mon2)
    await mon2.shutdown()
    assert {v: after[v] for v in before} == before
    return {"r": r, "epoch": epoch, "pools": pools, "values": before}


def test_mon_restart_recovers_state(tmp_path, monkeypatch):
    out = run_on_both(_restart, monkeypatch, str(tmp_path))
    assert_equal_across(out)


@pytest.mark.parametrize("writer,reader", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")])
def test_mon_restarts_on_the_other_packages_store(tmp_path, monkeypatch,
                                                  writer, reader):
    """A mon of one package commits and stops; a mon of the other package
    starts on that store directory and serves the same maps."""
    w, r = PKGS[writer], PKGS[reader]
    paths = {"a": str(tmp_path / "mon.a")}

    async def first():
        (mon,) = await start_mons(w, ["a"], store_paths=paths)
        await wait_quorum([mon])
        client = w.MonClient("client.1", mon.monmap, fast_conf(w))
        await client.start()
        for name in ("one", "two"):
            assert (await client.command("osd pool create",
                                         pool=name))["rc"] == 0
        await client.command("config set", name="osd_recovery_max_active",
                             value="5")
        dump = (await client.command("osd dump"))["data"]
        values = committed(mon)
        await client.shutdown()
        await mon.shutdown()
        return dump, values

    async def second():
        (mon,) = await start_mons(r, ["a"], store_paths=paths)
        await wait_quorum([mon])
        client = r.MonClient("client.1", mon.monmap, fast_conf(r))
        await client.start()
        dump = (await client.command("osd dump"))["data"]
        conf = (await client.command("config get",
                                     name="osd_recovery_max_active"))
        assert (await client.command("osd pool create",
                                     pool="three"))["rc"] == 0
        values = committed(mon)
        await client.shutdown()
        await mon.shutdown()
        return dump, conf, values

    with monkeypatch.context() as mp:
        deterministic(w, mp)
        w.reset()
        dump_w, values_w = asyncio.run(first())
        w.reset()
    with monkeypatch.context() as mp:
        deterministic(r, mp)
        r.reset()
        dump_r, conf, values_r = asyncio.run(second())
        r.reset()
    assert dump_r == dump_w
    assert conf["rc"] == 0 and str(conf["data"]) == "5", conf
    assert {v: values_r[v] for v in values_w} == values_w
    assert len(values_r) == len(values_w) + 1


# ---------------------------------------------------------------------------
# three monitors

async def _three_mon_quorum(pkg: Pkg):
    mons = await start_mons(pkg, ["a", "b", "c"])
    leader = await wait_quorum(mons, size=3)
    assert leader.name == "a"
    client = pkg.MonClient("client.1", mons[0].monmap, fast_conf(pkg))
    await client.start()
    r = await client.command("osd pool create", pool="pool1")
    assert r["rc"] == 0
    await wait_epoch(mons, leader.osd_monitor.osdmap.epoch)
    await wait_committed(mons, leader.paxos.last_committed)
    pools = [[p.name for p in m.osd_monitor.osdmap.pools.values()]
             for m in mons]
    assert pools == [["pool1"]] * 3
    q = await client.command("quorum_status")
    assert q["data"]["quorum"] == ["a", "b", "c"]
    await client.shutdown()
    maps = [m.osd_monitor.full_map_dict() for m in mons]
    assert maps[1:] == maps[:1] * 2
    values = [committed(m) for m in mons]
    for m in mons:
        await m.shutdown()
    return {"r": r, "pools": pools, "quorum": q["data"]["quorum"],
            "leader": q["data"]["leader"], "map": maps[0],
            "osd_values": _osd_values(values[0])}


def _osd_values(values: dict[int, bytes]) -> list:
    """The committed OSD-map keys in commit order.  A multi-mon scenario
    commits its tick's cluster-log entries (a transient MON_DOWN while the
    quorum forms) at versions that depend on timing, so it compares these;
    the single-mon scenarios compare every version whole."""
    out = []
    for v, raw in sorted(values.items()):
        for op in REF.StoreTransaction.decode(raw).ops:
            if op[1] == "osdmap":
                out.append(op)
    return out


def test_three_mon_quorum_replicates_commits(monkeypatch):
    out = run_on_both(_three_mon_quorum, monkeypatch)
    assert_equal_across(out)


async def _via_peon(pkg: Pkg):
    mons = await start_mons(pkg, ["a", "b", "c"])
    await wait_quorum(mons, size=3)
    client = pkg.MonClient("client.9", {"c": mons[2].monmap["c"]},
                           fast_conf(pkg))
    await client.start()
    r = await client.command("osd pool create", pool="viapeon")
    assert r["rc"] == 0, r
    await wait_epoch(mons, 2)
    ro = await client.command("osd pool ls")      # served by peon c
    assert any(p.name == "viapeon"
               for p in mons[0].osd_monitor.osdmap.pools.values())
    values = committed(mons[0])
    await client.shutdown()
    for m in mons:
        await m.shutdown()
    return {"r": r, "ro": ro, "osd_values": _osd_values(values)}


def test_command_via_peon_forwarded_to_leader(monkeypatch):
    out = run_on_both(_via_peon, monkeypatch)
    assert_equal_across(out)


async def _failover(pkg: Pkg):
    mons = await start_mons(pkg, ["a", "b", "c"])
    leader = await wait_quorum(mons, size=3)
    await wait_epoch(mons, 1)
    await leader.shutdown()
    rest = [m for m in mons if m is not leader]
    new_leader = await wait_quorum(rest, timeout=15.0 * SLACK)
    assert new_leader.name == "b"
    client = pkg.MonClient("client.2",
                           {m.name: m.monmap[m.name] for m in rest},
                           fast_conf(pkg))
    await client.start()
    r = await client.command("osd pool create", pool="after",
                             timeout=15 * SLACK)
    assert r["rc"] == 0, r
    pools = [p.name for p in new_leader.osd_monitor.osdmap.pools.values()]
    values = committed(new_leader)
    await client.shutdown()
    for m in rest:
        await m.shutdown()
    return {"r": r, "pools": pools, "osd_values": _osd_values(values)}


def test_leader_failover_and_continued_service(monkeypatch):
    out = run_on_both(_failover, monkeypatch)
    assert_equal_across(out)


async def _rejoin(pkg: Pkg):
    mons = await start_mons(pkg, ["a", "b", "c"])
    await wait_quorum(mons, size=3)
    await wait_epoch(mons, 1)
    await mons[2].shutdown()
    client = pkg.MonClient("client.3", mons[0].monmap, fast_conf(pkg))
    await client.start()
    rs = []
    for i in range(3):
        r = await client.command("osd pool create", pool=f"p{i}",
                                 timeout=15 * SLACK)
        assert r["rc"] == 0
        rs.append(r)
    fresh = pkg.Monitor("c", mons[0].monmap, fast_conf(pkg))
    await fresh.start()
    live = [mons[0], mons[1], fresh]
    await wait_quorum(live, timeout=15.0 * SLACK, size=3)
    await wait_epoch([fresh], mons[0].osd_monitor.osdmap.epoch)
    lc = mons[0].paxos.last_committed
    await wait_committed(live, lc)
    assert len(fresh.osd_monitor.osdmap.pools) == 3
    # the rejoined mon holds every version the leader holds, byte for byte
    lead = assert_same_values([mons[0], fresh], lc)
    await client.shutdown()
    for m in live:
        await m.shutdown()
    return {"rs": rs, "map": fresh.osd_monitor.full_map_dict(),
            "osd_values": _osd_values(lead)}


def test_rejoining_mon_catches_up(monkeypatch):
    out = run_on_both(_rejoin, monkeypatch)
    assert_equal_across(out)


# ---------------------------------------------------------------------------
# subscriptions, auth, failure reports, signing

async def _subscription(pkg: Pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    conf = fast_conf(pkg)
    client = pkg.MonClient("client.5", mon.monmap, conf)
    await client.start()
    client.sub_want("osdmap")
    client.sub_want("config")
    client.renew_subs()
    m = await client.wait_for_map(1)
    assert m.epoch >= 1
    r = await client.command("config set", name="osd_recovery_max_active",
                             value="3")
    assert r["rc"] == 0, r
    await wait_for(lambda: conf["osd_recovery_max_active"] == 3)
    cur = client.osdmap.epoch
    r2 = await client.command("osd pool create", pool="subs")
    m = await client.wait_for_map(cur + 1)
    assert any(p.name == "subs" for p in m.pools.values())
    got = m.to_dict()
    values = committed(mon)
    await client.shutdown()
    await mon.shutdown()
    return {"r": r, "r2": r2, "map": got, "values": values}


def test_client_subscription_and_config_push(monkeypatch):
    out = run_on_both(_subscription, monkeypatch)
    assert_equal_across(out)


async def _auth_shared_key(pkg: Pkg):
    (mon,) = await start_mons(
        pkg, ["a"], conf=lambda: fast_conf(pkg, auth_shared_key="sekret"))
    await wait_quorum([mon])
    good = pkg.MonClient("client.6", mon.monmap,
                         fast_conf(pkg, auth_shared_key="sekret"))
    await good.start()
    r = await good.command("status")
    assert r["rc"] == 0
    await good.shutdown()
    bad = pkg.MonClient("client.7", mon.monmap,
                        fast_conf(pkg, auth_shared_key="wrong"))
    with pytest.raises((ConnectionError, TimeoutError, OSError)) as exc:
        await bad.start(timeout=1.0)
    await bad.shutdown()
    values = committed(mon)
    await mon.shutdown()
    return {"rc": r["rc"], "bad": type(exc.value).__name__,
            "values": values}


@requires_cryptography
def test_auth_shared_key(monkeypatch):
    out = run_on_both(_auth_shared_key, monkeypatch)
    assert_equal_across(out)


async def _boot_and_failure(pkg: Pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    osd_clients = []
    for i in range(3):
        mc = pkg.MonClient(f"osd.{i}", mon.monmap, fast_conf(pkg))
        await mc.start()
        mc.sub_want("osdmap")
        mc.renew_subs()
        await mc.send_boot(i, f"local://osd.{i}", host=f"h{i}")
        osd_clients.append(mc)
    m = mon.osd_monitor.osdmap
    assert all(m.is_up(i) for i in range(3))
    buckets = sorted(b.name for b in m.crush.buckets.values())
    assert set(buckets) >= {"default", "h0", "h1", "h2"}
    osd_clients[0].report_failure(2, failed_for=10.0)
    await mon.osd_monitor.wait_map(lambda m: not m.is_up(2),
                                   timeout=5 * SLACK)
    m = await osd_clients[0].wait_for_map(mon.osd_monitor.osdmap.epoch)
    assert not m.is_up(2)
    got = m.to_dict()
    values = committed(mon)
    for mc in osd_clients:
        await mc.shutdown()
    await mon.shutdown()
    return {"buckets": buckets, "map": got,
            "osd_values": _osd_values(values)}


def test_osd_boot_and_failure_reports(monkeypatch):
    out = run_on_both(_boot_and_failure, monkeypatch)
    assert_equal_across(out)


async def _forged_mon_message(pkg: Pkg):
    (mon,) = await start_mons(
        pkg, ["a"], conf=lambda: fast_conf(pkg, auth_shared_key="k3y"))
    await wait_quorum([mon])
    lc_before = mon.paxos.last_committed
    evil = pkg.msg.Messenger("mon.a")

    class D:
        async def ms_dispatch(self, conn, msg):
            pass

        def ms_handle_reset(self, conn):
            pass

        def ms_handle_connect(self, conn):
            pass

    evil.set_dispatcher(D())
    await evil.bind("local://evil")
    tx = pkg.StoreTransaction().put("config", "injected", b"1")
    await evil.send_to(mon.monmap["a"], pkg.msg.Message("paxos_commit", {
        "from": "a", "v": lc_before + 1, "value": tx.encode(),
    }), "mon.a")
    # a signed command after the forgery: once it commits, the forged
    # commit (sent first, on its own connection) has been dispatched
    client = pkg.MonClient("client.1", mon.monmap,
                           fast_conf(pkg, auth_shared_key="k3y"))
    await client.start()
    await asyncio.sleep(0.3)
    r = await client.command("osd pool create", pool="after")
    assert mon.store.get("config", "injected") is None
    assert mon.paxos.last_committed == lc_before + 1
    values = committed(mon)
    await client.shutdown()
    await evil.shutdown()
    await mon.shutdown()
    return {"r": r, "values": values}


def test_mon_internal_messages_require_signature(monkeypatch):
    out = run_on_both(_forged_mon_message, monkeypatch)
    assert_equal_across(out)


async def _signed_cluster(pkg: Pkg):
    key = lambda: fast_conf(pkg, auth_shared_key="k3y")  # noqa: E731
    mons = await start_mons(pkg, ["a", "b", "c"], conf=key)
    leader = await wait_quorum(mons, size=3)
    client = pkg.MonClient("client.1", mons[0].monmap, key())
    await client.start()
    r = await client.command("osd pool create", pool="signed")
    assert r["rc"] == 0, r
    await wait_epoch(mons, leader.osd_monitor.osdmap.epoch)
    for m in mons:
        assert any(p.name == "signed"
                   for p in m.osd_monitor.osdmap.pools.values())
    values = committed(leader)
    await client.shutdown()
    for m in mons:
        await m.shutdown()
    return {"r": r, "osd_values": _osd_values(values)}


def test_signed_mon_cluster_still_works(monkeypatch):
    out = run_on_both(_signed_cluster, monkeypatch)
    assert_equal_across(out)


async def _pool_ids(pkg: Pkg):
    (mon,) = await start_mons(pkg, ["a"])
    await wait_quorum([mon])
    client = pkg.MonClient("client.1", mon.monmap, fast_conf(pkg))
    await client.start()
    r1 = await client.command("osd pool create", pool="p1")
    r2 = await client.command("osd pool create", pool="p2")
    r = await client.command("osd pool delete", pool="p2")
    assert r["rc"] == 0
    r3 = await client.command("osd pool create", pool="p3")
    assert r3["data"]["pool_id"] > r2["data"]["pool_id"], (r1, r2, r3)
    values = committed(mon)
    await client.shutdown()
    await mon.shutdown()
    return {"rs": [r1, r2, r, r3], "values": values}


def test_pool_ids_never_reused(monkeypatch):
    out = run_on_both(_pool_ids, monkeypatch)
    assert_equal_across(out)


@pytest.mark.parametrize("root", PKG_NAMES)
def test_wait_quorum_timeout_names_each_electors_state(root):
    """One mon of a three-mon map can win no election: ``wait_quorum``
    gives up with that mon's elector state, epoch, leader, quorum and
    paxos readiness in its message, and a formed quorum reads as a
    leader's."""
    pkg = PKGS[root]

    async def run():
        pkg.reset()
        monmap = {n: f"local://mon.{n}" for n in "abc"}
        mon = pkg.Monitor("a", monmap, fast_conf(pkg))
        await mon.start()
        try:
            with pytest.raises(TimeoutError) as e:
                await wait_quorum([mon], timeout=1.0)
            msg = str(e.value)
            assert msg.startswith("no quorum: a: state=electing epoch=")
            assert "leader=None electing=True quorum=[] " \
                   "paxos.ready=False" in msg, msg
        finally:
            await mon.shutdown()
        solo = pkg.Monitor("s", {"s": "local://mon.s"}, fast_conf(pkg))
        await solo.start()
        try:
            await wait_quorum([solo])
            state = elector_state(solo)
        finally:
            await solo.shutdown()
            pkg.reset()
        assert state.startswith("s: state=leader epoch=") and \
            "leader=s electing=False quorum=['s'] paxos.ready=True" in \
            state, state

    asyncio.run(run())
