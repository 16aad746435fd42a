"""The port's OSD host helpers against the JAX package's, on the CPU.

The pure functions of tests/test_pg_split.py (``object_to_ps``,
``split_parent``), the mClock scheduler and op-tracker cases of
test_qos.py, the hit set and the snapshot set built directly (their
reference tests need a dev cluster), the PG's peering arithmetic and the
op codes: each runs once per package and the packages' results are held
equal.  The scheduler runs on one injected clock that only the test moves,
so the dequeue order and the dmClock tags are exact (no wall time, no
rates).  Tolerance 0.
"""

import asyncio
import importlib

import numpy as np
import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


class Pkg:
    """One package's OSD host surface."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.pg = mod("osd.pg")
        self.pg_log = mod("osd.pg_log")
        self.osd_map = mod("osd.osd_map")
        self.sched = mod("osd.scheduler")
        self.op_tracker = mod("osd.op_tracker")
        self.snaps = mod("osd.snaps")
        self.hitset = mod("osd.hitset")
        self.codes = mod("osd.codes")
        self.events = mod("common.events")


PKGS = {name: Pkg(name) for name in PKG_NAMES}
REF = PKGS["ceph_tpu"]


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


def _names(seed, n):
    rng = np.random.default_rng(seed)
    return [f"rbd_data.{int(v):x}.{i}" for i, v in
            enumerate(rng.integers(0, 2**48, n))]


# -- tests/test_pg_split.py ---------------------------------------------------

def test_stable_mod_split_invariant(pkg):
    for old_n in (1, 2, 3, 4, 6, 8, 11):
        for new_n in (old_n, old_n + 1, 2 * old_n, 2 * old_n + 5):
            for i in range(300):
                a = pkg.pg.object_to_ps(f"o-{i}", old_n)
                b = pkg.pg.object_to_ps(f"o-{i}", new_n)
                assert pkg.pg.split_parent(b, old_n) == a


@pytest.mark.parametrize("pg_num", [1, 7, 8, 12, 64, 100, 512, 1000])
def test_object_to_ps_equals_reference(pkg, pg_num):
    names = _names(pg_num, 2000)
    got = [pkg.pg.object_to_ps(nm, pg_num) for nm in names]
    assert got == [REF.pg.object_to_ps(nm, pg_num) for nm in names]
    assert all(0 <= ps < pg_num for ps in got)
    assert [pkg.pg.split_parent(ps, max(1, pg_num // 3)) for ps in got] == \
        [REF.pg.split_parent(ps, max(1, pg_num // 3)) for ps in got]
    for x in range(0, 1 << 12, 7):
        mask = pkg.pg.pg_num_mask(pg_num)
        assert mask == REF.pg.pg_num_mask(pg_num)
        assert pkg.pg.ceph_stable_mod(x, pg_num, mask) == \
            REF.pg.ceph_stable_mod(x, pg_num, mask)


def test_pgid_and_placement_seed_equal_reference(pkg):
    assert str(pkg.pg.PGId(3, 0x2A)) == str(REF.pg.PGId(3, 0x2A)) == "3.2a"
    for pool_id, pg_num, pgp in ((1, 512, 0), (7, 100, 64), (2, 12, 12)):
        ours = pkg.osd_map.PoolInfo(pool_id, "p", pg_num=pg_num,
                                    pgp_num=pgp)
        ref = REF.osd_map.PoolInfo(pool_id, "p", pg_num=pg_num, pgp_num=pgp)
        assert [ours.raw_pg_to_pps(ps) for ps in range(pg_num)] == \
            [ref.raw_pg_to_pps(ps) for ps in range(pg_num)]


# -- the PG's peering arithmetic (osd/pg.py compute_missing) ------------------

def _peering(pkg, seed, ec_k):
    """A primary PG with seeded peer logs (divergent branches, trimmed
    tails, a brand-new member, a permuted EC position) and its missing
    set, as plain data."""
    rng = np.random.default_rng(seed)
    LogEntry = pkg.pg_log.LogEntry
    size = 6 if ec_k else 3
    pool = pkg.osd_map.PoolInfo(1, "p", "erasure" if ec_k else "replicated",
                                size=size, pg_num=8)
    pg = pkg.pg.PG(pkg.pg.PGId(1, 3), pool, whoami=0)
    pg.ec_k = ec_k
    pg.start_interval(5, list(range(size)), list(range(size)), 0)
    names = [nm for nm in _names(seed, 200)
             if pkg.pg.object_to_ps(nm, 8) == 3][:12]
    auth = {}
    for seq in range(1, 41):
        nm = names[int(rng.integers(0, len(names)))]
        op = "delete" if rng.random() < 0.1 else "modify"
        auth[seq] = LogEntry(seq, 4 + seq // 20, nm, op, seq, seq - 1,
                             f"client.1:{seq}")
    for shard in range(1, size):
        kind = shard % 4
        if kind == 3 and shard == size - 1:
            info = pkg.pg.PeerInfo(shard, shard)           # brand new
        else:
            cut = int(rng.integers(25, 41))
            tail = int(rng.integers(0, 10)) if kind != 2 else 0
            log = {s: e for s, e in auth.items() if tail < s <= cut}
            if kind == 1:                                 # divergent branch
                for s in range(cut + 1, cut + 3):
                    log[s] = LogEntry(s, 3, names[s % len(names)],
                                      "modify", 900 + s, s - 1)
            info = pkg.pg.PeerInfo(shard, shard, log=log, tail=tail)
            if ec_k and shard == 2:
                info.held = [0, 1]                        # permuted
        pg.record_info(info)
    pg.record_info(pkg.pg.PeerInfo(0, 0, log=dict(auth), tail=0))
    ms = pg.compute_missing()
    return {
        "by_shard": {s: {o: e.to_wire() for o, e in need.items()}
                     for s, need in ms.by_shard.items()},
        "sources": {o: sorted(v) for o, v in ms.sources.items()},
        "backfill": sorted(ms.backfill),
        "auth_log": {s: e.to_wire() for s, e in ms.auth_log.items()},
        "auth_tail": ms.auth_tail, "total": ms.total(),
        "peers": pg.query_peers(), "all_in": pg.all_infos_in(),
        "auth_shard": pg.authoritative_log()[0],
    }


@pytest.mark.parametrize("seed,ec_k", [(1, 0), (2, 0), (3, 4), (4, 4)])
def test_pg_compute_missing_equals_reference(pkg, seed, ec_k):
    ours = _peering(pkg, seed, ec_k)
    assert ours == _peering(REF, seed, ec_k)
    assert ours["all_in"] and ours["total"] > 0


def test_pg_reqid_index_and_entries_equal_reference(pkg):
    def run(p):
        pool = p.osd_map.PoolInfo(1, "p", pg_num=8)
        pg = p.pg.PG(p.pg.PGId(1, 0), pool, whoami=2)
        pg.start_interval(9, [2, 0, 1], [2, 0, 1], 2)
        entries = [pg.next_entry(9, f"o{i % 5}", "modify", i + 1, i,
                                 reqid=f"client.4:{i}").to_wire()
                   for i in range(30)]
        for i, e in enumerate(entries[:20]):
            pg.register_reqid(e["r"], e["s"], e["v"])
        return (entries, dict(pg.reqid_index), dict(pg.attempted_reqids),
                pg.is_primary, pg.state, pg.acting_shard_of(1),
                pg.shard_osd(-105), pg.stray_shard(7))
    assert run(pkg) == run(REF)


# -- mClock on an injected clock (tests/test_qos.py) --------------------------

class FakeClock:
    """A clock only the test moves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


async def _drive(sched, clock, dt, steps, until=None):
    """Advance the clock ``steps`` times by ``dt``, waking the dispatch
    loop and letting every due grant run after each step."""
    for _ in range(steps):
        clock.t = round(clock.t + dt, 9)
        sched._wake.set()
        for _ in range(64):
            await asyncio.sleep(0)
        if until is not None and until():
            return


def _tags(sched):
    """Each class's last stamped (r, l, p) tags and its queued heads."""
    return ({c: list(v) for c, v in sorted(sched._prev.items())},
            {c: [(r.r_tag, r.l_tag, r.p_tag, r.cost) for r in q]
             for c, q in sorted(sched._queues.items())})


def _run_sched(pkg, profiles, ops, dt, steps, until=None, retune=None):
    """Queue ``ops`` ((class, cost) in order) on a scheduler over a fake
    clock at t = 0, then drive it; return the dispatch order, the tags
    and the stats."""
    async def run():
        clock = FakeClock()
        sched = pkg.sched.MClockScheduler(
            {c: pkg.sched.ClassProfile(*p) for c, p in profiles.items()},
            clock=clock)
        if retune:
            sched.set_profile(*retune[0], **retune[1])
        order = []

        async def op(i, clazz, cost):
            await sched.acquire(clazz, cost=cost)
            order.append((i, clazz))

        tasks = []
        for i, (clazz, cost) in enumerate(ops):
            tasks.append(asyncio.ensure_future(op(i, clazz, cost)))
            if i % 50 == 49:
                await asyncio.sleep(0)
        await asyncio.sleep(0)
        tags_queued = _tags(sched)
        await _drive(sched, clock, dt, steps,
                     None if until is None else lambda: until(order))
        out = {"order": order, "queued": tags_queued, "left": _tags(sched),
               "stats": sched.stats(), "depths": sched.queue_depths(),
               "t": clock.t}
        sched.shutdown()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return out
    return asyncio.run(run())


def test_limit_caps_class_rate(pkg):
    """Limit 50/s: over 0.5 s of the clock exactly the ops whose limit
    tag (0.02, 0.04, ... as stamped) is due are dispatched, in order."""
    args = ({"bg": (0.0, 1.0, 50.0)}, [("bg", 1)] * 100, 0.01, 50)
    ours = _run_sched(pkg, *args)
    assert ours == _run_sched(REF, *args)
    due = sum(l_tag <= ours["t"] for _, l_tag, _, _ in ours["queued"][1]["bg"])
    assert due in (24, 25) and len(ours["order"]) == due
    assert [i for i, _ in ours["order"]] == list(range(due))


def test_reservation_protects_client_from_recovery_storm(pkg):
    """A queued recovery storm cannot starve client ops: the 40 client
    ops finish on their reservation clock (one per 5 ms) long before the
    storm drains, in the same interleaving in both packages."""
    profiles = {"client": (200.0, 10.0, 0.0),
                "recovery": (10.0, 1.0, 100.0)}
    ops = [("recovery", 1)] * 2000 + [("client", 1)] * 40
    args = (profiles, ops, 0.001, 400)
    until = lambda order: sum(c == "client" for _, c in order) == 40  # noqa
    ours = _run_sched(pkg, *args, until=until)
    assert ours == _run_sched(REF, *args, until=until)
    clients = [i for i, (_, c) in enumerate(ours["order"]) if c == "client"]
    assert len(clients) == 40
    assert sum(c == "recovery" for _, c in ours["order"]) < 1000
    assert ours["t"] <= 0.21


def test_weight_orders_spare_capacity(pkg):
    """No reservations and no limits: grants follow the proportional
    tags alone, 3:1 by weight in every prefix."""
    profiles = {"a": (0.0, 300.0, 0.0), "b": (0.0, 100.0, 0.0)}
    ops = [("a", 1)] * 400 + [("b", 1)] * 400
    ours = _run_sched(pkg, profiles, ops, 0.0, 40)
    assert ours == _run_sched(REF, profiles, ops, 0.0, 40)
    assert len(ours["order"]) == 800
    prefix = [c for _, c in ours["order"][:200]]
    assert prefix.count("a") / max(prefix.count("b"), 1) > 1.8


def test_cost_charges_batched_requests(pkg):
    """A batch of cost n advances its class's clocks as n ops would."""
    profiles = {"recovery": (10.0, 1.0, 20.0), "client": (0.0, 5.0, 0.0)}
    ops = [("recovery", 8), ("client", 1), ("recovery", 1),
           ("recovery", 4), ("client", 1)]
    ours = _run_sched(pkg, profiles, ops, 0.05, 30)
    assert ours == _run_sched(REF, profiles, ops, 0.05, 30)
    assert ours["stats"]["recovery"] == 13


def test_mclock_set_profile_runtime_and_journal(pkg):
    jr = pkg.events.EventJournal("osd.t")
    sched = pkg.sched.MClockScheduler({
        "recovery": pkg.sched.ClassProfile(10.0, 1.0, 0.0)}, journal=jr)
    change = sched.set_profile("recovery", reservation=4.0, limit=8.0)
    assert change["limit"] == 8.0 and change["reservation"] == 4.0
    assert change["prev"]["limit"] == 0.0
    assert sched.profiles["recovery"].weight == 1.0
    events = [e for e in jr.snapshot() if e["type"] == "mclock.retune"]
    assert len(events) == 1 and events[0]["fields"]["limit"] == 8.0
    assert sched.set_profile("recovery", reservation=4.0, limit=8.0) is None
    assert sched.retunes == 1
    assert sched.set_profile("nope", limit=5.0) is None
    assert sched.profiles_dump() == {
        "recovery": {"reservation": 4.0, "weight": 1.0, "limit": 8.0}}
    # the new limit paces dispatch: 0.5 s of the clock, limit tags 0.125,
    # 0.25, 0.375, 0.5 are due
    args = ({"recovery": (10.0, 1.0, 0.0)}, [("recovery", 1)] * 40, 0.01, 50)
    retune = (("recovery",), {"reservation": 4.0, "limit": 8.0})
    ours = _run_sched(pkg, *args, retune=retune)
    assert ours == _run_sched(REF, *args, retune=retune)
    assert len(ours["order"]) == 4


def test_default_profiles_and_unknown_class(pkg):
    assert {c: vars(p) for c, p in pkg.sched.DEFAULT_PROFILES.items()} == \
        {c: vars(p) for c, p in REF.sched.DEFAULT_PROFILES.items()}

    async def run():
        sched = pkg.sched.MClockScheduler(clock=FakeClock())
        await asyncio.wait_for(sched.acquire("unknown"), 1.0)
        sched.shutdown()
        await asyncio.wait_for(sched.acquire("client"), 1.0)
        return sched.stats()
    assert asyncio.run(run()) == {}


# -- the op tracker (tests/test_qos.py) ---------------------------------------

def _tracker_run(pkg):
    tracker = pkg.op_tracker.OpTracker(history_size=4, slow_op_seconds=0.0)
    op = tracker.create("osd_op(client.1:5 obj write)")
    op.mark("dispatched")
    live = tracker.dump_ops_in_flight()
    assert live["num_ops"] == 1
    assert live["ops"][0]["description"].startswith("osd_op")
    assert [e["event"] for e in live["ops"][0]["events"]] == [
        "received", "dispatched"]
    tracker.finish(op, "replied")
    assert tracker.dump_ops_in_flight()["num_ops"] == 0
    hist = tracker.dump_historic_ops()
    assert hist["num_ops"] == 1 and hist["slow_ops"] == 1
    for i in range(10):
        tracker.finish(tracker.create(f"op{i}"))
    hist = tracker.dump_historic_ops()
    assert hist["num_ops"] == 4
    # everything but the clock readings
    return {"live": {**live, "ops": [
                {k: v for k, v in o.items() if k not in ("age", "duration")}
                | {"events": [e["event"] for e in o["events"]]}
                for o in live["ops"]]},
            "history": [(o["id"], o["description"],
                         [e["event"] for e in o["events"]])
                        for o in hist["ops"]],
            "slow_ops": hist["slow_ops"]}


def test_op_tracker_lifecycle_and_dumps(pkg):
    assert _tracker_run(pkg) == _tracker_run(REF)


# -- the hit set and the snapshot set ------------------------------------------

@pytest.mark.parametrize("target,fpp,seed", [(1024, 0.01, 0), (64, 0.05, 7),
                                             (5000, 0.001, 123)])
def test_bloom_hitset_bits_equal_reference(pkg, target, fpp, seed):
    names = _names(seed + 1, target)
    ours = pkg.hitset.BloomHitSet(target_size=target, fpp=fpp, seed=seed)
    ref = REF.hitset.BloomHitSet(target_size=target, fpp=fpp, seed=seed)
    for nm in names:
        ours.insert(nm)
        ref.insert(nm)
    assert (ours.nbits, ours.k, ours.count) == (ref.nbits, ref.k, ref.count)
    assert bytes(ours.bits) == bytes(ref.bits)
    assert all(ours.contains(nm) for nm in names)
    probes = _names(seed + 2, 2000)
    hits = [ours.contains(nm) for nm in probes]
    assert hits == [ref.contains(nm) for nm in probes]
    assert sum(hits) / len(probes) < max(4 * fpp, 0.02)
    for src, dst in ((ours, REF), (ref, pkg)):
        loaded = dst.hitset.BloomHitSet.from_dict(src.to_dict())
        assert loaded.to_dict() == src.to_dict()
        assert all(loaded.contains(nm) for nm in names[:200])


def _snapset_run(pkg):
    S = pkg.snaps
    ss = S.SnapSet(seq=3, clones=[2, 5, 9],
                   clone_snaps={2: [1, 2], 5: [4, 5], 9: [7, 8, 9]})
    reads = [ss.resolve_read(s) for s in range(0, 13)]
    raw = ss.to_attr()
    back = S.SnapSet.from_attr(raw)
    pruned = [back.prune_snap(s) for s in (5, 4, 8, 1)]
    whiteout = S.SnapSet(seq=10, clones=[9], clone_snaps={9: [9]},
                         head_exists=False)
    return {"reads": reads, "raw": raw, "pruned": pruned,
            "after": back.to_attr(),
            "reads_after": [back.resolve_read(s) for s in range(0, 13)],
            "whiteout": [whiteout.resolve_read(s) for s in (9, 10, 11)],
            "clone_oid": str(S.clone_oid(1, "obj", 5)),
            "mapper": (str(S.mapper_oid(1)), str(S.mapper_cid(1, 3)),
                       S.mapper_key(7, "obj"), S.mapper_prefix(7)),
            "consts": (S.SS_ATTR, S.NOSNAP, S.MAPPER_NAME)}


def test_snapset_equals_reference(pkg):
    ours = _snapset_run(pkg)
    assert ours == _snapset_run(REF)
    assert ours["reads"][0] is None and ours["reads"][4] == 5
    assert ours["reads"][12] == pkg.snaps.NOSNAP
    assert pkg.snaps.SnapSet.from_attr(_snapset_run(REF)["raw"]).to_attr() \
        == ours["raw"]


def test_op_codes_equal_reference(pkg):
    names = [n for n in dir(REF.codes) if n.isupper()]
    assert names == [n for n in dir(pkg.codes) if n.isupper()]
    assert all(getattr(pkg.codes, n) == getattr(REF.codes, n) for n in names)
