"""The port's OSD map against the JAX package's, on the CPU.

Every scenario of tests/test_osd_map.py and test_osdmap_mapping.py runs
once per package, each with its own modules, and the packages' results
are held equal.  Then chip_smoke.py's wave (d) deployment, the Ceph docs'
8+4 EC pool (12 hosts of 4 OSDs, 512 PGs): the up/acting tables before and
after one OSD is marked out, their diff and ``plan_motion``'s groups, and
the ``OSDMap``/``Incremental``/``CrushMap`` dicts loaded in both
directions, all exactly equal.  Last, a CPU rehearsal of wave (d): 8
objects of 64 KiB in the moved PG, its changed shard positions drained by
``BackfillEngine.drain_pg`` on each package's ECBackend over WalStores,
with the same moved PGs and the same rebuilt bytes and hinfo.  Tolerance 0.
"""

import asyncio
import copy
import functools
import importlib
import importlib.util
import pathlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


class Pkg:
    """One package's OSD map surface, and the OSD stack wave (d) drives."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.om = mod("osd.osd_map")
        self.cm = mod("placement.crush_map")
        self.mapping = mod("placement.mapping")
        self.backfill = mod("osd.backfill")
        self.pg = mod("osd.pg")
        store, eb = mod("store"), mod("osd.ec_backend")
        self.osd = SimpleNamespace(
            WalStore=store.WalStore, MemStore=store.MemStore,
            Transaction=store.Transaction, CollectionId=store.CollectionId,
            GHObject=store.GHObject, LocalShard=eb.LocalShard,
            ECBackend=eb.ECBackend,
            BackfillEngine=self.backfill.BackfillEngine,
            RepairScheduler=mod("osd.repair").RepairScheduler,
            pg_log=mod("osd.pg_log"), HINFO_ATTR=eb.HINFO_ATTR)
        self.registry = mod("ec.registry").ErasureCodePluginRegistry()
        self.codec_kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}


PKGS = {name: Pkg(name) for name in PKG_NAMES}
REF = PKGS["ceph_tpu"]


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


def _tables(t):
    """A PoolTables as plain lists, for exact comparison."""
    return {k: np.asarray(getattr(t, k)).tolist() for k in (
        "up", "up_len", "up_primary", "acting", "acting_len",
        "acting_primary")} | {"pool_id": t.pool_id, "pg_num": t.pg_num}


# -- tests/test_osd_map.py ----------------------------------------------------

def _map(pkg, n_hosts=4, osds_per=3):
    crush = pkg.cm.CrushMap()
    root = crush.add_bucket("default", "root")
    osd = 0
    for h in range(n_hosts):
        host = crush.add_bucket(f"host{h}", "host")
        for _ in range(osds_per):
            crush.add_item(host, osd, 1.0)
            osd += 1
        crush.add_item(root, host)
    crush.create_replicated_rule("replicated_rule", failure_domain="host")
    crush.create_ec_rule("ec_rule", chunk_count=6, failure_domain="osd")
    m = pkg.om.OSDMap(crush)
    inc = pkg.om.Incremental(1)
    for i in range(osd):
        inc.new_up[i] = f"osd.{i}:680{i}"
    inc.new_pools.append(pkg.om.PoolInfo(1, "rbd", "replicated", size=3,
                                         pg_num=16))
    inc.new_pools.append(pkg.om.PoolInfo(2, "ecpool", "erasure", size=6,
                                         pg_num=16, crush_rule="ec_rule"))
    m.apply_incremental(inc)
    return m, osd


def test_epoch_sequencing(pkg):
    m, _ = _map(pkg)
    assert m.epoch == 1
    with pytest.raises(ValueError):
        m.apply_incremental(pkg.om.Incremental(5))
    m.apply_incremental(pkg.om.Incremental(2))
    assert m.epoch == 2


def test_pg_mapping_replicated(pkg):
    m, n = _map(pkg)
    ref, _ = _map(REF)
    for ps in range(16):
        up, upp, acting, actp = m.pg_to_up_acting(1, ps)
        assert len(up) == 3 and len(set(up)) == 3
        assert upp == up[0] and actp == acting[0]
        assert all(0 <= o < n for o in up)
        assert (up, upp, acting, actp) == ref.pg_to_up_acting(1, ps)


def test_pg_mapping_ec_holes_positional(pkg):
    m, _ = _map(pkg)
    up, _, _, _ = m.pg_to_up_acting(2, 5)
    assert len(up) == 6
    victim = up[2]
    m.apply_incremental(pkg.om.Incremental(2, new_down=[victim]))
    up2, _, _, _ = m.pg_to_up_acting(2, 5)
    assert up2[2] == pkg.om.NO_OSD or up2[2] != victim
    assert sum(a == b for a, b in zip(up, up2)) >= 4
    ref, _ = _map(REF)
    ref.apply_incremental(REF.om.Incremental(2, new_down=[victim]))
    assert up2 == ref.pg_to_up_acting(2, 5)[0]


def test_down_osd_filtered_replicated(pkg):
    m, _ = _map(pkg)
    victim = m.pg_to_up_acting(1, 3)[0][0]
    m.apply_incremental(pkg.om.Incremental(2, new_down=[victim]))
    assert victim not in m.pg_to_up_acting(1, 3)[0]


def test_out_osd_remapped(pkg):
    m, _ = _map(pkg)
    victim = m.pg_to_up_acting(1, 7)[0][1]
    m.apply_incremental(pkg.om.Incremental(2, new_weights={victim: 0}))
    up2 = m.pg_to_up_acting(1, 7)[0]
    assert victim not in up2 and len(up2) == 3


def test_pg_temp_override(pkg):
    m, _ = _map(pkg)
    up = m.pg_to_up_acting(1, 0)[0]
    temp = [up[1], up[2], up[0]]
    m.apply_incremental(pkg.om.Incremental(2, new_pg_temp={(1, 0): temp}))
    _, _, acting2, actp2 = m.pg_to_up_acting(1, 0)
    assert acting2 == temp and actp2 == temp[0]
    m.apply_incremental(pkg.om.Incremental(3, new_pg_temp={(1, 0): []}))
    assert m.pg_to_up_acting(1, 0)[2] == list(up)


def test_primary_temp(pkg):
    m, _ = _map(pkg)
    up = m.pg_to_up_acting(1, 2)[0]
    m.apply_incremental(pkg.om.Incremental(
        2, new_primary_temp={(1, 2): up[2]}))
    assert m.pg_to_up_acting(1, 2)[3] == up[2]


def test_to_dict_roundtrippable(pkg):
    m, _ = _map(pkg)
    d = m.to_dict()
    assert d["epoch"] == 1
    assert d["pools"]["2"]["type"] == "erasure"
    assert len(d["osds"]) == 12
    assert d == _map(REF)[0].to_dict()


# -- tests/test_osdmap_mapping.py ---------------------------------------------

def _scalar_up_acting(pkg, m, pool_id, ps):
    up = m.raw_row_to_up(pool_id, ps, m._pg_to_raw_osds_scalar(pool_id, ps))
    acting = list(m.pg_temp.get((pool_id, ps), up)) or up
    primary = m.primary_temp.get((pool_id, ps))
    up_primary = next((o for o in up if o != pkg.om.NO_OSD), pkg.om.NO_OSD)
    acting_primary = (
        primary if primary is not None
        else next((o for o in acting if o != pkg.om.NO_OSD), pkg.om.NO_OSD))
    return up, up_primary, acting, acting_primary


def _random_map(pkg, rng, n_hosts=None, osds_per=None):
    n_hosts = n_hosts or rng.randint(3, 8)
    osds_per = osds_per or rng.randint(1, 4)
    crush = pkg.cm.CrushMap()
    root = crush.add_bucket("default", "root")
    osd = 0
    for h in range(n_hosts):
        host = crush.add_bucket(f"host{h}", "host")
        for _ in range(osds_per):
            crush.add_item(host, osd, rng.choice([0.5, 1.0, 1.0, 2.0]))
            osd += 1
        crush.add_item(root, host)
    crush.create_replicated_rule("replicated_rule", failure_domain="host")
    crush.create_ec_rule("ec_rule", chunk_count=min(6, osd),
                         failure_domain="osd")
    m = pkg.om.OSDMap(crush)
    inc = pkg.om.Incremental(1)
    for i in range(osd):
        inc.new_up[i] = f"osd.{i}:1{i:04d}"
    inc.new_pools.append(pkg.om.PoolInfo(
        1, "repl", "replicated", size=min(3, n_hosts),
        pg_num=rng.choice([8, 16, 32])))
    inc.new_pools.append(pkg.om.PoolInfo(
        2, "ec", "erasure", size=min(6, osd), pg_num=rng.choice([8, 16]),
        crush_rule="ec_rule"))
    m.apply_incremental(inc)
    return m, osd


def _random_overlays(pkg, rng, m, n_osds):
    inc = pkg.om.Incremental(m.epoch + 1)
    up_now = [o for o, info in m.osds.items() if info.up]
    for o in rng.sample(up_now, k=min(len(up_now) - 1, rng.randint(0, 2))):
        inc.new_down.append(o)
    for o in rng.sample(range(n_osds), k=rng.randint(0, 2)):
        inc.new_weights[o] = rng.choice([0, 0x8000, 0x10000])
    for pool_id in (1, 2):
        pg_num = m.pools[pool_id].pg_num
        for _ in range(rng.randint(0, 3)):
            ps = rng.randrange(pg_num)
            frm, to = rng.sample(range(n_osds), 2)
            inc.new_pg_upmap_items[(pool_id, ps)] = [(frm, to)]
        for _ in range(rng.randint(0, 2)):
            ps = rng.randrange(pg_num)
            k = m.pools[pool_id].size
            inc.new_pg_temp[(pool_id, ps)] = rng.sample(range(n_osds),
                                                        min(k, n_osds))
        for _ in range(rng.randint(0, 2)):
            ps = rng.randrange(pg_num)
            inc.new_primary_temp[(pool_id, ps)] = rng.randrange(n_osds)
    return inc


def _assert_map_identical(pkg, m):
    mapping = m.mapping()
    tables = {}
    for pool_id, pool in m.pools.items():
        tab = mapping.up_acting_tables(pool_id)
        for ps in range(pool.pg_num):
            assert mapping.raw_row(pool_id, ps) == \
                m._pg_to_raw_osds_scalar(pool_id, ps)
            want = _scalar_up_acting(pkg, m, pool_id, ps)
            assert m.pg_to_up_acting(pool_id, ps) == want
            assert tab.lookup(ps) == want
        tables[pool_id] = _tables(tab)
    return tables


@functools.lru_cache(maxsize=None)
def _random_epochs(root, seed):
    """The tables of every epoch of test_table_bit_identical_random_maps'
    walk, and the map dicts (once per package)."""
    pkg = PKGS[root]
    rng = random.Random(seed)
    m, n_osds = _random_map(pkg, rng)
    epochs = [(_assert_map_identical(pkg, m), m.to_dict())]
    for _ in range(4):
        inc = _random_overlays(pkg, rng, m, n_osds)
        m.apply_incremental(inc)
        epochs.append((_assert_map_identical(pkg, m), m.to_dict(),
                       inc.to_dict()))
    return epochs


@pytest.mark.parametrize("seed", range(8))
def test_table_bit_identical_random_maps(pkg, seed):
    assert _random_epochs(pkg.root, seed) == _random_epochs(REF.root, seed)


def test_overlay_epochs_reuse_raw_rows(pkg):
    rng = random.Random(99)
    m, _ = _random_map(pkg, rng, n_hosts=4, osds_per=2)
    mapping = m.mapping()
    _assert_map_identical(pkg, m)
    before = mapping.rebuilds
    inc = pkg.om.Incremental(m.epoch + 1)
    inc.new_pg_upmap_items[(1, 0)] = [(0, 5)]
    inc.new_pg_temp[(1, 1)] = [1, 2, 3]
    inc.new_primary_temp[(1, 2)] = 4
    m.apply_incremental(inc)
    _assert_map_identical(pkg, m)
    assert mapping.rebuilds == before
    m.apply_incremental(pkg.om.Incremental(m.epoch + 1,
                                           new_weights={0: 0x8000}))
    _assert_map_identical(pkg, m)
    assert mapping.rebuilds > before


def _scalar_diff_oracle(cur, prev):
    n = min(cur.pg_num, prev.pg_num)
    changed = {ps for ps in range(n) if cur.lookup(ps) != prev.lookup(ps)}
    changed.update(range(n, cur.pg_num))
    return changed


@functools.lru_cache(maxsize=None)
def _random_diffs(root, seed):
    pkg = PKGS[root]
    rng = random.Random(seed)
    m, n_osds = _random_map(pkg, rng)
    snaps = {pid: m.mapping().up_acting_tables(pid) for pid in m.pools}
    diffs = []
    for _ in range(5):
        m.apply_incremental(_random_overlays(pkg, rng, m, n_osds))
        for pid in m.pools:
            cur = m.mapping().up_acting_tables(pid)
            got = [int(p) for p in cur.diff(snaps[pid])]
            assert set(got) == _scalar_diff_oracle(cur, snaps[pid])
            diffs.append(got)
            snaps[pid] = cur
    return diffs


@pytest.mark.parametrize("seed", range(6))
def test_diff_exact_vs_scalar_oracle(pkg, seed):
    assert _random_diffs(pkg.root, seed) == _random_diffs(REF.root, seed)


def test_diff_exact_on_overlay_only_epoch(pkg):
    rng = random.Random(3)
    m, _ = _random_map(pkg, rng, n_hosts=4, osds_per=2)
    mapping = m.mapping()
    prev = mapping.up_acting_tables(1)
    before = mapping.rebuilds
    inc = pkg.om.Incremental(m.epoch + 1)
    inc.new_pg_upmap_items[(1, 2)] = [(int(prev.up[2, 0]), 7)]
    inc.new_pg_temp[(1, 5)] = [1, 2, 3]
    inc.new_primary_temp[(1, 6)] = 4
    m.apply_incremental(inc)
    cur = m.mapping().up_acting_tables(1)
    assert mapping.rebuilds == before
    got = {int(p) for p in cur.diff(prev)}
    assert got and got == _scalar_diff_oracle(cur, prev)
    inc = pkg.om.Incremental(m.epoch + 1)
    inc.new_pg_upmap_items[(1, 2)] = []
    inc.new_pg_temp[(1, 5)] = []
    inc.new_primary_temp[(1, 6)] = pkg.om.NO_OSD
    m.apply_incremental(inc)
    back = m.mapping().up_acting_tables(1)
    assert {int(p) for p in back.diff(prev)} == \
        _scalar_diff_oracle(back, prev)


def test_diff_reports_every_pg_past_a_split(pkg):
    rng = random.Random(5)
    m, _ = _random_map(pkg, rng, n_hosts=4, osds_per=2)
    prev = m.mapping().up_acting_tables(1)
    grown = copy.deepcopy(m.pools[1])
    grown.pg_num = prev.pg_num * 2
    grown.pgp_num = grown.pg_num
    m.apply_incremental(pkg.om.Incremental(m.epoch + 1, new_pools=[grown]))
    cur = m.mapping().up_acting_tables(1)
    got = {int(p) for p in cur.diff(prev)}
    assert set(range(prev.pg_num, cur.pg_num)) <= got
    assert got == _scalar_diff_oracle(cur, prev)


def test_pgs_of_and_diff_match_lookups(pkg):
    rng = random.Random(7)
    m, n_osds = _random_map(pkg, rng, n_hosts=5, osds_per=2)
    tables = m.mapping().up_acting_tables(1)
    for osd in range(n_osds):
        want = {ps for ps in range(m.pools[1].pg_num)
                if any(osd in s for s in (tables.lookup(ps)[0],
                                          tables.lookup(ps)[2]))}
        assert {int(p) for p in tables.pgs_of(osd)} == want
    victim = next(o for o, info in m.osds.items() if info.up)
    m.apply_incremental(pkg.om.Incremental(m.epoch + 1, new_down=[victim]))
    cur = m.mapping().up_acting_tables(1)
    changed = {int(p) for p in cur.diff(tables)}
    for ps in range(m.pools[1].pg_num):
        if cur.lookup(ps) != tables.lookup(ps):
            assert ps in changed


def test_mapping_takes_both_branches(pkg, monkeypatch):
    """A replicated firstn pool goes through the bulk chooser, the EC
    indep pool through the scalar fallback, and both equal the scalar
    walk and the reference's rows."""
    calls = {"bulk": 0, "scalar": 0}
    bulk = pkg.mapping.map_pgs_bulk

    def counted_bulk(*args, **kwargs):
        calls["bulk"] += 1
        return bulk(*args, **kwargs)

    monkeypatch.setattr(pkg.mapping, "map_pgs_bulk", counted_bulk)
    m, _ = _random_map(pkg, random.Random(1))
    do_rule = m.crush.do_rule

    def counted_do_rule(*args, **kwargs):
        calls["scalar"] += 1
        return do_rule(*args, **kwargs)

    monkeypatch.setattr(m.crush, "do_rule", counted_do_rule)
    rows = {pid: np.asarray(m.mapping().raw_rows(pid)[0]).tolist()
            for pid in (1, 2)}
    assert calls == {"bulk": 1, "scalar": m.pools[2].pg_num}
    ref, _ = _random_map(REF, random.Random(1))
    assert rows == {pid: np.asarray(ref.mapping().raw_rows(pid)[0]).tolist()
                    for pid in (1, 2)}


def test_map_dicts_load_across_packages(pkg):
    """OSDMap and Incremental dicts of a random map walk, each loaded in
    the other package: the same dict back, the same up/acting tables."""
    rng = random.Random(4)
    m, n_osds = _random_map(pkg, rng)
    ref, _ = _random_map(REF, random.Random(4))
    for _ in range(3):
        state = rng.getstate()
        inc = _random_overlays(pkg, rng, m, n_osds)
        rng2 = random.Random()
        rng2.setstate(state)
        ref_inc = _random_overlays(REF, rng2, ref, n_osds)
        assert inc.to_dict() == ref_inc.to_dict()
        for src, dst in ((inc, REF), (ref_inc, pkg)):
            loaded = dst.om.Incremental.from_dict(src.to_dict())
            assert loaded.to_dict() == src.to_dict()
        # each map takes the other package's incremental
        m.apply_incremental(pkg.om.Incremental.from_dict(ref_inc.to_dict()))
        ref.apply_incremental(REF.om.Incremental.from_dict(inc.to_dict()))
        assert m.to_dict() == ref.to_dict()
        for src, dst in ((m, REF), (ref, pkg)):
            loaded = dst.om.OSDMap.from_dict(src.to_dict())
            assert loaded.to_dict() == src.to_dict()
            for pid in src.pools:
                assert _tables(loaded.mapping().up_acting_tables(pid)) == \
                    _tables(src.mapping().up_acting_tables(pid))


# -- the wave (d) deployment: 12 hosts x 4 OSDs, an 8+4 pool of 512 PGs --------

@functools.lru_cache(maxsize=None)
def _deployment(root):
    """chip_smoke's map before and after osd.MAP_OUT_OSD is marked out
    (once per package): the dicts, the tables, the motion."""
    pkg = PKGS[root]
    osdmap = CS.ec_pool_map(pkg.cm, pkg.om)
    first = osdmap.to_dict()
    holes = CS.check_ec_tables(osdmap, osdmap.mapping().up_acting_tables(
        CS.MAP_POOL)) if root == "ceph_tpu_torch" else None
    motion = CS.map_motion(osdmap, pkg.om, pkg.backfill)
    return {"map": osdmap, "first": first, "motion": motion, "holes": holes}


def test_deployment_tables_equal_reference(pkg):
    """The 512 PGs' up/acting tables before and after the out-mark, their
    diff, the PGs that held the OSD, the moved rows and the PGs left
    undersized: equal to the reference's.  Before, every up set is 12
    positions on distinct hosts, at most one PG keeps a hole, and the
    cached rows equal the scalar walk (checked in the port); after, every
    set is on distinct hosts and the holes are the unmoved ones and the
    undersized PGs'."""
    ours, ref = _deployment(pkg.root)["motion"], _deployment(REF.root)[
        "motion"]
    for key in ("before", "after"):
        assert _tables(ours[key]) == _tables(ref[key])
    for key in ("moved", "held", "undersized", "rows", "ps", "positions",
                "epoch"):
        assert ours[key] == ref[key], key
    assert ours["moved"] == ours["held"]        # only its PGs move
    assert CS.MAP_OUT_OSD not in np.asarray(ours["after"].up)
    holes = _deployment("ceph_tpu_torch")["holes"]
    assert len(holes) <= 1          # one PG of 512 at 100 choose tries
    after_holes = []
    for ps in range(CS.MAP_PG_NUM):
        up = [o for o in ours["after"].lookup(ps)[0] if o >= 0]
        assert len({o // CS.MAP_OSDS_PER_HOST for o in up}) == len(up)
        if len(up) < 12:
            after_holes.append(ps)
    assert after_holes == sorted(set(holes) - set(ours["moved"])
                                 | set(ours["undersized"]))
    assert ours["ps"] not in ours["undersized"]


def test_deployment_plan_motion_groups_equal_reference(pkg):
    ours = _deployment(pkg.root)["motion"]["plan"]
    assert ours == _deployment(REF.root)["motion"]["plan"]
    assert ours["moved_pgs"] == len(_deployment(pkg.root)["motion"]["moved"])
    assert sum(len(g["pgs"]) for g in ours["groups"]) == ours["moved_pgs"]
    assert all(CS.MAP_OUT_OSD not in g["dests"] for g in ours["groups"])


def test_deployment_dicts_load_across_packages(pkg):
    """The deployment's OSDMap dicts (epochs 1 and 2), its CrushMap dict
    and the out-mark's Incremental, loaded in the other package: the same
    dicts back, and the same scalar rows on a sample of PGs."""
    ours, ref = _deployment(pkg.root), _deployment(REF.root)
    assert ours["first"] == ref["first"]
    assert ours["map"].to_dict() == ref["map"].to_dict()
    inc = pkg.om.Incremental(2, new_weights={CS.MAP_OUT_OSD: 0}).to_dict()
    for src, dst in ((ours, REF), (ref, pkg)):
        loaded = dst.om.OSDMap.from_dict(src["first"])
        assert loaded.to_dict() == src["first"]
        loaded.apply_incremental(dst.om.Incremental.from_dict(inc))
        assert loaded.to_dict() == src["map"].to_dict()
        crush = dst.cm.CrushMap.from_dict(src["map"].crush.to_dict())
        assert crush.to_dict() == src["map"].crush.to_dict()
        for ps in range(0, CS.MAP_PG_NUM, 37):
            assert loaded._pg_to_raw_osds_scalar(CS.MAP_POOL, ps) == \
                src["motion"]["after"].lookup(ps)[0]


def test_object_names_for_the_moved_pg(pkg):
    ps = _deployment(pkg.root)["motion"]["ps"]
    names = CS.pg_object_names(pkg.pg.object_to_ps, ps, 8, CS.SEED)
    assert names == CS.pg_object_names(REF.pg.object_to_ps, ps, 8, CS.SEED)
    assert len(set(names)) == 8
    assert all(pkg.pg.object_to_ps(nm, CS.MAP_PG_NUM) == ps for nm in names)


REHEARSAL_OBJECTS = 8
REHEARSAL_BYTES = 64 << 10


@functools.lru_cache(maxsize=None)
def _rehearsal(root, tmp):
    pkg = PKGS[root]
    motion = _deployment(root)["motion"]
    names = CS.pg_object_names(pkg.pg.object_to_ps, motion["ps"],
                               REHEARSAL_OBJECTS, CS.SEED)
    rng = np.random.default_rng(CS.SEED)
    datas = {nm: rng.bytes(REHEARSAL_BYTES) for nm in names}
    codec = pkg.registry.factory("jax_rs", dict(CS.OSD_PROFILE),
                                 **pkg.codec_kw)
    root_dir = pathlib.Path(tmp) / root
    root_dir.mkdir()
    return asyncio.run(CS.map_drain(pkg.osd, codec, str(root_dir), motion,
                                    datas))


def test_map_driven_backfill_rehearsal(pkg, tmp_path_factory):
    """Wave (d) at 8 x 64 KiB on the CPU: every object moved, read back
    equal with the out OSD's store deleted, every rebuilt shard and hinfo
    equal to the old store's and to the reference's."""
    tmp = str(tmp_path_factory.getbasetemp())
    ours, ref = _rehearsal(pkg.root, tmp), _rehearsal(REF.root, tmp)
    assert ours["done"] == ours["names"] and ours["reads"]
    assert len(ours["names"]) == REHEARSAL_OBJECTS
    assert ours["rebuilt"] == ours["old"]
    assert sorted(ours["rebuilt"]) == \
        _deployment(pkg.root)["motion"]["positions"]
    assert ours["counters"]["backfill_objects"] == REHEARSAL_OBJECTS
    assert ours["rebuilt"] == ref["rebuilt"] and ours["old"] == ref["old"]
    assert ours["counters"] == ref["counters"]
