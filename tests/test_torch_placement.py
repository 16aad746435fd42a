"""The port's placement package against the JAX package's, on the CPU.

Every scenario of tests/test_placement.py, test_straw2_compat.py,
test_crush_tools.py (those that stay inside placement; the live-monitor
round trip waits for the mon slice) and test_bulk_mapping.py runs once per
package, each with its own modules.  Then the packages against each
other, exactly, from seeded numpy inputs: the rjenkins hashes and the
object-name hash, the crush_ln tables and the full crush_ln domain, straw2
draws, CRUSH rows (replicated, indep, device-class, choose_args, every
bucket algorithm), the bulk chooser, compiled and decompiled maps, and
``CrushMap`` dicts loaded in both directions.  Tolerance 0.
"""

import functools
import importlib

import numpy as np
import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


class Pkg:
    """One package's placement surface."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.placement = mod("placement")
        self.hashing = mod("placement.hashing")
        self.straw2 = mod("placement.straw2")
        self.cm = mod("placement.crush_map")
        self.bulk = mod("placement.bulk")
        self.compiler = mod("placement.compiler")
        self.tester = mod("placement.tester")


PKGS = {name: Pkg(name) for name in PKG_NAMES}
REF = PKGS["ceph_tpu"]


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


def _same(a, b):
    """Exactly equal arrays of the same dtype and shape."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- hashing (tests/test_placement.py) ----------------------------------------

def test_hash_deterministic_and_spread(pkg):
    h = pkg.hashing
    a = h.crush_hash32_3(np.arange(1000), 7, 3)
    assert np.array_equal(a, h.crush_hash32_3(np.arange(1000), 7, 3))
    c = h.crush_hash32_3(np.arange(1000), 7, 4)
    assert np.mean(a == c) < 0.01
    lo = a & 0xFFFF
    assert 0.4 < np.mean(lo < 0x8000) < 0.6


def test_hash_c_reference_vectors(pkg):
    h = pkg.hashing
    assert int(h.crush_hash32(0)) == 0x17C4A80B
    assert int(h.crush_hash32(12345)) == 0xCDAC21D6
    assert int(h.crush_hash32_2(1, 2)) == 0xB78DEE9C
    assert int(h.crush_hash32_2(7, 99)) == 0x2C22BDE1
    assert int(h.crush_hash32_3(1, 2, 3)) == 0x735AD42B
    assert int(h.crush_hash32_3(42, 0, 7)) == 0x0C6A5547
    assert int(h.crush_hash32_4(1, 2, 3, 4)) == 0x696D1F16
    assert int(h.crush_hash32_5(1, 2, 3, 4, 5)) == 0x4B42A1A1


def test_hash_scalar_matches_vector(pkg):
    xs = np.arange(50)
    vec = pkg.hashing.crush_hash32_2(xs, 9)
    for i, x in enumerate(xs):
        assert pkg.hashing.crush_hash32_2(x, 9) == vec[i]


def test_hashes_equal_reference(pkg):
    """Every rjenkins mix over seeded uint32 arrays, wrap-around included
    (the full 32-bit range), equal to the reference's, dtype too."""
    rng = np.random.default_rng(11)
    a, b, c, d, e = rng.integers(0, 2**32, (5, 4096), dtype=np.uint64)
    ours, ref = pkg.hashing, REF.hashing
    _same(ours.crush_hash32(a), ref.crush_hash32(a))
    _same(ours.crush_hash32_2(a, b), ref.crush_hash32_2(a, b))
    _same(ours.crush_hash32_3(a, b, c), ref.crush_hash32_3(a, b, c))
    _same(ours.crush_hash32_4(a, b, c, d), ref.crush_hash32_4(a, b, c, d))
    _same(ours.crush_hash32_5(a, b, c, d, e),
          ref.crush_hash32_5(a, b, c, d, e))


def test_object_name_hash_equals_reference(pkg):
    """ceph_str_hash_rjenkins over names of every length 0..40 (each tail
    branch of the byte loop), as str and as bytes."""
    rng = np.random.default_rng(12)
    for n in range(41):
        raw = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        name = "".join(chr(97 + v % 26) for v in raw)
        for key in (raw, name):
            got = pkg.hashing.ceph_str_hash_rjenkins(key)
            assert got == REF.hashing.ceph_str_hash_rjenkins(key)
            assert isinstance(got, int) and 0 <= got < 2**32


# -- crush_ln and straw2 (test_placement.py, test_straw2_compat.py) -----------

def test_crush_ln_tables_equal_reference(pkg):
    for name in ("_RH", "_LH", "_LL"):
        _same(getattr(pkg.straw2, name), getattr(REF.straw2, name))


def test_table_rules_match_exact_arithmetic(pkg):
    from decimal import Decimal, getcontext

    getcontext().prec = 70
    ln2 = Decimal(2).ln()
    for k in range(129):
        num, den = (1 << 48) * 128, 128 + k
        assert int(pkg.straw2._RH[k]) == -(-num // den)
        if k == 0:
            assert int(pkg.straw2._LH[k]) == 0
        elif k == 128:
            assert int(pkg.straw2._LH[k]) == (1 << 48) - (1 << 32)
        else:
            exact = Decimal(2) ** 48 * ((1 + Decimal(k) / 128).ln() / ln2)
            assert int(pkg.straw2._LH[k]) == int(
                exact.to_integral_value(rounding="ROUND_FLOOR"))


def test_crush_ln_full_domain(pkg):
    """The whole 16-bit domain equal to the reference's, and the
    reference's accuracy, monotonicity and anchor checks."""
    xs = np.arange(0, 0x10000, dtype=np.uint32)
    ln = pkg.straw2.crush_ln(xs)
    _same(ln, REF.straw2.crush_ln(xs))
    assert ln[0] == 0
    assert abs(int(ln[-1]) - (16 << 44)) < (1 << 40)
    ref = (2.0**44) * np.log2(xs.astype(np.float64) + 1)
    rel = np.abs(ln[1:].astype(np.float64) - ref[1:]) / (2.0**44 * 16)
    assert rel.max() < 1e-3
    x1 = np.arange(1, 0x10000, dtype=np.int64)
    err = np.abs(pkg.straw2.crush_ln(x1).astype(np.float64)
                 - (2.0**44) * np.log2(x1.astype(np.float64) + 1.0))
    assert float(err.max()) < 1.6e9
    assert np.all(np.diff(pkg.straw2.crush_ln(x1)) >= 0)
    for x in (0, 1, 3, 7, 0x7FFF):
        assert int(pkg.straw2.crush_ln(np.int64(x))) == \
            round((2 ** 44) * np.log2(x + 1))
    assert int(pkg.straw2.crush_ln(np.int64(0xFFFF))) == \
        (15 << 44) + (((1 << 48) - (1 << 32)) >> 4)


def test_straw2_draws_equal_reference(pkg):
    """Draws for seeded inputs, ids, 16.16 weights (zero weights among
    them, so the S64_MIN arm) and per-input ranks; the truncating
    division of negative logs by the weights."""
    rng = np.random.default_rng(13)
    xs = rng.integers(0, 2**31, 2048)
    ids = rng.integers(-50, 200, 9)
    w = rng.integers(0, 5, 9) << 16
    w[3] = 0
    r = rng.integers(0, 8, 2048)
    _same(pkg.straw2.straw2_draws(xs, ids, w, r),
          REF.straw2.straw2_draws(xs, ids, w, r))
    _same(pkg.straw2.straw2_draws(7, ids, w, 2),
          REF.straw2.straw2_draws(7, ids, w, 2))
    _same(pkg.straw2.straw2_choose(xs, ids, w, r),
          REF.straw2.straw2_choose(xs, ids, w, r))
    num = rng.integers(-2**40, 2**40, 1000)
    den = rng.integers(1, 2**20, 1000) * rng.choice([-1, 1], 1000)
    _same(pkg.straw2._div_trunc(num, den), REF.straw2._div_trunc(num, den))


def test_straw2_respects_weights(pkg):
    weights = [pkg.cm.weight_to_fp(w) for w in (1.0, 2.0, 1.0)]
    picks = pkg.straw2.straw2_choose(np.arange(20000), [0, 1, 2], weights,
                                     r=0)
    counts = np.bincount(picks, minlength=3) / 20000
    assert abs(counts[1] - 0.5) < 0.03
    assert abs(counts[0] - 0.25) < 0.03


def test_straw2_zero_weight_never_chosen(pkg):
    weights = [pkg.cm.weight_to_fp(1.0), 0, pkg.cm.weight_to_fp(1.0)]
    picks = pkg.straw2.straw2_choose(np.arange(5000), [0, 1, 2], weights,
                                     r=0)
    assert not np.any(picks == 1)


def test_distribution_proportional_to_weights(pkg):
    ids = np.array([1, 2, 3, 4])
    weights = np.array([1, 2, 3, 4]) << 16
    n = 200_000
    picks = pkg.straw2.straw2_choose(np.arange(n), ids, weights, r=0)
    total = weights.sum()
    for item, w in zip(ids, weights):
        expect = n * w / total
        sigma = (expect * (1 - w / total)) ** 0.5
        assert abs(int((picks == item).sum()) - expect) < 5 * sigma


def test_distribution_stable_under_weight_scaling(pkg):
    ids = np.array([10, 20, 30])
    xs = np.arange(50_000)
    p1 = pkg.straw2.straw2_choose(xs, ids, np.array([1, 1, 2]) << 16, r=0)
    p2 = pkg.straw2.straw2_choose(xs, ids, np.array([2, 2, 4]) << 16, r=0)
    assert float((p1 == p2).mean()) > 0.99


def test_upstream_divergence_bound_is_small(pkg):
    ids = np.arange(1, 9)
    weights = (np.array([1, 1, 2, 2, 3, 3, 4, 4]) << 16).astype(np.int64)
    draws = pkg.straw2.straw2_draws(np.arange(100_000), ids, weights, r=0)
    part = np.partition(draws, -2, axis=1)
    gap = part[:, -1] - part[:, -2]
    bound = 2 * (5.6e9 / 16) / float(weights.min())
    assert float((gap.astype(np.float64) < bound).mean()) < 0.02


# -- the map and its rules (test_placement.py) --------------------------------

def _cluster(pkg, racks=3, hosts_per=3, osds_per=2):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root")
    osd = 0
    for r in range(racks):
        rack = m.add_bucket(f"rack{r}", "rack")
        for h in range(hosts_per):
            host = m.add_bucket(f"rack{r}-host{h}", "host")
            for _ in range(osds_per):
                m.add_item(host, osd, 1.0)
                osd += 1
            m.add_item(rack, host)
        m.add_item(root, rack)
    return m, osd


def _classed_cluster(pkg):
    m, n = _cluster(pkg)
    for d in range(n):
        m.set_item_class(d, "ssd" if d % 2 == 0 else "hdd")
    return m, n


def _host_of(pkg, m):
    host_of = {}
    for b in m.buckets.values():
        if b.type_id == m.types["host"] and not m.is_shadow(b.id):
            for it in b.items:
                host_of[it] = b.id
    return host_of


def test_replicated_rule_distinct_hosts(pkg):
    m, _ = _cluster(pkg)
    rule = m.create_replicated_rule("rep", failure_domain="host")
    host_of = _host_of(pkg, m)
    for x in range(200):
        out = m.do_rule(rule, x, 3)
        assert len(out) == 3 and len(set(out)) == 3
        assert len({host_of[o] for o in out}) == 3


def test_rule_deterministic(pkg):
    m, _ = _cluster(pkg)
    rule = m.create_replicated_rule("rep")
    for x in (1, 42, 9999):
        assert m.do_rule(rule, x, 3) == m.do_rule(rule, x, 3)


def test_ec_rule_indep_positions(pkg):
    m, n = _cluster(pkg, racks=4, hosts_per=3, osds_per=2)
    rule = m.create_ec_rule("ec12", chunk_count=12, failure_domain="osd")
    out = m.do_rule(rule, 7, 12)
    assert len(out) == 12
    real = [o for o in out if o != pkg.cm.ITEM_NONE]
    assert len(set(real)) == len(real)
    rew = [0x10000] * n
    victim = real[3]
    rew[victim] = 0
    out2 = m.do_rule(rule, 7, 12, reweights=rew)
    moved = [i for i, (a, b) in enumerate(zip(out, out2))
             if a != b and a != victim]
    assert len(moved) <= 2
    assert out2[out.index(victim)] != victim


def test_insufficient_domains_leaves_holes(pkg):
    m, _ = _cluster(pkg, racks=2, hosts_per=1, osds_per=1)
    rule = m.create_ec_rule("ec4", 4, failure_domain="osd")
    out = m.do_rule(rule, 3, 4)
    assert len(out) == 4 and out.count(pkg.cm.ITEM_NONE) == 2


def test_reweight_out_excludes_device(pkg):
    m, n = _cluster(pkg)
    rule = m.create_replicated_rule("rep", failure_domain="host")
    rew = [0x10000] * n
    rew[0] = 0
    for x in range(100):
        assert 0 not in m.do_rule(rule, x, 3, reweights=rew)


def test_distribution_roughly_uniform(pkg):
    m, n = _cluster(pkg)
    rule = m.create_replicated_rule("rep", failure_domain="host")
    counts = np.zeros(n, dtype=int)
    for x in range(600):
        for o in m.do_rule(rule, x, 3):
            counts[o] += 1
    expect = 3 * 600 / n
    assert counts.min() > 0.5 * expect and counts.max() < 1.7 * expect


def test_weight_bias(pkg):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root")
    host = m.add_bucket("h0", "host")
    m.add_item(host, 0, 2.0)
    m.add_item(host, 1, 1.0)
    m.add_item(host, 2, 1.0)
    m.add_item(root, host)
    rule = m.create_replicated_rule("r1", failure_domain="osd")
    counts = np.zeros(3, int)
    for x in range(4000):
        counts[m.do_rule(rule, x, 1)[0]] += 1
    assert abs(counts[0] / 4000 - 0.5) < 0.05


def test_indep_out_device_never_leaks(pkg):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root")
    host = m.add_bucket("h0", "host")
    for i in range(3):
        m.add_item(host, i, 1.0)
    m.add_item(root, host)
    rule = m.create_ec_rule("ec", 3, failure_domain="osd")
    for x in range(300):
        assert 1 not in m.do_rule(rule, x, 3,
                                  reweights=[0x10000, 0, 0x10000])


def test_top_down_construction_weight_propagation(pkg):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root")
    host = m.add_bucket("h", "host")
    m.add_item(root, host)
    for i in range(3):
        m.add_item(host, i, 1.0)
    rule = m.create_replicated_rule("r", failure_domain="osd")
    assert len(m.do_rule(rule, 1, 2)) == 2


def test_device_class_restricts_placement(pkg):
    m, _ = _classed_cluster(pkg)
    rule = m.create_ec_rule("ec-ssd", 4, failure_domain="host",
                            device_class="ssd")
    host_of = _host_of(pkg, m)
    for x in range(200):
        real = [o for o in m.do_rule(rule, x, 4) if o != pkg.cm.ITEM_NONE]
        assert real and all(o % 2 == 0 for o in real)
        hosts = [host_of[o] for o in real]
        assert len(set(hosts)) == len(hosts)


def test_device_class_replicated_rule(pkg):
    m, _ = _classed_cluster(pkg)
    rule = m.create_replicated_rule("rep-hdd", failure_domain="host",
                                    device_class="hdd")
    for x in range(100):
        out = m.do_rule(rule, x, 3)
        assert len(out) == 3 and all(o % 2 == 1 for o in out)


def test_device_class_missing_class_maps_empty(pkg):
    m, _ = _classed_cluster(pkg)
    rule = m.create_ec_rule("ec-nvme", 4, failure_domain="host",
                            device_class="nvme")
    assert all(o == pkg.cm.ITEM_NONE for o in m.do_rule(rule, 5, 4))


def test_device_class_shadow_tracks_topology(pkg):
    m, _ = _classed_cluster(pkg)
    rule = m.create_replicated_rule("rep-ssd", failure_domain="osd",
                                    device_class="ssd")
    seen = {o for x in range(300) for o in m.do_rule(rule, x, 2)}
    assert all(o % 2 == 0 for o in seen)
    m.set_item_class(1, "ssd")
    assert 1 in {o for x in range(600) for o in m.do_rule(rule, x, 2)}
    m.set_item_class(1, "hdd")
    assert 1 not in {o for x in range(300) for o in m.do_rule(rule, x, 2)}


def test_device_class_stability_within_class(pkg):
    m, n = _classed_cluster(pkg)
    rule = m.create_replicated_rule("rep-ssd", failure_domain="host",
                                    device_class="ssd")
    before = [m.do_rule(rule, x, 3) for x in range(100)]
    m.add_item(m.buckets[m.names["rack0-host0"]], n, 1.0)
    m.set_item_class(n, "hdd")
    assert [m.do_rule(rule, x, 3) for x in range(100)] == before


def test_device_class_serialization_roundtrip(pkg):
    m, _ = _classed_cluster(pkg)
    rule = m.create_ec_rule("ec-ssd", 4, failure_domain="host",
                            device_class="ssd")
    out1 = [m.do_rule(rule, x, 4) for x in range(50)]
    m2 = pkg.cm.CrushMap.from_dict(m.to_dict())
    assert m2.class_map == m.class_map
    assert [m2.do_rule("ec-ssd", x, 4) for x in range(50)] == out1
    assert all("~" not in b["name"] for b in m.to_dict()["buckets"])


def test_device_class_compiler_roundtrip(pkg):
    m, _ = _classed_cluster(pkg)
    m.create_ec_rule("ec-ssd", 4, failure_domain="host", device_class="ssd")
    out1 = [m.do_rule("ec-ssd", x, 4) for x in range(50)]
    text = pkg.compiler.decompile(m)
    assert "class ssd" in text and "~" not in text
    assert "step take default class ssd" in text
    m2 = pkg.compiler.compile_text(text)
    assert m2.class_map == m.class_map
    assert m2.class_bucket == m.class_bucket
    assert m2.rules["ec-ssd"].steps[0] == ("take", "default", "ssd")
    assert [m2.do_rule("ec-ssd", x, 4) for x in range(50)] == out1
    assert pkg.compiler.decompile(m2) == text


def test_take_unknown_bucket(pkg):
    m, _ = _cluster(pkg)
    m.add_rule(pkg.cm.Rule("bad", [("take", "nope"), ("emit",)]))
    with pytest.raises(KeyError):
        m.do_rule("bad", 1, 3)


@functools.lru_cache(maxsize=None)
def _rule_rows(root, seed):
    """CRUSH rows of a seeded classed map under every rule shape, a live
    reweight vector and a weight-set: one list per rule (computed once
    per package)."""
    pkg = PKGS[root]
    rng = np.random.default_rng(seed)
    m, n = _classed_cluster(pkg)
    m.create_replicated_rule("rep", failure_domain="host")
    m.create_ec_rule("ec6", 6, failure_domain="host")
    m.create_ec_rule("ec-ssd", 4, failure_domain="host", device_class="ssd")
    m.create_replicated_rule("rep-hdd", failure_domain="osd",
                             device_class="hdd")
    m.create_ec_rule("lrc", 6, steps=[("choose", "rack", 3),
                                      ("chooseleaf", "osd", 2)])
    m.choose_args["ws"] = {m.names["default"]: [0x18000, 0x10000, 0x8000]}
    rew = [int(w) for w in rng.choice([0, 0x8000, 0x10000], n,
                                      p=[0.1, 0.2, 0.7])]
    xs = [int(x) for x in rng.integers(0, 2**31, 150)]
    out = {}
    for rule, rep in (("rep", 3), ("ec6", 6), ("ec-ssd", 4),
                      ("rep-hdd", 3), ("lrc", 6)):
        out[rule] = [m.do_rule(rule, x, rep, rew) for x in xs]
    out["ws"] = [m.do_rule("rep", x, 3, None, "ws") for x in xs]
    return m, out


def test_crush_rows_equal_reference(pkg):
    assert _rule_rows(pkg.root, 21)[1] == _rule_rows(REF.root, 21)[1]


def test_crush_map_dicts_load_across_packages(pkg):
    """A CrushMap dict from either package loads in the other, encodes
    back to the same dict and maps the same rows."""
    m, _ = _rule_rows(pkg.root, 21)
    ref_m, _ = _rule_rows(REF.root, 21)
    assert m.to_dict() == ref_m.to_dict()
    for src, dst in ((m, REF), (ref_m, pkg)):
        loaded = dst.cm.CrushMap.from_dict(src.to_dict())
        assert loaded.to_dict() == src.to_dict()
        for rule, rep, args in (("ec6", 6, None), ("rep", 3, "ws"),
                                ("ec-ssd", 4, None)):
            assert [loaded.do_rule(rule, x, rep, None, args)
                    for x in range(40)] == \
                [src.do_rule(rule, x, rep, None, args) for x in range(40)]


# -- bucket algorithms, compiler, tester (test_crush_tools.py) ---------------

def build_map(pkg, alg="straw2", n_hosts=4, osds_per_host=2):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root", alg)
    dev = 0
    for h in range(n_hosts):
        hb = m.add_bucket(f"host{h}", "host", alg)
        for _ in range(osds_per_host):
            m.add_item(hb, dev)
            dev += 1
        m.add_item(root, hb)
    m.create_replicated_rule("data", failure_domain="host")
    return m


@functools.lru_cache(maxsize=None)
def _alg_rows(root, alg):
    m = build_map(PKGS[root], alg)
    return [m.do_rule("data", x, 3) for x in range(2000)]


@pytest.mark.parametrize("alg", ["straw2", "list", "tree", "uniform"])
def test_bucket_algs_place_and_spread(pkg, alg):
    rows = _alg_rows(pkg.root, alg)
    counts = {}
    for row in rows:
        assert len(row) == 3 and len(set(row)) == 3
        assert len({o // 2 for o in row}) == 3
        for o in row:
            counts[o] = counts.get(o, 0) + 1
    assert sorted(counts) == list(range(8))
    vals = np.array(list(counts.values()), float)
    assert vals.std() / vals.mean() < 0.35
    assert rows == _alg_rows(REF.root, alg)


@pytest.mark.parametrize("alg", ["straw2", "list", "tree"])
def test_bucket_weight_skew(pkg, alg):
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root", alg)
    m.add_item(root, 0, 1.0)
    m.add_item(root, 1, 2.0)
    m.add_item(root, 2, 1.0)
    m.add_rule(pkg.cm.Rule("pick1", [("take", "default"),
                                     ("choose_firstn", 1, "osd"),
                                     ("emit",)]))
    counts = {0: 0, 1: 0, 2: 0}
    for x in range(4000):
        counts[m.do_rule("pick1", x, 1)[0]] += 1
    assert 0.7 < counts[1] / max(counts[0] + counts[2], 1) < 1.4


def _tools_map(pkg):
    m = build_map(pkg, "straw2")
    m.buckets[m.names["host0"]].alg = "list"
    m.buckets[m.names["host1"]].alg = "tree"
    m.create_ec_rule("ecrule", 6, failure_domain="osd")
    m.choose_args["balanced"] = {
        m.names["default"]: [0x18000, 0x10000, 0x10000, 0x8000]}
    return m


def test_compiler_round_trip(pkg):
    m = _tools_map(pkg)
    text = pkg.compiler.decompile(m)
    m2 = pkg.compiler.compile_text(text)
    for rule, rep in (("data", 3), ("ecrule", 6)):
        for x in range(500):
            assert m.do_rule(rule, x, rep) == m2.do_rule(rule, x, rep)
    for x in range(200):
        assert m.do_rule("data", x, 3, choose_args="balanced") == \
            m2.do_rule("data", x, 3, choose_args="balanced")
    assert pkg.compiler.decompile(m2) == text


def test_compiled_maps_equal_reference(pkg):
    """The same map decompiles to the same text in both packages, and
    that text compiles to the same map (its dict) in each."""
    text = pkg.compiler.decompile(_tools_map(pkg))
    assert text == REF.compiler.decompile(_tools_map(REF))
    assert pkg.compiler.compile_text(text).to_dict() == \
        REF.compiler.compile_text(text).to_dict()
    classed, _ = _classed_cluster(pkg)
    classed.create_ec_rule("e", 4, failure_domain="host",
                           device_class="ssd")
    ref_classed, _ = _classed_cluster(REF)
    ref_classed.create_ec_rule("e", 4, failure_domain="host",
                               device_class="ssd")
    text = pkg.compiler.decompile(classed)
    assert text == REF.compiler.decompile(ref_classed)
    assert pkg.compiler.compile_text(text).to_dict() == \
        REF.compiler.compile_text(text).to_dict()


def test_compiler_rejects_garbage(pkg):
    err = pkg.compiler.CompileError
    with pytest.raises(err):
        pkg.compiler.compile_text("bogus line\n")
    with pytest.raises(err):
        pkg.compiler.compile_text("host h1 {\n id -2\n")
    with pytest.raises(err):
        pkg.compiler.compile_text("type 0 osd\ntype 1 root\nroot default {\n"
                                  "  id -1\n  alg straw9\n}\n")


def test_choose_args_skews_placement(pkg):
    m = build_map(pkg, "straw2", n_hosts=2, osds_per_host=1)
    m.choose_args["drain0"] = {m.names["default"]: [0, 0x10000]}
    base = [m.do_rule("data", x, 1)[0] for x in range(300)]
    skew = [m.do_rule("data", x, 1, choose_args="drain0")[0]
            for x in range(300)]
    assert set(base) == {0, 1} and set(skew) == {1}
    assert [m.do_rule("data", x, 1, choose_args="nope")[0]
            for x in range(300)] == base


@functools.lru_cache(maxsize=None)
def _report(root):
    pkg = PKGS[root]
    return pkg.tester.simulate(build_map(pkg), "data", 3, 0, 2000)


def test_tester_report(pkg):
    report = _report(pkg.root)
    assert report == _report(REF.root)
    assert report["bad_mappings"] == 0 and report["placed"] == 6000
    assert len(report["devices"]) == 8
    for dev in report["devices"].values():
        assert abs(dev["deviation"]) < dev["expected"] * 0.5
    tiny = pkg.cm.CrushMap()
    root = tiny.add_bucket("default", "root")
    tiny.add_item(root, 0)
    tiny.add_item(root, 1)
    tiny.create_ec_rule("ec", 4, failure_domain="osd")
    assert pkg.tester.simulate(tiny, "ec", 4, 0, 50)["bad_mappings"] == 50


def test_tester_cli(pkg, tmp_path, capsys):
    path = tmp_path / "map.txt"
    path.write_text(pkg.compiler.decompile(build_map(pkg)))
    argv = ["--map", str(path), "--rule", "data", "--num-rep", "3",
            "--max-x", "200"]
    assert pkg.tester.main(argv) == 0
    ours = capsys.readouterr().out
    assert REF.tester.main(argv) == 0
    assert ours == capsys.readouterr().out


# -- the bulk chooser (test_bulk_mapping.py) ----------------------------------

def build(pkg, seed, alg_mix=("straw2",), hosts=4, per_host=3, racks=0):
    rng = np.random.default_rng(seed)
    m = pkg.cm.CrushMap()
    root = m.add_bucket("default", "root")
    parents = [root]
    if racks:
        parents = []
        for rk in range(racks):
            rb = m.add_bucket(f"rack{rk}", "rack")
            m.add_item(root, rb)
            parents.append(rb)
    dev = 0
    for h in range(hosts):
        hb = m.add_bucket(f"host{h}", "host", alg_mix[h % len(alg_mix)])
        for _ in range(per_host):
            m.add_item(hb, dev, float(rng.integers(1, 5)))
            dev += 1
        m.add_item(parents[h % len(parents)], hb)
    return m


def _scalar(pkg, m, rule, xs, result_max, reweights=None, choose_args=None):
    out = np.full((len(xs), result_max), pkg.cm.ITEM_NONE, np.int32)
    for i, x in enumerate(xs):
        row = m.do_rule(rule, int(x), result_max, reweights, choose_args)
        out[i, :len(row)] = row
    return out


def _bulk_both(pkg, make_map, rule, xs, result_max, **kw):
    """map_pgs_bulk of the same seeded map in this package and in the
    reference: equal, and equal to this package's scalar machine."""
    m, ref_m = make_map(pkg), make_map(REF)
    got = pkg.bulk.map_pgs_bulk(m, rule, xs, result_max, **kw)
    _same(got, REF.bulk.map_pgs_bulk(ref_m, rule, xs, result_max, **kw))
    _same(got, _scalar(pkg, m, rule, xs, result_max, kw.get("reweights"),
                       kw.get("choose_args")))
    return got


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("algs", [("straw2",), ("straw2", "uniform")])
def test_chooseleaf_bit_identity(pkg, seed, algs):
    def make_map(p):
        m = build(p, seed, algs)
        m.create_replicated_rule("data", failure_domain="host")
        return m
    _bulk_both(pkg, make_map, "data", list(range(500)), 3)


def test_choose_device_and_reweights(pkg):
    def make_map(p):
        m = build(p, 7, hosts=3, per_host=4)
        m.add_rule(p.cm.Rule("flat", [("take", "default"),
                                      ("choose_firstn", 3, "osd"),
                                      ("emit",)]))
        return m
    rw = [0x10000] * 12
    rw[2], rw[7] = 0, 0x8000
    got = _bulk_both(pkg, make_map, "flat", list(range(400)), 3, reweights=rw)
    assert not (got == 2).any()


def test_choose_bucket_level_and_racks(pkg):
    def make_map(p):
        m = build(p, 11, hosts=6, per_host=2, racks=3)
        m.add_rule(p.cm.Rule("hosts", [("take", "default"),
                                       ("choose_firstn", 4, "host"),
                                       ("emit",)]))
        m.create_replicated_rule("deep", failure_domain="rack")
        return m
    xs = list(range(300))
    _bulk_both(pkg, make_map, "hosts", xs, 4)
    _bulk_both(pkg, make_map, "deep", xs, 3)


def test_oversubscribed_and_choose_args(pkg):
    def make_map(p):
        m = build(p, 13, hosts=2, per_host=2)
        m.create_replicated_rule("data", failure_domain="host")
        m.choose_args["ws"] = {m.names["default"]: [0x30000, 0x10000]}
        return m
    xs = list(range(200))
    _bulk_both(pkg, make_map, "data", xs, 4)
    _bulk_both(pkg, make_map, "data", xs, 2, choose_args="ws")


def test_chooseleaf_with_reweights_bit_identity(pkg):
    def make_map(p):
        m = build(p, 29, hosts=5, per_host=3)
        m.create_replicated_rule("data", failure_domain="host")
        return m
    rw = [0x10000] * 15
    rw[4], rw[9], rw[14] = 0, 0x4000, 0x8000
    got = _bulk_both(pkg, make_map, "data", list(range(600)), 3, reweights=rw)
    assert not (got == 4).any()


def test_numrep_exceeding_result_max_backfills(pkg):
    def make_map(p):
        m = build(p, 31, hosts=5, per_host=1)
        m.tunables.choose_total_tries = 1
        m.add_rule(p.cm.Rule("wide", [("take", "default"),
                                      ("chooseleaf_firstn", 4, "host"),
                                      ("emit",)]))
        return m
    got = _bulk_both(pkg, make_map, "wide", list(range(400)), 3)
    assert (got != pkg.cm.ITEM_NONE).all(axis=1).any()


def test_unsupported_shapes_fall_back(pkg):
    def ec(p):
        m = build(p, 17)
        m.create_ec_rule("ec", 4, failure_domain="osd")
        return m

    def lists(p):
        m = build(p, 19, alg_mix=("list", "tree"))
        m.create_replicated_rule("data", failure_domain="host")
        return m
    xs = list(range(64))
    m = ec(pkg)
    assert not pkg.bulk._supported(m, m.rules["ec"])
    _bulk_both(pkg, ec, "ec", xs, 4)
    _bulk_both(pkg, lists, "data", xs, 3)


def test_bulk_faster_than_scalar(pkg):
    import time

    m = build(pkg, 23, hosts=8, per_host=4)
    m.create_replicated_rule("data", failure_domain="host")
    xs = list(range(4096))
    t0 = time.perf_counter()
    pkg.bulk.map_pgs_bulk(m, "data", xs, 3)
    bulk_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    _scalar(pkg, m, "data", xs[:512], 3)
    scalar_t = (time.perf_counter() - t0) * (len(xs) / 512)
    assert bulk_t < scalar_t, (bulk_t, scalar_t)


def test_class_restricted_rule_stays_vectorized(pkg):
    def make_map(p):
        m = build(p, 23, hosts=6, per_host=2)
        for d in range(12):
            m.set_item_class(d, "ssd" if d % 2 == 0 else "hdd")
        m.create_replicated_rule("rep-ssd", failure_domain="host",
                                 device_class="ssd")
        m.create_replicated_rule("rep-nvme", failure_domain="host",
                                 device_class="nvme")
        return m
    m = make_map(pkg)
    assert pkg.bulk._supported(m, m.rules["rep-ssd"])
    xs = list(range(300))
    got = _bulk_both(pkg, make_map, "rep-ssd", xs, 3)
    real = got[got != pkg.cm.ITEM_NONE]
    assert len(real) and (real % 2 == 0).all()
    got2 = _bulk_both(pkg, make_map, "rep-nvme", xs, 3)
    assert (got2 == pkg.cm.ITEM_NONE).all()


def test_placement_exports_mirror_reference(pkg):
    for name in ("Bucket", "CrushMap", "Rule", "crush_hash32_2",
                 "crush_hash32_3"):
        assert getattr(pkg.placement, name).__module__.startswith(
            f"{pkg.root}.placement.")
