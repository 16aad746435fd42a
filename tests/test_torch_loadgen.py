"""The port's serving load generator against the JAX package's.

``LoadGen.plan()`` and ``key_sizes()`` derive from the seed alone, so they
must be equal across packages for every seed, in both modes and over the
generator's knobs (``bench.py --serve``'s shape among them), as must
``zipf_cdf`` and the per-key payloads.  Then tests/test_loadgen.py's two
live scenarios, a closed-loop and an open-loop run over ``RadosBackend``
on a replicated pool, run once on a fresh dev cluster of each package (the
port's OSD daemons on ``device="cpu"``), and a third on an erasure-coded
pool: each ends with zero errors, and the op, put/get and byte counts and
every key's bytes read back after the run are equal.  Latencies are held to
the reference test's own bounds only.

The erasure-coded run is a closed loop of one client.  With several
clients, two ops on one hot key overlap, and in both packages an EC read
that races an overwrite of its object can fail with EIO ("cannot
reconstruct ...: only [] available"); ROADMAP Queue C lists it.  One client
never overlaps two ops.
"""

import asyncio
import functools
import importlib
import json
from types import SimpleNamespace

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    device = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return SimpleNamespace(
        root=root, loadgen=mod("testing.loadgen"), fp=mod("common.failpoint"),
        reset_local_namespace=mod("msg").reset_local_namespace,
        DevCluster=functools.partial(mod("vstart").DevCluster, **device))


PKGS = {name: _pkg(name) for name in PKG_NAMES}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS.values():
        p.reset_local_namespace()
        p.fp.fp_clear()
        p.fp.set_seed(0)
    yield
    for p in PKGS.values():
        p.fp.fp_clear()
        p.fp.set_seed(0)
        p.reset_local_namespace()


def _equal_across(fn):
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    return out["ceph_tpu"]


KNOBS = [
    {},
    # bench.py --serve's shape
    {"n_keys": 48, "tenant_class": "gold", "read_fraction": 0.7,
     "zipf_s": 1.1},
    {"n_keys": 7, "read_fraction": 0.0, "zipf_s": 0.5, "rate": 13.0,
     "size_mix": [(100, 1.0), (3000, 2.5)]},
    {"n_keys": 200, "read_fraction": 1.0, "zipf_s": 2.0, "clients": 9,
     "total_ops": 1000},
]


@pytest.mark.parametrize("mode", ["closed", "open"])
@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_plan_and_key_sizes_equal(seed, mode, knobs):
    def run(p):
        g = p.loadgen.LoadGen(p.loadgen.RadosBackend(None), seed=seed,
                              mode=mode, **KNOBS[knobs])
        return json.dumps(g.plan()), g.key_sizes()

    plan, sizes = _equal_across(run)
    ops = json.loads(plan)
    assert len(ops) == KNOBS[knobs].get("total_ops", 200)
    assert all(op["size"] == sizes[op["key"]] for op in ops)
    assert all((op["at"] is None) == (mode == "closed") for op in ops)


def test_zipf_cdf_payloads_and_mode_validation_equal():
    def run(p):
        lg = p.loadgen
        cdfs = [lg.zipf_cdf(n, s) for n in (1, 7, 64) for s in (0.5, 1.1)]
        payloads = [lg._payload(f"k{i:05d}", size)
                    for i in range(5) for size, _ in lg.DEFAULT_SIZE_MIX]
        with pytest.raises(ValueError) as e:
            lg.LoadGen(lg.RadosBackend(None), mode="bursty")
        return cdfs, payloads, lg.DEFAULT_SIZE_MIX, str(e.value)

    _equal_across(run)


async def _cluster_io(p, pool, ec):
    cluster = p.DevCluster(n_mons=1, n_osds=3)
    await cluster.start()
    rados = await cluster.client()
    if ec:
        r = await rados.mon_command(
            "osd erasure-code-profile set", name="lg_ec",
            profile={"plugin": "jax_rs", "k": "2", "m": "1",
                     "crush-failure-domain": "osd"})
        assert r["rc"] == 0, r
        await rados.pool_create(pool, pg_num=4, pool_type="erasure",
                                erasure_code_profile="lg_ec")
    else:
        await rados.pool_create(pool, pg_num=4, size=3)
    io = await rados.open_ioctx(pool)
    return cluster, io


COUNTS = ("ops", "errors", "puts", "gets", "bytes_put", "bytes_get",
          "seed", "mode", "tenant_class", "clients", "throttled")


def _scenario(mode, ec):
    async def run(p):
        cluster, io = await _cluster_io(p, "lgp", ec)
        try:
            lg = p.loadgen
            if mode == "closed":
                g = lg.LoadGen(lg.RadosBackend(io), seed=7, mode="closed",
                               clients=1 if ec else 4, total_ops=80,
                               n_keys=16)
            else:
                g = lg.LoadGen(lg.RadosBackend(io), seed=9, mode="open",
                               rate=200.0, total_ops=60, n_keys=8)
            await g.populate()
            res = await g.run()
            back = {k: await io.read(f"lg-{k}") for k in g.key_sizes()}
            if mode == "closed":
                assert res["p50_ms"] > 0.0 and \
                    res["p99_ms"] >= res["p50_ms"]
            else:
                assert res["wall_s"] >= 0.29
            return {k: res[k] for k in COUNTS}, back
        finally:
            await cluster.stop()

    return run


@pytest.mark.parametrize("mode,ec", [("closed", False), ("open", False),
                                     ("closed", True)],
                         ids=["closed", "open", "closed-ec"])
def test_rados_backend_zero_errors_on_each_package(mode, ec):
    out = {}
    for name, p in PKGS.items():
        p.reset_local_namespace()
        out[name] = asyncio.run(_scenario(mode, ec)(p))
        p.reset_local_namespace()
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    counts, back = out["ceph_tpu"]
    assert counts["errors"] == 0 and counts["ops"] == \
        (80 if mode == "closed" else 60)
    assert counts["puts"] + counts["gets"] == counts["ops"]
    assert counts["bytes_put"] > 0 and counts["bytes_get"] > 0
    assert all(len(v) > 0 for v in back.values())
