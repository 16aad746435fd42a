"""The port's object store, transaction codec, PG log and store state on
the CPU against the JAX package's, exact.

The cases of tests/test_store.py run on both MemStores and must leave
the same contents (read through the public readers); a transaction
encoded by either package's ``encode_tx`` and framed by either wire
codec decodes in the other to the same operations and re-encodes to
the same bytes; ``dump_memstore`` / ``memstore_from_dump`` round-trip;
a logged (strict) EC backend writes the same PG log on both.
"""

import asyncio

import pytest

from ceph_tpu.msg import codec as j_codec
from ceph_tpu.osd import pg_log as j_pg_log
from ceph_tpu.store import txcodec as j_txcodec
from ceph_tpu_torch.msg import codec
from ceph_tpu_torch.osd import pg_log
from ceph_tpu_torch.store import state, txcodec

from test_torch_ec_backend import Pkg, payload, snapshot


def _run(coro):
    return asyncio.run(coro)


def _fresh(P):
    s = P.MemStore()
    _run(s.queue_transactions(P.Transaction().create_collection(
        P.CollectionId(1, 0, shard=0))))
    return s


def _ids(P):
    return P.CollectionId(1, 0, shard=0), P.GHObject(1, "obj", shard=0)


def case_roundtrip(P, store):
    cid, oid = _ids(P)
    _run(store.queue_transactions(P.Transaction().write(
        cid, oid, 0, b"hello").write(cid, oid, 5, b" world")))
    return [store.read(cid, oid), store.read(cid, oid, 6, 5),
            store.stat(cid, oid)]


def case_sparse(P, store):
    cid, oid = _ids(P)
    _run(store.queue_transactions(P.Transaction().write(cid, oid, 8, b"x")))
    return [store.read(cid, oid)]


def case_zero_truncate_remove(P, store):
    cid, oid = _ids(P)
    T = P.Transaction
    out = []
    _run(store.queue_transactions(T().write(cid, oid, 0, b"abcdef")))
    _run(store.queue_transactions(T().zero(cid, oid, 1, 2)))
    out.append(store.read(cid, oid))
    _run(store.queue_transactions(T().truncate(cid, oid, 3)))
    out.append(store.read(cid, oid))
    _run(store.queue_transactions(T().remove(cid, oid)))
    return out + [store.exists(cid, oid)]


def case_attrs_omap(P, store):
    cid, oid = _ids(P)
    T = P.Transaction
    _run(store.queue_transactions(T().setattr(cid, oid, "hinfo", b"\x01\x02")
                                  .omap_setkeys(cid, oid, {"k1": b"v1",
                                                           "k2": b"v2"})))
    out = [store.getattr(cid, oid, "hinfo"), store.omap_get(cid, oid)]
    _run(store.queue_transactions(T().rmattr(cid, oid, "hinfo")
                                  .omap_rmkeys(cid, oid, ["k1"])))
    return out + [store.getattrs(cid, oid), store.omap_get(cid, oid)]


def case_clone_rename(P, store):
    cid, oid = _ids(P)
    T = P.Transaction
    dst = P.GHObject(1, "obj-clone", shard=0)
    ren = P.GHObject(1, "obj-renamed", shard=0)
    _run(store.queue_transactions(T().write(cid, oid, 0, b"data")
                                  .setattr(cid, oid, "a", b"1")))
    _run(store.queue_transactions(T().clone(cid, oid, dst)))
    _run(store.queue_transactions(T().write(cid, oid, 0, b"DATA")))
    out = [store.read(cid, dst), store.getattr(cid, dst, "a")]
    _run(store.queue_transactions(T().rename(cid, dst, ren)))
    return out + [store.exists(cid, ren), store.exists(cid, dst)]


def case_atomic_failure(P, store):
    cid, oid = _ids(P)
    store.fail_next = RuntimeError("injected")
    with pytest.raises(RuntimeError):
        _run(store.queue_transactions(P.Transaction().write(cid, oid, 0,
                                                            b"never")))
    return [store.exists(cid, oid)]


def case_missing(P, store):
    cid, oid = _ids(P)
    with pytest.raises(KeyError):
        store.read(P.CollectionId(9, 9), oid)
    with pytest.raises(KeyError):
        store.read(cid, P.GHObject(1, "ghost"))
    return []


def case_shards_distinct(P, store):
    cid, _ = _ids(P)
    a, b = P.GHObject(1, "x", shard=0), P.GHObject(1, "x", shard=3)
    _run(store.queue_transactions(P.Transaction().write(cid, a, 0, b"s0")
                                  .write(cid, b, 0, b"s3")))
    return [store.read(cid, a), store.read(cid, b),
            [o.key() for o in store.list_objects(cid)]]


def case_rmcoll_requires_empty(P, store):
    cid, oid = _ids(P)
    _run(store.queue_transactions(P.Transaction().write(cid, oid, 0, b"d")))
    with pytest.raises(ValueError):
        _run(store.queue_transactions(
            P.Transaction().remove_collection(cid)))
    return []


CASES = [case_roundtrip, case_sparse, case_zero_truncate_remove,
         case_attrs_omap, case_clone_rename, case_atomic_failure,
         case_missing, case_shards_distinct, case_rmcoll_requires_empty]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_store_case_matches_reference(case):
    results = {}
    for which in ("ref", "port"):
        P = Pkg(which)
        store = _fresh(P)
        results[which] = (case(P, store), state.dump_memstore(store))
    assert results["port"] == results["ref"]


# -- the transaction wire codec ----------------------------------------------

def _tx(P):
    cid, oid = _ids(P)
    other = P.GHObject(2, "b\x00c", snap=4, gen=7, shard=3)
    return (P.Transaction().create_collection(P.CollectionId(3, 0x1f))
            .touch(cid, oid).write(cid, oid, 12, payload(300, 1))
            .zero(cid, oid, 1, 2).truncate(cid, oid, 200)
            .setattr(cid, oid, "hinfo", b"{}").rmattr(cid, oid, "x")
            .omap_setkeys(cid, oid, {"k": b"v", "": b"\xff"})
            .omap_rmkeys(cid, oid, ["a", "b"]).clone(cid, oid, other)
            .rename(cid, other, oid).remove(cid, oid)
            .remove_collection(P.CollectionId(3, 0x1f)))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_txcodec_wire_bytes_match_reference(writer):
    tx = _tx(Pkg(writer))
    enc = j_txcodec.encode_tx if writer == "ref" else txcodec.encode_tx
    wire = enc(tx)
    framed = {"ref": j_codec.encode(wire), "port": codec.encode(wire)}
    assert framed["ref"] == framed["port"]
    # the other package decodes it and re-encodes the same bytes
    if writer == "ref":
        back = txcodec.decode_tx(codec.decode(framed["ref"]))
        again = codec.encode(txcodec.encode_tx(back))
    else:
        back = j_txcodec.decode_tx(j_codec.decode(framed["port"]))
        again = j_codec.encode(j_txcodec.encode_tx(back))
    assert again == framed[writer]
    assert len(back) == len(tx)


def test_txcodec_decoded_ops_apply_like_reference():
    dumps = {}
    wire = j_txcodec.encode_tx(_tx(Pkg("ref")))
    for which, dec in (("ref", j_txcodec.decode_tx),
                       ("port", txcodec.decode_tx)):
        P = Pkg(which)
        store = _fresh(P)
        cid, oid = _ids(P)
        tx = dec(wire)
        tx.ops = tx.ops[1:9]          # write..omap_rmkeys on one object
        _run(store.queue_transactions(tx))
        dumps[which] = state.dump_memstore(store)
    assert dumps["port"] == dumps["ref"]


@pytest.mark.parametrize("value", [
    None, True, False, 0, -1, 1 << 62, 1 << 70, -(1 << 80), 1.5, "sé",
    b"\x00\xff", [1, [2, b"x"]], {"a": 1, "b": [None]}],
    ids=lambda v: type(v).__name__)
def test_msg_codec_matches_reference(value):
    assert codec.encode(value) == j_codec.encode(value)
    assert codec.decode(j_codec.encode(value)) == value


# -- store state --------------------------------------------------------------

def test_dump_round_trip_of_a_reference_store():
    P = Pkg("ref")
    store = _fresh(P)
    cid, oid = _ids(P)
    _run(store.queue_transactions(
        P.Transaction().write(cid, oid, 0, payload(1000, 3))
        .setattr(cid, oid, "version", b"{}")
        .omap_setkeys(cid, oid, {"k": b"v"})
        .touch(cid, P.GHObject(1, "empty", snap=3, gen=9, shard=0))
        .create_collection(P.CollectionId(5, 6))))
    dump = state.dump_memstore(store)
    port = state.memstore_from_dump(dump)
    assert state.dump_memstore(port) == dump
    assert sorted(str(c) for c in port.list_collections()) == \
        sorted(str(c) for c in store.list_collections())


def test_memstore_from_dump_inside_a_running_loop():
    async def run():
        return state.memstore_from_dump({(1, 0, 2): {
            (1, "o", -2, 0xFFFFFFFFFFFFFFFF, 2): (b"ab", {"a": b"1"}, {})}})

    store = _run(run())
    assert state.dump_memstore(store) == {(1, 0, 2): {
        (1, "o", -2, 0xFFFFFFFFFFFFFFFF, 2): (b"ab", {"a": b"1"}, {})}}


# -- the PG log a logged backend writes ---------------------------------------

async def sc_logged_backend(P):
    """Strict (logged) mode: every shard mutation carries a PG log
    entry in the same transaction."""
    log = j_pg_log if P.which == "ref" else pg_log
    seq = [0]

    def hook(oid, op, version, prior, reqid):
        seq[0] += 1
        return log.LogEntry(seq[0], 1, oid, op, version, prior, reqid)

    be = await P.backend(log_hook=hook)
    for store, _ in be._t_stores.values():
        await store.queue_transactions(P.Transaction().create_collection(
            log.meta_cid(1, 0)))
    await be.write("a", payload(3000, 4), reqid="c.1:1")
    await be.write("a", b"Q" * 10, offset=5, reqid="c.1:2")
    await be.set_attr("a", "user.k", b"v", reqid="c.1:3")
    await be.remove("a", reqid="c.1:4")
    logs = [{s: e.to_wire() for s, e in log.read_log(store, 1, 0)[0]
             .items()} for store, _ in be._t_stores.values()]
    assert all(len(entries) == 4 for entries in logs)
    return {"logs": logs, "stores": snapshot(be)}


def test_logged_backend_writes_the_reference_pg_log():
    ref = _run(sc_logged_backend(Pkg("ref")))
    port = _run(sc_logged_backend(Pkg("port")))
    assert port == ref
