"""The port's host substrate against the JAX package's, on the CPU.

The messenger, the throttle, the backoff, the admin socket and the config
registry: every scenario of tests/test_msgr.py and the non-cluster ones of
tests/test_admin_throttle.py and tests/test_common.py's config block runs
once per package.  Then the packages against each other: the same codec
and frame bytes on the wire, a port messenger and a JAX-package messenger
exchanging messages over loopback TCP in both directions, the same option
schema, and the same backoff schedule from the same seed.
"""

import asyncio
import importlib

import pytest

PKG_NAMES = ("ceph_tpu", "ceph_tpu_torch")


class Pkg:
    """One package's substrate surface."""

    def __init__(self, root: str):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.msg = mod("msg")
        self.messenger = mod("msg.messenger")
        self.Message, self.Messenger, self.Policy = (
            self.msg.Message, self.msg.Messenger, self.msg.Policy)
        self.config = mod("common.config")
        self.throttle = mod("common.throttle")
        self.backoff = mod("common.backoff")
        self.admin = mod("common.admin_socket")


PKGS = {name: Pkg(name) for name in PKG_NAMES}


@pytest.fixture(params=PKG_NAMES)
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean_local():
    for p in PKGS.values():
        p.msg.reset_local_namespace()
    yield
    for p in PKGS.values():
        p.msg.reset_local_namespace()


# -- codec ---------------------------------------------------------------------

VALUES = [None, True, False, 0, -1, 2**40, -(2**70), 3.5, "héllo", b"\x00\xff",
          [], [1, "a", None], {"k": [1, {"n": b"x"}]}, {"": ""},
          {"big": 2**100, "neg": -(2**100)}]


@pytest.mark.parametrize("value", VALUES, ids=[repr(v)[:24] for v in VALUES])
def test_codec_roundtrip_and_wire_bytes(value):
    j, t = PKGS["ceph_tpu"].msg, PKGS["ceph_tpu_torch"].msg
    wire = t.encode(value)
    assert wire == j.encode(value)
    assert t.decode(wire) == j.decode(wire) == value


def test_codec_rejects_trailing_and_bad_tag(pkg):
    with pytest.raises(ValueError):
        pkg.msg.decode(pkg.msg.encode(1) + b"x")
    with pytest.raises(ValueError):
        pkg.msg.decode(b"\x99")
    with pytest.raises(TypeError):
        pkg.msg.encode(object())


# -- messenger (tests/test_msgr.py) -------------------------------------------

class Collector:
    def __init__(self):
        self.messages = []
        self.resets = []

    async def ms_dispatch(self, conn, msg):
        self.messages.append((conn.peer_name, msg))

    def ms_handle_reset(self, conn):
        self.resets.append(conn.peer_name)

    def ms_handle_connect(self, conn):
        pass


async def _wait_for(predicate, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.005)


async def _make_pair(pa, pb, scheme="local", conf_b=None):
    a, b = pa.Messenger("mon.a"), pb.Messenger("osd.0", conf_b)
    ca, cb = Collector(), Collector()
    a.set_dispatcher(ca)
    b.set_dispatcher(cb)
    if scheme == "local":
        await a.bind("local://a")
        await b.bind("local://b")
    else:
        await a.bind("tcp://127.0.0.1:0")
        await b.bind("tcp://127.0.0.1:0")
    return a, b, ca, cb


async def _roundtrip(pa, pb, scheme):
    """b sends a ping to a; a replies over the accepted connection."""
    a, b, ca, cb = await _make_pair(pa, pb, scheme)
    await b.send_to(str(a.my_addr), pb.Message("ping", {"x": 1}))
    await _wait_for(lambda: ca.messages)
    peer, msg = ca.messages[0]
    assert peer == "osd.0" and msg.type == "ping" and msg.data == {"x": 1}
    conn = next(c for (name, _nonce), c in a._accepted.items()
                if name == "osd.0")
    conn.send_message(pa.Message("pong", {"y": b"\x01\x02"}))
    await _wait_for(lambda: cb.messages)
    assert cb.messages[0][1].data == {"y": b"\x01\x02"}
    await a.shutdown()
    await b.shutdown()


@pytest.mark.parametrize("scheme", ["local", "tcp"])
def test_send_receive_roundtrip(pkg, scheme):
    asyncio.run(_roundtrip(pkg, pkg, scheme))


def test_ordered_delivery_many(pkg):
    async def run():
        a, b, ca, _ = await _make_pair(pkg, pkg)
        conn = await b.connect(str(a.my_addr))
        for i in range(200):
            conn.send_message(pkg.Message("n", {"i": i}))
        await _wait_for(lambda: len(ca.messages) == 200)
        assert [m.data["i"] for _, m in ca.messages] == list(range(200))
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


def test_lossless_replay_under_injected_failures(pkg):
    async def run():
        conf = pkg.config.ConfigProxy(
            overrides={"ms_inject_socket_failures": 20})
        a, b, ca, _ = await _make_pair(pkg, pkg, conf_b=conf)
        conn = await b.connect(str(a.my_addr), peer_name="mon.a")
        assert not conn.policy.lossy
        for i in range(500):
            conn.send_message(pkg.Message("n", {"i": i}))
            if i % 50 == 0:
                await asyncio.sleep(0.01)
        await _wait_for(lambda: len(ca.messages) == 500, timeout=30)
        assert [m.data["i"] for _, m in ca.messages] == list(range(500))
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


def test_lossy_reset_notifies_dispatcher(pkg):
    async def run():
        a, b, _, cb = await _make_pair(pkg, pkg)
        b.set_policy("mon", pkg.Policy.lossy_client())
        conn = await b.connect(str(a.my_addr), peer_name="mon.a")
        assert conn.policy.lossy
        conn.send_message(pkg.Message("hello", {}))
        await _wait_for(lambda: any(name == "osd.0"
                                    for name, _ in a._accepted))
        next(c for (name, _nonce), c in a._accepted.items()
             if name == "osd.0").mark_down()
        await _wait_for(lambda: cb.resets)
        assert cb.resets == ["mon.a"] and conn.is_closed
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


def test_lossy_connect_to_missing_listener_raises(pkg):
    async def run():
        b = pkg.Messenger("client.1")
        b.set_policy("mon", pkg.Policy.lossy_client())
        await b.bind("local://c")
        with pytest.raises(ConnectionError):
            await b.connect("local://nowhere", peer_name="mon.a")
        await b.shutdown()
    asyncio.run(run())


def test_lossless_connect_queues_until_listener_appears(pkg):
    async def run():
        b = pkg.Messenger("osd.1")
        await b.bind("local://b")
        conn = await b.connect("local://late", peer_name="osd.2")
        conn.send_message(pkg.Message("early", {"i": 1}))
        await asyncio.sleep(0.05)
        a = pkg.Messenger("osd.2")
        ca = Collector()
        a.set_dispatcher(ca)
        await a.bind("local://late")
        await _wait_for(lambda: ca.messages, timeout=10)
        assert ca.messages[0][1].type == "early"
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


def test_mark_down_stops_session(pkg):
    async def run():
        a, b, ca, _ = await _make_pair(pkg, pkg)
        conn = await b.connect(str(a.my_addr))
        conn.send_message(pkg.Message("one", {}))
        await _wait_for(lambda: ca.messages)
        conn.mark_down()
        with pytest.raises(ConnectionError):
            conn.send_message(pkg.Message("two", {}))
        conn2 = await b.connect(str(a.my_addr))
        assert conn2 is not conn
        conn2.send_message(pkg.Message("three", {}))
        await _wait_for(lambda: len(ca.messages) >= 2)
        assert ca.messages[-1][1].type == "three"
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


# -- across the packages on the wire ------------------------------------------

@pytest.mark.parametrize("acceptor,dialer", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")],
    ids=["torch_dials_jax", "jax_dials_torch"])
def test_messengers_talk_across_packages(acceptor, dialer):
    """A messenger of one package dials one of the other over loopback
    TCP: handshake, a ping and its reply, then 100 messages in order."""
    pa, pb = PKGS[acceptor], PKGS[dialer]

    async def run():
        await _roundtrip(pa, pb, "tcp")
        a, b, ca, _ = await _make_pair(pa, pb, "tcp")
        conn = await b.connect(str(a.my_addr), peer_name="mon.a")
        for i in range(100):
            conn.send_message(pb.Message("n", {"i": i, "b": bytes([i])}))
        await _wait_for(lambda: len(ca.messages) == 100)
        assert [(m.type, m.data) for _, m in ca.messages] == [
            ("n", {"i": i, "b": bytes([i])}) for i in range(100)]
        await a.shutdown()
        await b.shutdown()
    asyncio.run(run())


async def _wire_capture(p, nonce: int) -> bytes:
    """Every byte a package's messenger (fixed nonce) sends to a raw TCP
    peer that answers its banner with a fixed hello, through three
    messages."""
    received = bytearray()
    got_all = asyncio.Event()
    codec = PKGS["ceph_tpu"].msg
    hello = codec.encode({"entity": "mon.a", "nonce": 7, "in_seq": 0,
                          "connect_seq": 0, "secure": False})
    banner = PKGS["ceph_tpu"].messenger.BANNER

    async def serve(reader, writer):
        writer.write(banner + len(hello).to_bytes(4, "little") + hello)
        await writer.drain()
        while not got_all.is_set():
            chunk = await reader.read(65536)
            if not chunk:
                break
            received.extend(chunk)
            if received.count(b"third") >= 1:
                got_all.set()
        writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    m = p.Messenger("osd.3", nonce=nonce)
    m.set_policy("mon", p.Policy.lossy_client())
    conn = await m.connect(f"tcp://127.0.0.1:{port}", peer_name="mon.a")
    for i, word in enumerate(("first", "second", "third")):
        conn.send_message(p.Message("osd_op", {"seq": i, "w": word,
                                               "blob": b"\x00\xff" * 9}))
    await asyncio.wait_for(got_all.wait(), 5)
    await m.shutdown()
    server.close()
    await server.wait_closed()
    return bytes(received)


def test_same_wire_bytes():
    """The banner, hello and three framed messages of a port messenger
    are byte-identical to a JAX-package messenger's."""
    wires = {name: asyncio.run(_wire_capture(PKGS[name], 0x1234abcd))
             for name in PKG_NAMES}
    assert wires["ceph_tpu"].startswith(PKGS["ceph_tpu"].messenger.BANNER)
    assert len(wires["ceph_tpu"]) > 100
    assert wires["ceph_tpu_torch"] == wires["ceph_tpu"]


# -- throttle and admin socket (tests/test_admin_throttle.py) -----------------

def test_throttle_backpressure_and_fifo(pkg):
    async def run():
        t = pkg.throttle.Throttle("t", 10)
        await t.acquire(8)
        assert t.current == 8
        assert not t.try_acquire(5)
        assert t.try_acquire(2)
        order = []

        async def waiter(tag, units):
            await t.acquire(units)
            order.append(tag)

        w1 = asyncio.create_task(waiter("big", 9))
        await asyncio.sleep(0)
        w2 = asyncio.create_task(waiter("small", 1))
        await asyncio.sleep(0.01)
        assert order == []
        t.release(8)
        t.release(2)
        await asyncio.sleep(0.01)
        assert order[0] == "big"
        t.release(9)
        await asyncio.sleep(0.01)
        assert order == ["big", "small"]
        t.release(1)
        await asyncio.gather(w1, w2)
        d = t.dump()
        assert d["val"] == 0 and d["wait"] == 2
    asyncio.run(run())


def test_throttle_oversized_request_does_not_deadlock(pkg):
    async def run():
        t = pkg.throttle.Throttle("t", 4)
        await t.acquire(3)
        task = asyncio.create_task(t.acquire(100))
        await asyncio.sleep(0.01)
        assert not task.done()
        t.release(3)
        await asyncio.wait_for(task, 1.0)
        assert t.current == 100
        t.release(100)
    asyncio.run(run())


def test_admin_socket_roundtrip(pkg, tmp_path):
    async def run():
        sock = pkg.admin.AdminSocket("osd.7")
        sock.register("perf dump", lambda: {"op": 3}, "counters")

        async def slow(x=1):
            await asyncio.sleep(0)
            return {"doubled": int(x) * 2}

        sock.register("compute", slow, "async handler with args")
        path = await sock.start(str(tmp_path))
        assert path.endswith("osd.7.asok")
        cmd = pkg.admin.admin_command
        assert await cmd(path, "perf dump") == {"op": 3}
        assert await cmd(path, "compute", x=21) == {"doubled": 42}
        helpmap = await cmd(path, "help")
        assert "perf dump" in helpmap and "compute" in helpmap
        assert "error" in await cmd(path, "nope")
        # the other package's client speaks the same protocol
        other = PKGS[PKG_NAMES[1 - PKG_NAMES.index(pkg.root)]]
        assert await other.admin.admin_command(path, "compute", x=4) == \
            {"doubled": 8}
        await sock.stop()
    asyncio.run(run())


# -- backoff -------------------------------------------------------------------

def test_backoff_schedule_matches_reference():
    def schedule(p):
        b = p.backoff.ExpBackoff(base=0.01, cap=0.2, seed=42, name="osd.3")
        out = [b.next_delay() for _ in range(8)]
        b.reset()
        return out + [b.next_delay()]

    ref = schedule(PKGS["ceph_tpu"])
    assert schedule(PKGS["ceph_tpu_torch"]) == ref
    assert all(0.005 <= d < 0.2 for d in ref)
    assert max(ref[:8]) >= 0.1


def test_backoff_sleep_returns_its_delay(pkg):
    async def run():
        b = pkg.backoff.ExpBackoff(base=0.001, cap=0.002, seed=1)
        d = await b.sleep()
        assert 0.0005 <= d < 0.002 and b.attempt == 1
    asyncio.run(run())


# -- config (tests/test_common.py's config block) ------------------------------

def test_config_defaults_and_set(pkg):
    cfg = pkg.config.ConfigProxy()
    assert cfg.get("osd_pool_default_size") == 3
    cfg.set("osd_pool_default_size", "5")
    assert cfg.get("osd_pool_default_size") == 5


def test_config_validation(pkg):
    cfg = pkg.config.ConfigProxy()
    with pytest.raises(ValueError):
        cfg.set("osd_pool_default_size", "zero")
    with pytest.raises(ValueError):
        cfg.set("osd_pool_default_size", 0)
    with pytest.raises(KeyError):
        cfg.set("no_such_option", 1)


def test_config_observers(pkg):
    cfg = pkg.config.ConfigProxy()
    seen = []
    cfg.observe("osd_heartbeat_grace", lambda n, v: seen.append((n, v)))
    cfg.set("osd_heartbeat_grace", 7.5)
    assert seen == [("osd_heartbeat_grace", 7.5)]


def test_config_sources_precedence(pkg, tmp_path, monkeypatch):
    conf = tmp_path / "conf.json"
    conf.write_text('{"cluster": "from-file", "osd_pool_default_size": 4}')
    monkeypatch.setenv("CEPH_TPU_CLUSTER", "from-env")
    cfg = pkg.config.ConfigProxy(conf_file=str(conf))
    assert cfg.get("cluster") == "from-env"
    assert cfg.get("osd_pool_default_size") == 4
    cfg.apply_central({"cluster": "from-mon", "osd_pool_default_size": 6,
                       "unknown_is_skipped": 1})
    assert cfg.get("cluster") == "from-env"
    assert cfg.get("osd_pool_default_size") == 6
    show = cfg.show()
    assert show["cluster"]["source"] == "env"
    assert show["osd_pool_default_size"]["source"] == "mon"
    assert show["osd_heartbeat_grace"]["source"] == "default"


def test_config_register_and_bool_parse(pkg):
    cfg = pkg.config.ConfigProxy()
    cfg.register([pkg.config.Option("my_opt", int, 9, "custom",
                                    pkg.config.Level.DEV)])
    assert cfg.get("my_opt") == 9
    cfg.set("ec_use_pallas", "false")
    assert cfg.get("ec_use_pallas") is False
    cfg.set("ec_use_pallas", "yes")
    assert cfg.get("ec_use_pallas") is True


# The options whose default names a device figure: the HBM roofline is the
# H100's in the port (3.35 TB/s), the TPU v5e's in the JAX package.
DEVICE_DEFAULTS = {"ec_hbm_peak_gibps": (763.0, 3120.0)}


def test_config_schema_matches_reference():
    """Every option of the JAX package exists in the port with the same
    type, level, limits, runtime flag and default (the daemon reads them
    by name), but for the device figures above."""
    j = PKGS["ceph_tpu"].config.ConfigProxy().schema()
    t = PKGS["ceph_tpu_torch"].config.ConfigProxy().schema()
    assert list(t) == list(j) and len(j) > 100
    for name, jo in j.items():
        to = t[name]
        assert (to.type, to.level.value, to.min, to.max, to.runtime,
                to.enum_values) == (jo.type, jo.level.value, jo.min, jo.max,
                                    jo.runtime, jo.enum_values), name
        want = DEVICE_DEFAULTS.get(name, (jo.default, jo.default))
        assert (jo.default, to.default) == want, name
