"""The port's S3 gateway object layer against the JAX package's.

Each scenario of the reference's gateway tests runs twice in one process:
once as written, on the JAX package, and once as its *twin*, the same test
source with every ``ceph_tpu`` import named as ``ceph_tpu_torch`` (the
port's OSD daemons and dev clusters on ``device="cpu"``).  Every assertion
of the reference test holds on both packages, and a transcript of what the
scenario saw must be equal across them:

- every top-level call into ``RGWLite``, ``RGWUsers`` and
  ``ZonePlacement`` (a call made by another of their methods is not
  recorded) with its result, or the error type and S3 error code it
  raised: object bodies (sha256 and length), ETags, listings, lifecycle
  and GC results, tags, locks, versions;
- every HTTP exchange of the test's own client: status, headers, body;
- at each cluster's teardown, every RADOS object of every pool: its name,
  data (sha256 and length), xattrs and omap (the bucket indexes, heads,
  manifests, GC and lifecycle queues, the cold pool's objects).

Ids that ``secrets`` mints (access keys, upload ids, the random half of
version ids, GC tags, KMS keys and nonces, image, group and snapshot ids,
lock cookies, the rbd tool's bench offsets) come from one seeded stream
per calling module, reset before each run, so they are equal byte for
byte.  The tools' runs are recorded with their arguments, return codes
and standard output, and the calls of background loops (sync agents,
mirrors, lock renewals) are not recorded.
Times are the wall clock's: epoch seconds, HTTP and ISO dates and the
microsecond prefix of a version id are compared by shape only.  Calls are
kept in the order they started, so concurrent requests compare by what
each was asked.

This file holds the object-layer scenarios (tests/test_rgw_{versioning,
reshard_gc,tagging,tiering,depth}.py, tests/test_object_lock.py and the
gateway cases of tests/test_services.py, test_flags_multipart.py and
test_full_try.py) and the machinery the other gateway files share; a
last test carries gateway state written by one package's ``RGWLite`` to
the other's, both ways.
"""

import argparse
import ast
import asyncio
import contextlib
import contextvars
import functools
import hashlib
import importlib
import inspect
import pathlib
import pkgutil
import random
import re
import secrets
import sys
import time
import types
import zlib

import pytest

from tests._deps import requires_cryptography

TESTS = pathlib.Path(__file__).resolve().parent
REF, PORT = "ceph_tpu", "ceph_tpu_torch"
ROOTS = (REF, PORT)
HEARTBEAT_GRACE = 3.0

# -- twins: a reference test module with its imports named as a package ------


class _OnCPU(functools.partial):
    """A class called with ``device="cpu"``, its attributes its own."""

    def __getattr__(self, name):
        return getattr(self.func, name)


def _cpu(obj):
    """The port's daemons, dev clusters and realms take ``device=``; the
    tests run them on the CPU."""
    return _OnCPU(obj, device="cpu")


# TCP twins listen on ports of their own: a dev cluster's fixed
# ``base_port`` moves by this much in each package's twin, away from the
# reference test itself (which may run at the same time in another worker)
# and from the other package's twin.
PORT_SHIFT = {REF: 2000, PORT: 2500}
ON_DEVICE = ("DevCluster", "OSDDaemon", "MultisiteRealm")


class _Rename(ast.NodeTransformer):
    """Name the reference's imports as ``root``'s, bind ``tests.test_*``
    names from the twin of that module, follow each import of
    ``DevCluster``/``OSDDaemon``/``MultisiteRealm`` with ``__device__``
    (the port's CPU partial, the identity for the reference), and shift a
    literal ``base_port=`` by ``PORT_SHIFT``."""

    def __init__(self, root):
        self.root = root
        self.depth = 0

    def visit_Call(self, node):
        self.generic_visit(node)
        for kw in node.keywords:
            if kw.arg == "base_port" and isinstance(kw.value, ast.Constant):
                kw.value = ast.Constant(kw.value.value
                                        + PORT_SHIFT[self.root])
        return node

    def _nested(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1
        return node

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _nested

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod.startswith("tests.test_"):
            return [ast.parse(
                f"{a.asname or a.name} = __twin__({mod[6:]!r}).{a.name}"
            ).body[0] for a in node.names]
        if mod != REF and not mod.startswith(REF + "."):
            return node
        node.module = self.root + mod[len(REF):]
        out = []
        for a in node.names:
            bound = a.asname or a.name
            one = ast.ImportFrom(module=node.module, names=[a], level=0)
            if self.depth == 0:
                # a top-level name the package lacks (test_services' RBD)
                # stays unbound: a scenario that needs it fails by name
                one = ast.parse("try:\n    pass\nexcept ImportError:\n"
                                "    pass").body[0]
                one.body = [ast.ImportFrom(module=node.module, names=[a],
                                           level=0)]
            out.append(one)
            if a.name in ON_DEVICE:
                out.append(ast.parse(
                    f"{bound} = __device__({bound})").body[0])
        return out


_TWINS: dict = {}


def twin(ref: str, root: str) -> types.ModuleType:
    """tests/<ref>.py as a module of package ``root``."""
    key = (ref, root)
    if key not in _TWINS:
        tree = _Rename(root).visit(ast.parse((TESTS / f"{ref}.py")
                                             .read_text()))
        ast.fix_missing_locations(tree)
        name = f"_twin_{root}_{ref}"
        mod = types.ModuleType(name)
        mod.__file__ = str(TESTS / f"{ref}.py")
        mod.__dict__.update(
            __twin__=lambda r: twin(r, root),
            __device__=_cpu if root == PORT else (lambda x: x))
        sys.modules[name] = mod
        exec(compile(tree, mod.__file__, "exec"), mod.__dict__)
        _instrument_twin(mod)
        _TWINS[key] = mod
    return _TWINS[key]


def scenarios(ref: str, names=None):
    """``pytest.param`` of each ``test_*`` function of tests/<ref>.py (or
    of ``names``), with the reference's cryptography gate."""
    tree = ast.parse((TESTS / f"{ref}.py").read_text())
    gated_module = any(
        isinstance(n, ast.Assign) and any(
            getattr(t, "id", "") == "pytestmark" for t in n.targets)
        for n in tree.body)
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        if names is not None and fn.name not in names:
            continue
        gated = gated_module or any(
            getattr(d, "id", "") == "requires_cryptography"
            for d in fn.decorator_list)
        out.append(pytest.param(ref, fn.name, id=f"{ref}::{fn.name}",
                                marks=[requires_cryptography] if gated
                                else []))
    assert names is None or len(out) == len(names), (ref, names)
    return out


# -- the transcript ----------------------------------------------------------

_TIME_PATTERNS = [
    (re.compile(r"(Mon|Tue|Wed|Thu|Fri|Sat|Sun), \d\d [A-Z][a-z]{2} "
                r"\d{4} \d\d:\d\d:\d\d GMT"), "<http-date>"),
    (re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z"), "<iso-date>"),
    (re.compile(r"\d{8}T\d{6}Z"), "<amz-date>"),
    (re.compile(r"(?<![0-9])\d{8}(?=/[a-z0-9-]+/s3/aws4_request)"),
     "<scope-date>"),
    # a version id's microsecond clock (f"{int(time.time() * 1e6):016x}")
    (re.compile(r"(?<![0-9a-f])000[0-9a-f]{13}(?=[0-9a-f]{8})"),
     "<us-hex>"),
    # a port the system chose (listeners on port 0)
    (re.compile(r"(?<=127\.0\.0\.1:)\d+"), "<port>"),
    # what a benchmark measured ("seconds": 0.041, "iops": 388.5, ...)
    (re.compile(r'("(?:seconds|iops|MiB_per_s|lat_p50_ms|lat_p99_ms)": )'
                r'[0-9.e+-]+'), r"\1<measured>"),
    # a client instance's messenger nonce ("client.admin:<nonce>")
    (re.compile(r"(?<=\bclient\.)([\w.-]+):\d+"), r"\1:<nonce>"),
    # epoch seconds, plain or zero-padded (GC queue keys)
    (re.compile(r"(?<![0-9A-Za-z.])0*1[5-9]\d{8}(\.\d+)?(e[+-]?\d+)?"
                r"(?![0-9A-Za-z])"), "<t>"),
]


_TMP: list = [None]


def norm_text(s: str) -> str:
    s = s.replace("\\u0000", "\x00")      # JSON's escape of the NUL
    if _TMP[0]:
        s = s.replace(_TMP[0], "<tmp>")
    for pat, rep in _TIME_PATTERNS:
        s = pat.sub(rep, s)
    return s


def norm(v):
    """A value as the transcript keeps it: times by shape, bytes that are
    not text by sha256 and length, everything else exactly."""
    if isinstance(v, bool) or v is None or isinstance(v, int):
        return v
    if isinstance(v, float):
        return "<t>" if 1.5e9 <= v <= 2e10 else v
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        if b[:1] in (b"<", b"{", b"[") or b == b"":
            try:
                return ("text", norm_text(b.decode()))
            except UnicodeDecodeError:
                pass
        return ("bytes", len(b), hashlib.sha256(b).hexdigest())
    if isinstance(v, str):
        return norm_text(v)
    if isinstance(v, dict):
        return [(norm(k), norm(x)) for k, x in v.items()]
    if isinstance(v, (list, tuple, set, frozenset)):
        items = [norm(x) for x in v]
        return sorted(items, key=repr) if isinstance(v, (set, frozenset)) \
            else items
    return ("obj", type(v).__name__)


def describe(e: BaseException):
    return ("raise", type(e).__name__, norm(vars(e)), norm_text(str(e)))


class Transcript:
    """What one run saw, kept in the order each call started; ``keep`` is
    how the pool dump keeps an object's data, xattrs and omap."""

    def __init__(self, keep=norm):
        self.entries: list = []
        self.keep = keep

    def open(self, what):
        self.entries.append([what, "<pending>"])
        return len(self.entries) - 1

    def close(self, slot, result):
        self.entries[slot][1] = result


_CURRENT: list = [None]
_INNER = contextvars.ContextVar("rgw_twin_inner", default=False)


@contextlib.contextmanager
def _top_level(what):
    """Record one call under way as ``what`` unless another recorded call
    made it (or nothing records): yields the callable that records its
    result, or None."""
    rec = _CURRENT[0]
    if rec is None or _INNER.get():
        yield None
        return
    slot = rec.open(what)
    token = _INNER.set(True)
    try:
        yield lambda out: rec.close(slot, ("ok", norm(out)))
    except BaseException as e:
        rec.close(slot, describe(e))
        raise
    finally:
        _INNER.reset(token)


# Results that name what the system chose: a front end's listening port.
SHAPED = {"SwiftFrontend.start": lambda out: (out[0], "<port>")}


def _recorded(what, fn):
    """``fn`` (a function or a coroutine function) recorded as ``what``."""
    shape = SHAPED.get(what, lambda out: out)
    if inspect.iscoroutinefunction(fn):
        @functools.wraps(fn)
        async def call(*a, **kw):
            with _top_level(what) as done:
                out = await fn(*a, **kw)
                if done:
                    done(shape(out))
                return out
    else:
        @functools.wraps(fn)
        def call(*a, **kw):
            with _top_level(what) as done:
                out = fn(*a, **kw)
                if done:
                    done(shape(out))
                return out
    return call


async def dump_pools(rados):
    """Every RADOS object of every pool: name, data, xattrs and omap."""
    rec = _CURRENT[0]
    if rec is None:
        return
    out = []
    token = _INNER.set(True)
    try:
        for pool in sorted(await rados.list_pools()):
            io = await rados.open_ioctx(pool)
            try:
                oids = await io.list_objects()
            except Exception as e:       # a cephx cluster refuses pgls
                out.append((pool, describe(e)))
                continue
            for oid in sorted(oids):
                try:
                    omap = rec.keep(await io.get_omap(oid))
                except Exception as e:       # an EC pool keeps no omap
                    omap = describe(e)
                size = (await io.stat(oid))["size"]
                out.append((pool, norm(oid),
                            rec.keep(await io.read(oid, size)),
                            rec.keep(await io.get_xattrs(oid)), omap))
    finally:
        _INNER.reset(token)
    rec.close(rec.open("pools"), out)


def _instrument_twin(mod):
    """Record the test's own HTTP exchanges and dump the pools at each
    ``stop_cluster``."""
    cli = vars(mod).get("S3HttpClient")
    if cli is not None and "request" in vars(cli):
        cli.request = _recorded("http", cli.request)
    for name in ("_raw", "_http"):
        fn = vars(mod).get(name)
        if inspect.iscoroutinefunction(fn):
            setattr(mod, name, _recorded(name, fn))
    if mod.__name__.endswith("_test_services"):
        stop, conf = mod.stop_cluster, mod.fast_conf

        async def stop_cluster(mon, osds, rados):
            # a client of its own: some scenarios shut theirs down first
            own = mod.Rados(mon.monmap, conf())
            await own.connect()
            try:
                await dump_pools(own)
            finally:
                await own.shutdown()
            await stop(mon, osds, rados)

        def fast_conf():
            # the port's daemon tests' heartbeat grace: under six test
            # workers a first EC encode can hold a loop past 1 s, and
            # live OSDs would be marked down in either package
            c = conf()
            c.set("osd_heartbeat_grace", HEARTBEAT_GRACE)
            return c

        mod.stop_cluster, mod.fast_conf = stop_cluster, fast_conf


class _SeededSecrets:
    """``secrets.token_*`` and ``secrets.SystemRandom`` for the gateway's,
    block images' and CLIs' modules and the scenarios themselves from one
    seeded stream per calling module (the package prefix and a twin's
    prefix taken off its name); every other caller (the mon's tickets,
    trace ids) keeps the system's randomness."""

    SEEDED = (".services.rgw", ".services.rgw_http", ".services.rgw_zone",
              ".services.kms", ".services.rbd", ".cli", ".rbd_tool",
              ".mds.daemon", ".client.fs", "_twin_")

    def __init__(self):
        self.streams: dict = {}
        self.token_bytes_sys = secrets.token_bytes
        self.randbits_sys = secrets.randbits
        self.system_random_sys = secrets.SystemRandom

    def _rng(self):
        name = sys._getframe(2).f_globals.get("__name__", "")
        for root in (PORT, REF):
            if name.startswith(root + "."):
                name = name[len(root):]
                break
            if name.startswith(f"_twin_{root}_"):
                name = "_twin_" + name[len(f"_twin_{root}_"):]
                break
        if not name.startswith(self.SEEDED):
            return None
        if name not in self.streams:
            self.streams[name] = random.Random(zlib.crc32(name.encode()))
        return self.streams[name]

    def token_bytes(self, n=32):
        rng = self._rng()
        return self.token_bytes_sys(n) if rng is None else rng.randbytes(n)

    def token_hex(self, n=32):
        rng = self._rng()
        return (self.token_bytes_sys(n) if rng is None
                else rng.randbytes(n)).hex()

    def randbits(self, k):
        """``secrets.randbits``: a CephFS client's tid space."""
        rng = self._rng()
        return self.randbits_sys(k) if rng is None else rng.getrandbits(k)

    def system_random(self):
        """``secrets.SystemRandom()``: a generator seeded from the
        caller's stream (the rbd tool's bench offsets)."""
        rng = self._rng()
        return self.system_random_sys() if rng is None else \
            random.Random(rng.getrandbits(64))


GATEWAY = ("rgw", "rgw_zone", "rgw_push", "kms", "iam", "rgw_sync",
           "swift", "rgw_file", "rbd", "rbd_journal", "rbd_group",
           "rbd_mirror", "rbd_pwl", "volumes", "../client.object_cacher",
           "../client.fs")

# The loops a service runs in the background (the mgr's report cycle,
# which serves its modules: RBD support's trash purge), and the callbacks
# a watch or notify runs: calls they make follow the clock, so none is
# recorded.
BACKGROUND = (("mgr", "Mgr", "report"),
              ("rgw_sync", "RGWSyncAgent", "_run"),
              ("rgw_zone", "SyncOrchestrator", "_run"),
              ("rbd_mirror", "RBDMirror", "_run"),
              ("rbd_mirror", "JournalReplayer", "_run"),
              ("rbd", "Image", "_lock_notify"),
              ("rbd", "Image", "_lock_renew_loop"),
              ("rgw", "RGWLite", "_push_loop"))

# The command-line tools: each run through ``main`` or ``_run`` is one
# entry, with its arguments, return code and standard output.
CLIS = ("cli", "rbd_tool", "rgw_admin", "objectstore_tool", "dencoder",
        "tools.monmaptool", "tools.monstore_tool", "tools.osdmaptool",
        "cephfs_journal_tool", "cephfs_data_scan")


def _gateway_callables(root):
    """(owner, name, function) of every public function of the gateway's
    object layer, placement, push endpoints, key management, bucket
    policies, multisite sync, Swift, file view, block images, CephFS
    volumes, the client's object cacher and the CephFS client, and every
    public coroutine method of their classes but a messenger's hooks."""
    for modname in GATEWAY:
        mod = importlib.import_module(
            f"{root}.{modname[3:]}" if modname.startswith("../")
            else f"{root}.services.{modname}")
        for name, obj in list(vars(mod).items()):
            if name.startswith("_") or \
                    getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield mod, name, obj
            elif isinstance(obj, type):
                for attr, fn in list(vars(obj).items()):
                    # a messenger's dispatch hook runs on the messenger's
                    # clock, not the scenario's
                    if not attr.startswith(("_", "ms_")) and \
                            inspect.iscoroutinefunction(fn):
                        yield obj, attr, fn


def _unrecorded(fn):
    """``fn`` (a coroutine function) with nothing it calls recorded."""
    @functools.wraps(fn)
    async def call(*a, **kw):
        token = _INNER.set(True)
        try:
            return await fn(*a, **kw)
        finally:
            _INNER.reset(token)
    return call


class _Tee:
    """A standard output that keeps a copy of what is written to it."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, s):
        self.seen.append(s)
        return self.out.write(s)

    def __getattr__(self, name):
        return getattr(self.out, name)


def _cli_recorded(what, fn):
    """A tool's ``main``/``_run`` recorded with its arguments, return code
    and standard output."""
    def args_of(a):
        return [vars(x) if isinstance(x, argparse.Namespace) else x
                for x in a]

    @contextlib.contextmanager
    def teed(a):
        rec = _CURRENT[0]
        if rec is None or _INNER.get():
            yield None
            return
        slot = rec.open((what, norm(args_of(a))))
        tee, token = _Tee(sys.stdout), _INNER.set(True)
        sys.stdout = tee
        try:
            yield lambda rc: rec.close(slot, ("ok", norm(rc),
                                              norm_text("".join(tee.seen))))
        except BaseException as e:
            rec.close(slot, describe(e))
            raise
        finally:
            sys.stdout = tee.out
            _INNER.reset(token)

    if inspect.iscoroutinefunction(fn):
        @functools.wraps(fn)
        async def call(*a, **kw):
            with teed(a) as done:
                rc = await fn(*a, **kw)
                if done:
                    done(rc)
                return rc
    else:
        @functools.wraps(fn)
        def call(*a, **kw):
            with teed(a) as done:
                rc = fn(*a, **kw)
                if done:
                    done(rc)
                return rc
    return call


@functools.lru_cache(maxsize=None)
def _import_all(root):
    """Every module of package ``root``, imported once per process before
    anything is recorded.  A module first imported while ``run_recorded``'s
    wrappers are in place binds a wrapper for good wherever it imports a
    recorded function by name: the port's ``rgw_http``, first imported by
    a scenario that reached it lazily (``DevCluster.start_rgw`` and the
    load generator's ``S3Backend`` import it on first use), kept
    ``rgw.sse_check``'s, and every later HEAD through the front end
    recorded a call the reference's did not."""
    pkg = importlib.import_module(root)
    for mod in pkgutil.walk_packages(pkg.__path__, root + "."):
        importlib.import_module(mod.name)


def run_recorded(root, fn, monkeypatch, keep=norm, mds_first=False) -> list:
    """Call ``fn`` (a synchronous scenario) with the gateway of package
    ``root`` recorded; returns the transcript (its pool dumps as
    ``Transcript`` says, each taken once the cluster's MDSs have shut down
    where ``mds_first``)."""
    _import_all(root)
    rec = Transcript(keep)
    for owner, name, call in _gateway_callables(root):
        what = f"{owner.__name__.rsplit('.', 1)[-1]}.{name}"
        monkeypatch.setattr(owner, name, _recorded(what, call))
    for modname, cls, meth in BACKGROUND:
        owner = getattr(importlib.import_module(
            f"{root}.services.{modname}"), cls)
        monkeypatch.setattr(owner, meth, _unrecorded(vars(owner)[meth]))
    for modname in CLIS:
        mod = importlib.import_module(f"{root}.{modname}")
        for name in ("main", "_run"):
            if inspect.isfunction(vars(mod).get(name)):
                monkeypatch.setattr(mod, name, _cli_recorded(
                    f"{modname}.{name}", vars(mod)[name]))
    vstart = importlib.import_module(f"{root}.vstart")
    stop = vstart.DevCluster.stop

    async def cluster_stop(self):
        if mds_first:
            for mds in self.mdss.values():
                await mds.shutdown()
            self.mdss.clear()
        if self.mons:
            rados = await self.client()
            try:
                await dump_pools(rados)
            finally:
                await rados.shutdown()
        await stop(self)

    monkeypatch.setattr(vstart.DevCluster, "stop", cluster_stop)
    seeded = _SeededSecrets()
    monkeypatch.setattr(secrets, "token_bytes", seeded.token_bytes)
    monkeypatch.setattr(secrets, "token_hex", seeded.token_hex)
    monkeypatch.setattr(secrets, "randbits", seeded.randbits)
    monkeypatch.setattr(secrets, "SystemRandom", seeded.system_random)
    importlib.import_module(f"{root}.msg").reset_local_namespace()
    _CURRENT[0] = rec
    try:
        fn()
    finally:
        _CURRENT[0] = None
        monkeypatch.undo()
        importlib.import_module(f"{root}.msg").reset_local_namespace()
    return rec.entries


def assert_same_transcript(ref, port):
    for i, (a, b) in enumerate(zip(ref, port)):
        if a != b and a[0] == b[0] == "pools":
            # name the first object that differs, not the whole dump
            a, b = next((x, y) for x, y in zip(a[1] + [None],
                                                b[1] + [None]) if x != y)
        assert a == b, f"entry {i} differs:\n ref  {a!r}\n port {b!r}"
    assert len(ref) == len(port), (len(ref), len(port))


_MINTED = re.compile(r"(?<![0-9a-f])([0-9a-f]{12}|[0-9a-f]{16})(?![0-9a-f])")


def as_set(entries):
    """A transcript whose calls race the wall clock (a rate limit sheds
    some of them): the distinct entries, each pool object and omap entry
    apart, ids minted in call order (12 or 16 hex digits: tags, upload
    ids, GC keys) by shape."""

    def items(e):
        if e[0] != "pools":
            yield e
            return
        for pool, oid, data, xattrs, omap in e[1]:
            yield pool, oid, data, xattrs
            yield from ((pool, oid, kv) for kv in omap) \
                if isinstance(omap, list) else [(pool, oid, omap)]

    return sorted({_MINTED.sub("<minted>", repr(i).replace("\\x00", "|"))
                   for e in entries for i in items(e)})


def _with_fixtures(fn, root, fixtures):
    """``fn`` with the fixtures it names: ``tmp_path`` a directory of the
    package's own under the test's (named ``<tmp>`` in the transcript),
    ``capsys`` the test's, ``monkeypatch`` a fresh one undone after the
    run, any other name (a parameter of the reference test) from
    ``fixtures``."""
    names = list(inspect.signature(fn).parameters)
    if not names:
        return fn

    def call():
        kw, mp = {}, None
        for n in names:
            if n == "tmp_path":
                kw[n] = fixtures["tmp_path"] / root
                kw[n].mkdir()
                _TMP[0] = str(kw[n])
            elif n == "monkeypatch":
                kw[n] = mp = pytest.MonkeyPatch()
            else:
                kw[n] = fixtures[n]
        if "capsys" in kw:
            kw["capsys"].readouterr()
        try:
            fn(**kw)
        finally:
            _TMP[0] = None
            if mp is not None:
                mp.undo()

    return call


# The objects a background sync agent writes as it goes: the datalog a
# zone keeps of what was applied to it and the agent's markers into its
# source's datalog hold the agent's history, which the clock decides (an
# object put and deleted before the agent looked is never replayed at
# all; the scenario stops the agent once the objects agree, whichever
# pass it was in).
AGENT_HISTORY = re.compile(r"rgw\.bucket\.log\.|rgw\.sync\.status")


def polls_collapsed(entries):
    """A transcript whose scenario polls until a background loop has
    caught up: each run of consecutive calls of one name (the polls) kept
    as its last call, the one that saw the state the scenario waited
    for, and the pools without ``AGENT_HISTORY`` objects."""
    out = []
    for e in entries:
        if e[0] == "pools":
            e = ["pools", [o for o in e[1]
                           if not AGENT_HISTORY.match(o[1])]]
        if out and e[0] != "pools" and out[-1][0] == e[0]:
            out[-1] = e
        else:
            out.append(e)
    return out


def run_twin_scenario(ref, name, monkeypatch, timed=False, polled=False,
                      compare=True, keep=norm, mds_first=False,
                      **fixtures):
    """The reference test ``ref::name`` on both packages, transcripts
    equal (as sets where ``timed``, with its polls collapsed where
    ``polled``; not compared where not ``compare``: a unit scenario that
    calls nothing recorded, or one whose every output follows the clock,
    holds its own assertions on both packages); ``keep`` as
    ``Transcript``'s, ``mds_first`` as ``run_recorded``'s; ``fixtures``
    hands the test's ``tmp_path``, ``capsys`` and parameters on to a
    scenario that takes them."""
    out = {}
    for root in ROOTS:
        fn = _with_fixtures(getattr(twin(ref, root), name), root, fixtures)
        out[root] = run_recorded(root, fn, monkeypatch, keep, mds_first)
        if polled:
            out[root] = polls_collapsed(out[root])
    if not compare:
        return out[REF]
    assert out[REF], "the scenario recorded nothing"
    if timed:
        assert as_set(out[REF]) == as_set(out[PORT])
    else:
        assert_same_transcript(out[REF], out[PORT])
    return out[REF]


# -- the object layer --------------------------------------------------------

TWINNED = ("test_services", "test_rgw_http", "test_rgw_cors",
           "test_rgw_depth", "test_rgw_presign", "test_rgw_push",
           "test_rgw_reshard_gc", "test_rgw_tagging", "test_rgw_tiering",
           "test_rgw_versioning", "test_iam", "test_sse_kms",
           "test_vault_kms", "test_object_lock", "test_flags_multipart",
           "test_full_try", "test_qos", "test_loadgen", "test_dashboard")


@pytest.mark.parametrize("ref", TWINNED)
def test_twin_names_only_the_port(ref):
    """Every module, class and function a port twin binds from a package
    is the port's, and its dev clusters and OSD daemons run on the CPU;
    the reference twin binds the JAX package's."""
    for root in ROOTS:
        mod = twin(ref, root)
        for name, obj in vars(mod).items():
            if isinstance(obj, functools.partial):
                assert root == PORT and obj.keywords == {"device": "cpu"}
                obj = obj.func
            owner = obj.__name__ if isinstance(obj, types.ModuleType) \
                else getattr(obj, "__module__", None) or ""
            if owner.split(".")[0] in ROOTS:
                assert owner.split(".")[0] == root, (ref, name, owner)

OBJECT_LAYER = [
    *scenarios("test_rgw_versioning"),
    *scenarios("test_rgw_reshard_gc"),
    *scenarios("test_rgw_tagging", ["test_tagging_store_and_lifecycle",
                                    "test_tagging_versioned_and_markers"]),
    *scenarios("test_rgw_tiering"),
    *scenarios("test_rgw_depth"),
    *scenarios("test_object_lock"),
    *scenarios("test_services", ["test_rgw_bucket_object_lifecycle",
                                 "test_rgw_overwrite_cleans_old_data"]),
    *scenarios("test_flags_multipart", ["test_multipart_upload_lifecycle"]),
    *scenarios("test_full_try", ["test_s3_delete_from_full_pool"]),
]


@pytest.mark.parametrize("ref,name", OBJECT_LAYER)
def test_object_layer_scenario_equal_across_packages(ref, name,
                                                     monkeypatch):
    run_twin_scenario(ref, name, monkeypatch)


# -- gateway state carried across the packages -------------------------------

async def _write_bucket(rgw, zone, io, bucket, seed):
    """A bucket written through one package's gateway: a plain object, a
    striped one, a multipart one, a versioned key and an object moved to
    the COLD class by a lifecycle transition.  Returns what each key
    holds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gw = rgw.RGWLite(io)
    if bucket.endswith("jax"):
        await zone.ZonePlacement(io).add(
            storage_class="COLD", data_pool="rgw.cold",
            ec_profile="rgw_cold_k2m1", create_pool=True)
    await gw.create_bucket(bucket)
    want = {"plain": rng.bytes(3000),
            "striped": rng.bytes(rgw.STRIPE_THRESHOLD + 4099),
            "logs/cold": rng.bytes(70000)}
    for key, data in want.items():
        await gw.put_object(bucket, key, data, tags={"k": key})
    uid = await gw.initiate_multipart(bucket, "multi")
    parts = [rng.bytes(n) for n in (200000, 150001)]
    etags = [(i + 1, (await gw.upload_part(bucket, "multi", uid, i + 1,
                                           p))["etag"])
             for i, p in enumerate(parts)]
    await gw.complete_multipart(bucket, "multi", uid, etags)
    want["multi"] = b"".join(parts)
    await gw.put_lifecycle(bucket, [
        {"id": "tier", "prefix": "logs/", "status": "Enabled",
         "transition_seconds": 1, "transition_class": "COLD"}])
    moved = await gw.lc_process(now=time.time() + 5)
    assert moved == {bucket: ["logs/cold->COLD"]}, moved
    return want


async def _read_bucket(rgw, io, bucket):
    """What the other package's gateway reads back: every key's body,
    ETag, size, storage class and tags, the listing and the rules."""
    gw = rgw.RGWLite(io)
    listing = await gw.list_objects(bucket)
    out = {"keys": [(c["key"], c["etag"], c["size"],
                     c.get("storage_class", "STANDARD"))
                    for c in listing["contents"]],
           "rules": await gw.get_lifecycle(bucket), "objects": {}}
    for key, *_ in out["keys"]:
        got = await gw.get_object(bucket, key)
        head = await gw.head_object(bucket, key)
        out["objects"][key] = (got["data"], got["etag"],
                               head.get("storage_class", "STANDARD"),
                               head.get("pool"), head.get("tags"))
    return out


def test_gateway_state_reads_back_across_packages():
    """One cluster over TCP (a JAX mon, port osd.0 and osd.2 on the CPU,
    JAX osd.1 and osd.3): the JAX package's ``RGWLite`` writes a bucket,
    the port's reads it back exactly, and the other way round: bodies,
    ETags, storage classes (the transitioned object in the k=2 m=1 cold
    pool), tags, listings and lifecycle rules.  The writer's own read is
    the reference for the reader's."""
    import ceph_tpu.services.rgw as jax_rgw
    import ceph_tpu.services.rgw_zone as jax_zone
    import ceph_tpu_torch.services.rgw as port_rgw
    import ceph_tpu_torch.services.rgw_zone as port_zone
    from test_torch_cluster_mixed import OVERRIDES, _osd_factory, _stop
    from test_torch_mon import free_ports

    import ceph_tpu.client as jax_client
    import ceph_tpu.common.config as jax_config
    import ceph_tpu.mon as jax_mon
    import ceph_tpu_torch.client as port_client
    import ceph_tpu_torch.common.config as port_config

    async def run():
        ports = free_ports(5)
        monmap = {"a": f"tcp://127.0.0.1:{ports[0]}"}
        mon = jax_mon.Monitor("a", monmap, jax_config.ConfigProxy(
            overrides=dict(OVERRIDES)))
        await mon.start()
        osds = []
        for i in range(4):
            make, conf = _osd_factory(i, True)
            osd = make(i, monmap, conf(overrides=dict(OVERRIDES)),
                       host=f"h{i}", addr=f"tcp://127.0.0.1:{ports[1 + i]}")
            await osd.start()
            osds.append(osd)
        clients = []
        try:
            for pkg, conf, name in (
                    (jax_client, jax_config, "client.jax"),
                    (port_client, port_config, "client.port")):
                rados = pkg.Rados(monmap, conf.ConfigProxy(
                    overrides=dict(OVERRIDES)), name=name)
                await rados.connect()
                clients.append(rados)
            await clients[0].pool_create("rgw", pg_num=8)
            jax_io, port_io = [await c.open_ioctx("rgw") for c in clients]
            sides = {"jax": (jax_rgw, jax_zone, jax_io),
                     "port": (port_rgw, port_zone, port_io)}
            for writer, reader in (("jax", "port"), ("port", "jax")):
                rgw, zone, io = sides[writer]
                bucket = f"from-{writer}"
                want = await _write_bucket(rgw, zone, io, bucket,
                                           seed=len(writer))
                own = await _read_bucket(rgw, io, bucket)
                other = await _read_bucket(sides[reader][0],
                                           sides[reader][2], bucket)
                assert other == own
                assert {k: v[0] for k, v in other["objects"].items()} \
                    == want
                assert other["objects"]["logs/cold"][2:4] == \
                    ("COLD", "rgw.cold")
                assert other["objects"]["multi"][1].endswith("-2")
        finally:
            for c in clients:
                await c.shutdown()
            for osd in osds:
                await _stop(osd)
            await mon.shutdown()

    asyncio.run(run())
