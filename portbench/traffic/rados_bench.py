"""rados bench over librados (``IoCtx.write_full`` / ``IoCtx.read``):
closed-loop clients, each waiting for its reply.

Parameters (workloads/<cell>.json ``params``):

- ``pool``: the pool of the configuration the ops go to;
- ``mode``: ``write`` (rados bench write) or ``rand`` (rados bench rand:
  reads of preloaded objects, uniformly at random);
- ``clients``: concurrent clients (rados bench -t);
- ``object_bytes``: the size of every object (rados bench -b);
- ``names``: write mode: names cycle over this many objects, client c
  owning names c, c + clients, ..., so no two ops on a name overlap;
- ``preload_objects``: objects written during set-up (rand mode reads
  them);
- ``down_osds``: OSDs stopped and marked down (not out) during set-up;
  the window then serves degraded;
- ``warmup_ops``: ops each client runs before the window;
- ``check_objects``: objects whose stored shards the reference judges;
- ``check_reads``: rand mode: read replies kept and judged.

The plan (names, object bodies, which reads) comes from the seed;
bodies are distinct per write (portbench.payload)."""

from __future__ import annotations

import time

import numpy as np

from portbench.payload import Payloads
from portbench.reference.rs import Code
from portbench.shards import acting, object_shards

PRELOAD = 1 << 62
WARMUP = 1 << 61


class State:
    def __init__(self, run):
        p = run.params
        self.io = None
        self.pool_id = run.cluster.pools[p["pool"]]
        prof = run.config["ec_profile"]
        self.k, self.m = int(prof["k"]), int(prof["m"])
        self.chunk = int(run.config["stripe_unit"])
        self.size = int(p["object_bytes"])
        self.payloads = Payloads(run.seed, self.size)
        width = self.k * self.chunk
        self.padded = max(width, -(-self.size // width) * width)
        self.last: dict[str, int] = {}       # name -> id of its last write
        self.lost_pos: dict[str, int] = {}   # name -> data position lost
        self.kept: list[tuple[str, bytes]] = []
        self.step = [0] * int(p["clients"])

    def encode_bytes(self) -> int:
        """B1's least bytes for one write: the stripe-aligned object in,
        m/k of it out as parity."""
        return self.padded + self.padded * self.m // self.k

    def decode_bytes(self, name: str) -> int:
        """B1's least bytes for one read: k shards in and the lost one
        out where a data shard is lost, else none."""
        if name not in self.lost_pos:
            return 0
        return (self.k + 1) * (self.padded // self.k)


def obj_name(i: int) -> str:
    return f"benchmark_data_object{i}"


async def _write(run, st, c: int, j: int, op_id: int) -> None:
    p = run.params
    names = int(p["names"])
    clients = int(p["clients"])
    own = (names - c + clients - 1) // clients
    name = obj_name(c + clients * (j % own))
    data = st.payloads.get(op_id)
    t0 = time.perf_counter()
    try:
        await st.io.write_full(name, data)
    except Exception as e:       # an op that never comes is a failure
        run.record("write", t0, time.perf_counter(), len(data), False,
                   error=repr(e))
        st.last.pop(name, None)
        return
    run.record("write", t0, time.perf_counter(), len(data), True,
               st.encode_bytes())
    st.last[name] = op_id


async def _read(run, st, rng, keep: bool) -> None:
    name = obj_name(int(rng.integers(int(run.params["preload_objects"]))))
    t0 = time.perf_counter()
    try:
        data = await st.io.read(name)
    except Exception as e:
        run.record("read", t0, time.perf_counter(), 0, False,
                   error=repr(e))
        return
    ok = len(data) == st.size
    run.record("read", t0, time.perf_counter(), len(data), ok,
               st.decode_bytes(name) if ok else 0,
               error="" if ok else f"{name}: {len(data)} bytes")
    if keep:
        st.kept.append((name, data))


async def prepare(run) -> None:
    import asyncio

    p = run.params
    st = run.state = State(run)
    st.io = await run.cluster.rados.open_ioctx(p["pool"])
    clients = int(p["clients"])
    n = int(p.get("preload_objects", 0))
    for lo in range(0, n, clients):
        batch = range(lo, min(n, lo + clients))
        await asyncio.gather(*(st.io.write_full(
            obj_name(i), st.payloads.get(PRELOAD | i)) for i in batch))
        st.last.update({obj_name(i): PRELOAD | i for i in batch})
    down = [int(o) for o in p.get("down_osds", [])]
    for i in range(n):
        name = obj_name(i)
        for pos, osd in enumerate(acting(run.cluster, st.pool_id, name)):
            if osd in down and pos < st.k:
                st.lost_pos[name] = pos
    for osd in down:
        await run.cluster.kill_osd(osd)
    if down:
        await run.cluster.wait_active()
    warm = int(p.get("warmup_ops", 0))
    if p["mode"] == "write":
        await asyncio.gather(*(_warm_writes(run, st, c, warm)
                               for c in range(clients)))
    else:
        await asyncio.gather(*(_warm_reads(run, st, c, warm)
                               for c in range(clients)))


async def _warm_writes(run, st, c, count) -> None:
    for j in range(count):
        await _write(run, st, c, st.step[c], WARMUP | (c << 32) | j)
        st.step[c] += 1


async def _warm_reads(run, st, c, count) -> None:
    rng = np.random.default_rng([run.seed % (1 << 63), c, 1])
    for _ in range(count):
        await _read(run, st, rng, False)


async def client(run, c: int) -> None:
    st = run.state
    if run.params["mode"] == "write":
        j = 0
        while run.open():
            await _write(run, st, c, st.step[c], (c << 32) | j)
            st.step[c] += 1
            j += 1
        return
    rng = np.random.default_rng([run.seed % (1 << 63), c, 2])
    per = -(-int(run.params["check_reads"]) // int(run.params["clients"]))
    keep = set(int(x) for x in rng.choice(2 * per + 4, per, replace=False))
    j = 0
    while run.open():
        await _read(run, st, rng, j in keep)
        j += 1


def _sample(run, names: list[str], count: int) -> list[str]:
    rng = np.random.default_rng([run.seed % (1 << 63), 99])
    names = sorted(names)
    pick = rng.choice(len(names), min(count, len(names)), replace=False)
    return [names[int(i)] for i in sorted(pick)]


async def collect(run) -> dict:
    """Read-backs of the sampled objects through the client, their
    stored shards, and the kept read replies."""
    st = run.state
    if run.params["mode"] == "write":
        names = [n for n, i in st.last.items() if not i & (PRELOAD | WARMUP)]
    else:
        names = list(st.last)
    sample = _sample(run, names, int(run.params["check_objects"]))
    out = {"objects": [], "kept": st.kept}
    for name in sample:
        try:
            back = await st.io.read(name)
        except Exception as e:
            back = repr(e).encode()
        out["objects"].append((name, st.last[name], back,
                               object_shards(run.cluster, st.pool_id,
                                             name)))
    return out


def judge(run, ev: dict) -> dict:
    """Each number compared against its limit: bytes read back or stored
    that differ from the reference's."""
    st = run.state
    code = Code(st.k, st.m, st.chunk)
    down = {int(o) for o in run.params.get("down_osds", [])}
    read_bad = sum(1 for name, data in ev["kept"]
                   if data != st.payloads.get(st.last[name]))
    shard_bad = rebuilt_bad = 0
    for name, op_id, back, shards in ev["objects"]:
        want = st.payloads.get(op_id)
        read_bad += back != want
        ref = code.shards(want)
        have = {}
        for pos in range(st.k + st.m):
            got = shards.get(pos, None)
            if pos not in shards:
                continue              # its OSD is down
            if got is None or np.frombuffer(got, np.uint8).tobytes() \
                    != ref[pos].tobytes():
                shard_bad += 1
            else:
                have[pos] = np.frombuffer(got, np.uint8)
        expected_up = st.k + st.m - len(down)
        shard_bad += max(0, expected_up - len(shards))
        if down:
            # the stored shards, parity first, must rebuild the object
            order = sorted(have, key=lambda q: (q < st.k, q))
            pick = {q: have[q] for q in order[:st.k]}
            if len(pick) < st.k or code.object_bytes(
                    code.decode(pick), st.size) != want:
                rebuilt_bad += 1
    checks = {"read_mismatch": (read_bad, 0),
              "shard_mismatch": (shard_bad, 0)}
    if down:
        checks["rebuild_mismatch"] = (rebuilt_bad, 0)
    checks["nothing_checked"] = (int(not ev["objects"]), 0)
    return checks
