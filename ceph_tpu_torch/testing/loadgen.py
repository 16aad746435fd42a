"""Seeded serving-load generator: the SLO harness's traffic source.

Counterpart of ceph_tpu/testing/loadgen.py: the same module over the
port's imports.

Benchmarks in this repo measure the EC data path in isolation; the SLO
layer (common/slo.py, mgr module "slo") instead judges the cluster the
way a tenant experiences it — under a sustained serving workload.
This module generates that workload the same way the chaos harness
generates faults: EVERYTHING derives from one seed, so two runs with
the same seed issue the SAME op schedule (keys, sizes, op kinds,
arrival times) and disagreement between runs is signal, not noise.

Workload model (the classic object-store serving mix):

- **key popularity** is zipf(s): rank-r key carries weight 1/r**s, so
  a handful of hot keys absorb most gets — the regime where the
  device-resident shard cache and the op coalescer actually matter;
- **object sizes** come from a weighted mix (512B metadata blobs to
  1MiB media chunks by default) drawn per-key, fixed for the run;
- **closed loop**: N client workers issue ops back-to-back — measures
  capacity (each client's next arrival waits on its last completion);
- **open loop**: ops arrive on a fixed schedule (i/rate seconds) and
  NEVER wait for earlier completions — measures latency under load
  the way real tenants apply it (coordinated omission is the classic
  closed-loop lie: a slow op delays the arrivals that would have
  observed the slowness).

Two backends carry the same plan: ``RadosBackend`` (raw librados
write_full/read — the path ``bench.py --serve`` drives) and
``S3Backend`` (SigV4-signed HTTP against an RGW frontend — the tenant
protocol).  Latencies land in log2 µs histograms (common/perf.py), the
same shape the SLO engine windows, so loadgen-side and cluster-side
quantiles are directly comparable.
"""

from __future__ import annotations

import asyncio
import bisect
import random
import time

from ceph_tpu_torch.common.perf import CounterType, PerfCounters, hist_quantile

#: (size_bytes, weight) — small-object-dominated serving mix
DEFAULT_SIZE_MIX: list[tuple[int, float]] = [
    (512, 0.35),          # metadata / manifests
    (4096, 0.40),         # the headline 4KiB stripe unit
    (65536, 0.20),        # thumbnails / chunks
    (1 << 20, 0.05),      # media segments
]


def zipf_cdf(n_keys: int, s: float) -> list[float]:
    """Cumulative zipf(s) distribution over ranks 1..n_keys."""
    weights = [1.0 / (r ** s) for r in range(1, n_keys + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    cdf[-1] = 1.0                       # guard float drift
    return cdf


def _payload(key: str, size: int) -> bytes:
    """Deterministic per-key payload (content checks stay possible)."""
    seed = (key + ":").encode()
    reps = size // len(seed) + 1
    return (seed * reps)[:size]


class Backend:
    """One op surface; both methods raise on failure."""

    async def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    async def get(self, key: str) -> bytes:
        raise NotImplementedError


class RadosBackend(Backend):
    """Raw RADOS traffic through an open IoCtx."""

    def __init__(self, ioctx, prefix: str = "lg"):
        self.io = ioctx
        self.prefix = prefix

    def _oid(self, key: str) -> str:
        return f"{self.prefix}-{key}"

    async def put(self, key: str, data: bytes) -> None:
        await self.io.write_full(self._oid(key), data)

    async def get(self, key: str) -> bytes:
        return await self.io.read(self._oid(key))


class S3Backend(Backend):
    """SigV4-signed S3 traffic against an RGW frontend (stdlib-only
    signing via services.rgw_http; one connection per op, the
    connection:close discipline the frontend's tests use).

    ``503 Slow Down`` from the frontend's admission control is
    THROTTLING, not an error: the op retries after the server's
    Retry-After (capped at ``throttle_backoff_cap``), up to
    ``max_throttle_retries`` times, and each shed counts into
    ``self.throttled`` — a well-behaved tenant backing off must not
    poison the error-rate SLO objective.

    ``read_endpoint``: optional ``(host, port)`` every GET is routed
    to while writes keep hitting ``host:port`` — the multisite
    read-affinity pattern (write the master zone, read the replicated
    local zone), selected per request so one generator can grade a
    geo pair."""

    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, bucket: str = "loadgen",
                 max_throttle_retries: int = 4,
                 throttle_backoff_cap: float = 2.0,
                 read_endpoint: tuple[str, int] | None = None):
        self.host, self.port = host, port
        self.ak, self.sk = access_key, secret_key
        self.bucket = bucket
        self.max_throttle_retries = int(max_throttle_retries)
        self.throttle_backoff_cap = float(throttle_backoff_cap)
        self.read_endpoint = (tuple(read_endpoint)
                              if read_endpoint else None)
        self.throttled = 0

    async def _request(self, method: str, path: str,
                       body: bytes = b"",
                       endpoint: tuple[str, int] | None = None
                       ) -> tuple[int, dict[str, str], bytes]:
        import hashlib

        from ceph_tpu_torch.services.rgw_http import _Request, sigv4_sign

        host, port = endpoint or (self.host, self.port)
        hdrs = {
            "host": f"{host}:{port}",
            "x-amz-date": time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
            "x-amz-content-sha256": hashlib.sha256(body).hexdigest(),
        }
        hdrs["authorization"] = sigv4_sign(
            _Request(method, path, hdrs, body), self.ak, self.sk)
        hdrs["content-length"] = str(len(body))
        reader, writer = await asyncio.open_connection(host, port)
        try:
            lines = [f"{method} {path} HTTP/1.1"]
            lines += [f"{k}: {v}" for k, v in hdrs.items()]
            lines += ["connection: close", "", ""]
            writer.write("\r\n".join(lines).encode() + body)
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        head, _, payload = raw.partition(b"\r\n\r\n")
        head_lines = head.decode().split("\r\n")
        status = int(head_lines[0].split(" ")[1])
        resp_hdrs: dict[str, str] = {}
        for line in head_lines[1:]:
            k, _, v = line.partition(":")
            resp_hdrs[k.strip().lower()] = v.strip()
        return status, resp_hdrs, payload

    async def _request_throttled(self, method: str, path: str,
                                 body: bytes = b"",
                                 endpoint: tuple[str, int] | None = None
                                 ) -> tuple[int, bytes]:
        """One op with 503-as-throttling semantics: honor Retry-After
        with capped backoff; retries exhausted surfaces the 503."""
        attempt = 0
        while True:
            status, hdrs, payload = await self._request(
                method, path, body, endpoint=endpoint)
            if status != 503:
                return status, payload
            self.throttled += 1
            if attempt >= self.max_throttle_retries:
                return status, payload
            try:
                delay = float(hdrs.get("retry-after", "") or 0.0)
            except ValueError:
                delay = 0.0
            if delay <= 0:
                delay = 0.05 * (2 ** attempt)      # no header: expo
            await asyncio.sleep(min(delay, self.throttle_backoff_cap))
            attempt += 1

    async def ensure_bucket(self) -> None:
        status, _ = await self._request_throttled("PUT",
                                                  f"/{self.bucket}")
        if status not in (200, 409):
            raise RuntimeError(f"bucket create HTTP {status}")

    async def put(self, key: str, data: bytes) -> None:
        status, _ = await self._request_throttled(
            "PUT", f"/{self.bucket}/{key}", data)
        if status >= 300:
            raise RuntimeError(f"PUT {key} HTTP {status}")

    async def get(self, key: str) -> bytes:
        status, body = await self._request_throttled(
            "GET", f"/{self.bucket}/{key}",
            endpoint=self.read_endpoint)
        if status >= 300:
            raise RuntimeError(f"GET {key} HTTP {status}")
        return body


class LoadGen:
    """Seeded open/closed-loop load over a :class:`Backend`.

    The full op schedule exists before any I/O (``plan()``), derived
    from the seed alone — same discipline as ChaosHarness.plan(), and
    the property tests assert plan equality across constructions.
    """

    def __init__(self, backend: Backend, seed: int = 0,
                 mode: str = "closed", clients: int = 4,
                 rate: float = 100.0, total_ops: int = 200,
                 read_fraction: float = 0.7, n_keys: int = 64,
                 zipf_s: float = 1.1,
                 size_mix: list[tuple[int, float]] | None = None,
                 duration: float | None = None,
                 tenant_class: str = ""):
        if mode not in ("closed", "open"):
            raise ValueError(f"mode {mode!r} not in ('closed', 'open')")
        self.backend = backend
        self.seed = seed
        # tenant/QoS class every issued op is stamped with (rados
        # qclass contextvar -> per-class OSD histograms); S3 traffic
        # is instead classed server-side by the RGW access-key map
        self.tenant_class = str(tenant_class or "")
        self.mode = mode
        self.clients = max(1, int(clients))
        self.rate = float(rate)
        self.total_ops = int(total_ops)
        self.read_fraction = float(read_fraction)
        self.n_keys = int(n_keys)
        self.zipf_s = float(zipf_s)
        self.size_mix = list(size_mix or DEFAULT_SIZE_MIX)
        self.duration = duration
        self.perf = PerfCounters("loadgen")
        for key in ("ops", "puts", "gets", "errors",
                    "bytes_put", "bytes_get"):
            self.perf.add(key)
        for key in ("op_latency_us", "put_latency_us",
                    "get_latency_us"):
            self.perf.add(key, CounterType.HISTOGRAM)
        self._stop = False

    # -- deterministic schedule ---------------------------------------
    def key_sizes(self) -> dict[str, int]:
        """Per-key object size, drawn once from its own seed stream so
        the size map is stable regardless of total_ops/mode."""
        rng = random.Random(f"loadgen-sizes:{self.seed}")
        sizes, weights = zip(*self.size_mix)
        cum, acc = [], 0.0
        for w in weights:
            acc += w
            cum.append(acc)
        out = {}
        for i in range(self.n_keys):
            r = rng.random() * cum[-1]
            out[f"k{i:05d}"] = sizes[bisect.bisect_left(cum, r)]
        return out

    def plan(self) -> list[dict]:
        """The full op schedule from the seed alone: one dict per op
        with op kind, key, size, and (open loop) arrival offset."""
        rng = random.Random(f"loadgen:{self.seed}")
        cdf = zipf_cdf(self.n_keys, self.zipf_s)
        sizes = self.key_sizes()
        ops = []
        for i in range(self.total_ops):
            rank = bisect.bisect_left(cdf, rng.random())
            key = f"k{rank:05d}"
            kind = "get" if rng.random() < self.read_fraction else "put"
            ops.append({
                "i": i, "op": kind, "key": key, "size": sizes[key],
                "at": (i / self.rate) if self.mode == "open" else None,
            })
        return ops

    # -- execution ----------------------------------------------------
    async def populate(self) -> None:
        """Prewrite every key at its drawn size so gets never miss and
        the first measured window isn't a cold-write artifact."""
        if isinstance(self.backend, S3Backend):
            await self.backend.ensure_bucket()
        sizes = self.key_sizes()
        sem = asyncio.Semaphore(self.clients)

        async def one(key: str, size: int) -> None:
            async with sem:
                await self.backend.put(key, _payload(key, size))

        await asyncio.gather(*(one(k, s) for k, s in sizes.items()))

    def _class_ctx(self):
        """Context stamping ops with the generator's tenant class
        (no-op when unclassed)."""
        if not self.tenant_class:
            import contextlib
            return contextlib.nullcontext()
        from ceph_tpu_torch.client.rados import op_class
        return op_class(self.tenant_class)

    async def _issue(self, op: dict) -> None:
        t0 = time.monotonic()
        try:
            with self._class_ctx():
                if op["op"] == "put":
                    data = _payload(op["key"], op["size"])
                    await self.backend.put(op["key"], data)
                    self.perf.inc("puts")
                    self.perf.inc("bytes_put", len(data))
                else:
                    data = await self.backend.get(op["key"])
                    self.perf.inc("gets")
                    self.perf.inc("bytes_get", len(data))
        except Exception:
            self.perf.inc("errors")
        else:
            el_us = (time.monotonic() - t0) * 1e6
            self.perf.hinc("op_latency_us", el_us)
            self.perf.hinc(f"{op['op']}_latency_us", el_us)
        finally:
            self.perf.inc("ops")

    async def _run_closed(self, plan: list[dict],
                          deadline: float | None) -> None:
        # round-robin split keeps per-client streams seed-stable even
        # if the client count changes the interleaving
        async def worker(c: int) -> None:
            for op in plan[c::self.clients]:
                if self._stop or (deadline is not None
                                  and time.monotonic() > deadline):
                    return
                await self._issue(op)

        await asyncio.gather(*(worker(c) for c in range(self.clients)))

    async def _run_open(self, plan: list[dict],
                        deadline: float | None) -> None:
        # fixed-arrival schedule: an op fires at start+at whether or
        # not earlier ops completed (no coordinated omission)
        start = time.monotonic()
        tasks = []
        for op in plan:
            delay = start + op["at"] - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if self._stop or (deadline is not None
                              and time.monotonic() > deadline):
                break
            tasks.append(asyncio.ensure_future(self._issue(op)))
        if tasks:
            await asyncio.gather(*tasks)

    async def run(self) -> dict:
        """Execute the plan; returns the result summary."""
        plan = self.plan()
        t0 = time.monotonic()
        deadline = (t0 + self.duration) if self.duration else None
        if self.mode == "closed":
            await self._run_closed(plan, deadline)
        else:
            await self._run_open(plan, deadline)
        return self.result(time.monotonic() - t0)

    def stop(self) -> None:
        self._stop = True

    def result(self, wall_s: float) -> dict:
        dump = self.perf.dump()

        def q_ms(key: str, q: float) -> float:
            h = dump.get(key)
            v = hist_quantile(h, q) if isinstance(h, dict) else None
            return 0.0 if v is None else round(v / 1000.0, 4)

        ops = int(dump.get("ops", 0))
        return {
            "seed": self.seed, "mode": self.mode,
            "tenant_class": self.tenant_class,
            "clients": self.clients,
            "ops": ops, "errors": int(dump.get("errors", 0)),
            # admission-control sheds the backend absorbed via
            # Retry-After backoff (0 for backends without throttling)
            "throttled": int(getattr(self.backend, "throttled", 0)),
            "puts": int(dump.get("puts", 0)),
            "gets": int(dump.get("gets", 0)),
            "bytes_put": int(dump.get("bytes_put", 0)),
            "bytes_get": int(dump.get("bytes_get", 0)),
            "wall_s": round(wall_s, 3),
            "ops_per_s": round(ops / wall_s, 2) if wall_s > 0 else 0.0,
            "p50_ms": q_ms("op_latency_us", 0.5),
            "p99_ms": q_ms("op_latency_us", 0.99),
            "p999_ms": q_ms("op_latency_us", 0.999),
            "put_p50_ms": q_ms("put_latency_us", 0.5),
            "put_p99_ms": q_ms("put_latency_us", 0.99),
            "get_p50_ms": q_ms("get_latency_us", 0.5),
            "get_p99_ms": q_ms("get_latency_us", 0.99),
            "get_p999_ms": q_ms("get_latency_us", 0.999),
        }
