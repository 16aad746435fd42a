"""Mesh-global EC coalescer: one launcher per host, sharded launches.

Promotes the per-backend CoalescedLauncher (osd/ec_backend.py) to the
process level (the vstart-host analog): encode/decode ops
from ALL co-located OSDs' EC backends park here, bucket by codec
signature + launch geometry + pow2 shape as before, and every
micro-window flushes as a SINGLE sharded launch over the device mesh
(parallel/ec_sharding.make_ec_mesh).  The batch axis splits across the
('dp', 'cs') axes, so N devices each run the existing engine kernel on
1/N of the stripes — the scale-out step ROADMAP item 1 names
(one chip already beats the isa-l anchor; aggregate bandwidth needs the
whole mesh in the data path, reference ECBackend.cc's per-OSD encode
has no such cross-daemon plane to promote).

Bit-identity: chunk positions stay intact inside each stripe (only the
stripe axis is sharded) and decode matrices come from the codec's ONE
decode_selection definition, so sharded results equal the single-chip
path byte for byte.  Graceful degradation: a 1-device mesh (or a codec
without a generator matrix) refuses registration and the backend keeps
its per-backend single-device launcher.

Cross-chip sub-chunk repair rides the same device pool:
clay_repair_mesh()/lrc_repair_mesh() hand ECBackend the meshes that
parallel/clay_sharding.py / lrc_sharding.py collectives need, so
degraded reads move only regenerating-code helper planes (CLAY, 1/q of
helper bytes) or group-local chunks (LRC) over ICI instead of whole
chunks — counted under ec_mesh_ici_bytes with the whole-chunk
counterfactual beside it.

Counterpart of ceph_tpu/osd/mesh_coalesce.py over the port's mesh
(``parallel.mesh``): the device pool is ``local_devices(device)`` (the
real CUDA devices, or the slots ``force_device_count`` set), a launch is
``ShardedApplier.place`` + ``run_placed`` (each slot's piece on its own
stream), and device payloads are tensors on the backends' device.
"""

from __future__ import annotations

import asyncio
import time
import weakref

import numpy as np
import torch

from ceph_tpu_torch.common import events
from ceph_tpu_torch.common.tracing import current_span
from ceph_tpu_torch.parallel.mesh import upload


class _MeshItem:
    """One op's parked launch request, tagged with its backend (items
    from several OSDs' backends share a flush bucket)."""

    __slots__ = ("backend", "payload", "nstripes", "fut", "t0", "span")

    def __init__(self, backend, payload, nstripes, fut, t0, span=None):
        self.backend = backend
        self.payload = payload
        self.nstripes = nstripes
        self.fut = fut
        self.t0 = t0
        self.span = span


class MeshCoalescer:
    """Host-level cross-OSD micro-batcher for sharded EC launches.

    Keys are ``(sig, ('enc',))`` / ``(sig, ('dec', survivors, todo))``
    where ``sig`` identifies the codec geometry (k, n, chunk size,
    generator bytes): backends of the SAME EC profile across different
    OSDs coalesce into one launch; different profiles never mix.

    Adaptive micro-window as in CoalescedLauncher, with the idle test
    summed over every registered backend's in-flight ops.  Failure
    isolation: a poisoned batch falls back to per-op solo retries
    through each op's own backend single-device path.
    """

    def __init__(self, devices=None, window_us: float = 200.0,
                 max_stripes: int = 4096, device=None):
        self._devices = list(devices) if devices is not None else None
        self._device = device
        self._mesh = None
        self.window_s = max(0.0, float(window_us)) / 1e6
        self.max_stripes = max(1, int(max_stripes))
        self._backends: weakref.WeakSet = weakref.WeakSet()
        self._sig_cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._gens: dict[tuple, np.ndarray] = {}
        self._appliers: dict[tuple, object] = {}
        self._enc_appliers: dict[tuple, object] = {}  # pinned per sig
        self._repair_meshes: dict[tuple, object] = {}
        # sub-chunk repair mesh grants: how often a clay/lrc repair —
        # degraded read OR the batched rebuild engine — was handed a
        # mesh (vs None geometry refusals).  The repair engine's
        # observability rides here so `ec mesh stats` shows whether
        # rebuild traffic reached the interconnect.
        self.repair_mesh_grants = 0
        self._items: dict[tuple, list[_MeshItem]] = {}
        self._npending = 0
        self._nstripes = 0
        self._flusher: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._loop = None
        # lifetime stats ("ec mesh stats" admin-socket surface; perf
        # counters aggregate per daemon, these aggregate per host)
        self.launches = 0
        self.ops = 0
        self.cross_backend_launches = 0
        self.max_backends_in_launch = 0
        self.solo_retries = 0
        self.failed_ops = 0
        self.cancelled_waiters = 0
        self.buckets: set[int] = set()
        self.per_device_stripes: dict[int, int] = {}
        self.last_per_device: dict[int, int] = {}

    # -- device pool ------------------------------------------------------
    def devices(self) -> list:
        if self._devices is None:
            from ceph_tpu_torch.parallel.mesh import local_devices

            self._devices = local_devices(self._device)
        return self._devices

    def mesh(self):
        """The ('dp', 'cs') launch mesh — cs=1: coalesced launches are
        pure batch ('dp') splits with NO collective inside, so every
        chunk column of a stripe stays on one device (placement over
        failure domains is the store fan-out's job, not this plane's)."""
        if self._mesh is None:
            from ceph_tpu_torch.parallel.ec_sharding import make_ec_mesh

            self._mesh = make_ec_mesh(self.devices(), cs=1)
        return self._mesh

    @property
    def total(self) -> int:
        return len(self.devices())

    def warm(self) -> None:
        """Force device-pool + mesh construction (daemon start runs
        this off the event loop: first-time CUDA init blocks)."""
        self.mesh()

    # -- registration -----------------------------------------------------
    def register(self, backend) -> bool:
        """Admit a backend's encode/decode ops to the shared launcher.

        False (backend keeps its single-device CoalescedLauncher) when
        the mesh is a single device — sharding 1-way adds placement
        cost for nothing — or the codec has no dense generator matrix
        (the orchestration plugins coalesce per layer instead)."""
        try:
            if self.total <= 1:
                return False
        except Exception:
            return False
        gen = getattr(backend.ec, "generator", None)
        if gen is None:
            return False
        self._backends.add(backend)
        self._gens[self._sig(backend)] = np.asarray(gen, np.uint8)
        return True

    def _sig(self, backend) -> tuple:
        sig = self._sig_cache.get(backend)
        if sig is None:
            gen = getattr(backend.ec, "generator", None)
            sig = (backend.k, backend.n, backend.sinfo.chunk_size,
                   None if gen is None else
                   np.asarray(gen, np.uint8).tobytes())
            self._sig_cache[backend] = sig
        return sig

    def supports_decode(self, backend) -> bool:
        return hasattr(backend.ec, "decode_selection")

    # -- repair meshes (clay/lrc sub-chunk collectives) -------------------
    def clay_repair_mesh(self, n_chunks: int):
        """('dp','cs') mesh for sharded_clay_repair: the largest cs >= 2
        dividing both chunk count and device count (cs=1 would make the
        plane-extracting all_gather a no-op — no ICI story to count).
        None when the geometry does not fit this device pool."""
        key = ("clay", n_chunks)
        if key not in self._repair_meshes:
            from ceph_tpu_torch.parallel.ec_sharding import make_ec_mesh

            devs = self.devices()
            cs = 0
            for cand in range(min(n_chunks, len(devs)), 1, -1):
                if n_chunks % cand == 0 and len(devs) % cand == 0:
                    cs = cand
                    break
            self._repair_meshes[key] = (
                make_ec_mesh(devs, cs=cs) if cs >= 2 else None)
        if self._repair_meshes[key] is not None:
            self.repair_mesh_grants += 1
        return self._repair_meshes[key]

    def lrc_repair_mesh(self, groups: int):
        """('dp','grp','gs') mesh for sharded_lrc_repair; None when the
        group count does not divide the pool or gs would be 1."""
        key = ("lrc", groups)
        if key not in self._repair_meshes:
            from ceph_tpu_torch.parallel.lrc_sharding import make_group_mesh

            devs = self.devices()
            mesh = None
            if groups >= 1 and len(devs) % groups == 0 \
                    and len(devs) // groups >= 2:
                mesh = make_group_mesh(devs, groups)
            self._repair_meshes[key] = mesh
        if self._repair_meshes[key] is not None:
            self.repair_mesh_grants += 1
        return self._repair_meshes[key]

    # -- submit/flush (CoalescedLauncher's adaptive window, host-wide) ----
    def _bind_loop(self, loop) -> None:
        # same lazy rebind as CoalescedLauncher._bind_loop: primitives
        # are loop-bound and parked state cannot survive a loop switch
        # (every submitter awaits inside the old loop)
        self._loop = loop
        self._wake = asyncio.Event()
        self._flusher = None
        self._items = {}
        self._npending = 0
        self._nstripes = 0

    def notify(self) -> None:
        if self._wake is not None:
            try:
                if asyncio.get_running_loop() is self._loop:
                    self._wake.set()
            except RuntimeError:
                pass

    async def submit(self, backend, key: tuple, payload, nstripes: int):
        """Park one op from ``backend``; resolves with its slice of the
        host-wide sharded launch."""
        loop = asyncio.get_running_loop()
        if loop is not self._loop:
            self._bind_loop(loop)
        full_key = (self._sig(backend), key)
        item = _MeshItem(backend, payload, int(nstripes),
                         loop.create_future(), loop.time(),
                         span=current_span())
        self._items.setdefault(full_key, []).append(item)
        self._npending += 1
        self._nstripes += item.nstripes
        if self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._run_flusher())
        self._wake.set()
        try:
            return await item.fut
        except asyncio.CancelledError:
            self.cancelled_waiters += 1
            raise

    def _inflight_total(self) -> int:
        return sum(be._inflight_ops for be in self._backends)

    async def _run_flusher(self) -> None:
        loop = self._loop
        try:
            while self._npending:
                while True:
                    if self._nstripes >= self.max_stripes:
                        break
                    if self._npending >= self._inflight_total():
                        break   # host idle: no batchmate can arrive
                    oldest = min(it.t0 for items in self._items.values()
                                 for it in items)
                    remaining = oldest + self.window_s - loop.time()
                    if remaining <= 0:
                        break
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        break
                batches = self._items
                self._items = {}
                self._npending = 0
                self._nstripes = 0
                for key, items in batches.items():
                    await self._flush_key(key, items)
        finally:
            for items in self._items.values():
                for it in items:
                    if not it.fut.done():
                        it.fut.cancel()
            self._items = {}
            self._npending = 0
            self._nstripes = 0

    async def _flush_key(self, full_key: tuple,
                         items: list[_MeshItem]) -> None:
        live = [it for it in items if not it.fut.done()]
        if not live:
            return
        now = self._loop.time()
        for it in live:
            wait_us = (now - it.t0) * 1e6
            it.backend.perf.tinc("ec_coalesce_wait_us", wait_us)
            it.backend.perf.hinc("ec_coalesce_wait_hist_us", wait_us)
        wall0 = time.time()
        t0 = time.perf_counter()
        try:
            outs = await self._mesh_launch(full_key, live)
        except asyncio.CancelledError:
            raise
        except BaseException as exc:
            if len(live) == 1:
                self.failed_ops += 1
                if not live[0].fut.done():
                    live[0].fut.set_exception(exc)
                return
            # failure isolation: solo retry through each op's OWN
            # single-device backend path, so one poisoned batchmate
            # (or a sharded-launch geometry surprise) fails only itself
            for it in live:
                if it.fut.done():
                    continue
                self.solo_retries += 1
                try:
                    out = await self._solo(full_key[1], it)
                except asyncio.CancelledError:
                    raise
                except BaseException as solo_exc:
                    self.failed_ops += 1
                    it.fut.set_exception(solo_exc)
                else:
                    it.fut.set_result(out)
            return
        launch_us = (time.perf_counter() - t0) * 1e6
        self.launches += 1
        self.ops += len(live)
        n_backends = len({id(it.backend) for it in live})
        if n_backends > 1:
            self.cross_backend_launches += 1
        self.max_backends_in_launch = max(self.max_backends_in_launch,
                                          n_backends)
        perf0 = live[0].backend.perf
        perf0.inc("ec_mesh_launches")
        perf0.inc("ec_device_launches")
        perf0.tinc("ec_mesh_occupancy", len(live))
        perf0.hinc("ec_mesh_launch_us", launch_us)
        # kernel profiler: the shared sharded launch attributes to the
        # codec signature (same profile across batchmates by keying);
        # bytes = each op's payload, the quantity the h2d accounting
        # below the launch moves
        be0 = live[0].backend
        kind = "mesh-enc" if full_key[1][0] == "enc" else "mesh-dec"
        if full_key[1][0] == "enc":
            hbm = sum(int(getattr(it.payload, "nbytes", 0))
                      for it in live)
        else:
            hbm = sum(int(getattr(c, "nbytes", 0))
                      for it in live for c in it.payload.values())
        be0.profiler.record(f"{be0.codec_sig}:{kind}", launch_us,
                            stripes=sum(it.nstripes for it in live),
                            hbm_bytes=hbm)
        # the launcher is a host singleton shared across OSDs, so mesh
        # launches land in the process journal (like failpoints), not
        # an arbitrary member backend's daemon ring
        events.emit_proc("mesh.launch", op=str(full_key[1][0]),
                         ops=len(live), backends=n_backends,
                         launch_us=round(launch_us, 1))
        for it in live:
            it.backend.perf.inc("ec_mesh_ops")
            if it.backend.tracer is not None and it.span is not None:
                it.backend.tracer.record(
                    "osd:ec:mesh_launch", it.span, wall0,
                    launch_us / 1e3, op=full_key[1][0],
                    occupancy=len(live), backends=n_backends,
                    devices=self.total)
        for it, out in zip(live, outs):
            if not it.fut.done():
                it.fut.set_result(out)

    async def _solo(self, op_key: tuple, it: _MeshItem):
        be = it.backend
        if op_key[0] == "enc":
            return await be._encode_batch(it.payload)
        return await be._decode_batch(dict(it.payload),
                                      list(op_key[2]))

    # -- the sharded launch ----------------------------------------------
    def _applier(self, sig: tuple, mkey: tuple, coeff_fn):
        """Per-(codec sig, matrix) ShardedApplier cache; encode
        appliers are pinned per sig (the write path must never recompile
        because a wide failure rotated 64 decode combos through)."""
        from ceph_tpu_torch.parallel.ec_sharding import ShardedApplier

        if mkey == ("enc",):
            ap = self._enc_appliers.get(sig)
            if ap is None:
                ap = ShardedApplier(self.mesh(), coeff_fn())
                self._enc_appliers[sig] = ap
            return ap
        key = (sig, mkey)
        ap = self._appliers.get(key)
        if ap is None:
            while len(self._appliers) >= 64:
                self._appliers.pop(next(iter(self._appliers)))
            ap = ShardedApplier(self.mesh(), coeff_fn())
            self._appliers[key] = ap
        else:
            self._appliers.pop(key)
            self._appliers[key] = ap
        return ap

    async def _mesh_launch(self, full_key: tuple,
                           items: list[_MeshItem]) -> list:
        """Concatenate batchmates (possibly from several backends),
        pad to a device-divisible pow2 bucket, run ONE sharded launch,
        scatter slices back.  Host payloads upload once (counted h2d on
        their backend); device payloads (resident tensors) split on
        device — no host round trip."""
        sig, op_key = full_key
        from ceph_tpu_torch.ec.engine import mesh_bucket, pad_batch_to
        from ceph_tpu_torch.parallel.ec_sharding import shard_layout

        be0 = items[0].backend
        is_dev = be0._is_device
        if op_key[0] == "enc":
            payloads = [it.payload for it in items]
            sizes = [int(p.shape[0]) for p in payloads]
            any_dev = any(is_dev(p) for p in payloads)
            for it in items:
                if not is_dev(it.payload):
                    it.backend.perf.inc("ec_resident_h2d_bytes",
                                        it.payload.nbytes)
            if len(payloads) == 1:
                cat = payloads[0]
            elif any_dev:
                cat = torch.cat(
                    [p if is_dev(p) else upload(np.asarray(p, np.uint8),
                                                be0.device)
                     for p in payloads], dim=0)
            else:
                cat = np.concatenate(payloads, axis=0)
            b = sum(sizes)
            bp = mesh_bucket(b, self.total)
            if bp != b:
                be0.perf.inc("ec_coalesce_pad_waste", bp - b)
            cat = pad_batch_to(cat, bp)
            self.buckets.add(bp)
            k = sig[0]
            ap = self._applier(sig, ("enc",),
                               lambda: self._gens[sig][k:])
            x = await asyncio.to_thread(ap.place, cat)
            layout = shard_layout(x)
            parity = await asyncio.to_thread(ap.run_placed, x)
            full = torch.cat([x.assemble(be0.device),
                              parity.assemble(be0.device)], dim=1)
            self._note_layout(layout)
            for be in {id(it.backend): it.backend for it in items
                       }.values():
                be.mesh_stats["encodes"] += 1
                be.mesh_stats["encode_buckets"].add(bp)
            return self._scatter_enc(items, sizes, full, any_dev)
        # decode: op_key = ('dec', survivors_avail, todo)
        _, shards, todo = op_key
        todo = list(todo)
        sizes = [int(next(iter(it.payload.values())).shape[0])
                 for it in items]
        any_dev = any(is_dev(c) for it in items
                      for c in it.payload.values())
        for it in items:
            host_bytes = sum(c.nbytes for c in it.payload.values()
                             if not is_dev(c))
            if host_bytes:
                it.backend.perf.inc("ec_resident_h2d_bytes",
                                    host_bytes)
        if any_dev:
            cat = {
                s: torch.cat(
                    [it.payload[s] if is_dev(it.payload[s])
                     else upload(np.asarray(it.payload[s], np.uint8),
                                 be0.device)
                     for it in items], dim=0)
                for s in shards
            }
        else:
            cat = {s: np.concatenate([it.payload[s] for it in items],
                                     axis=0)
                   for s in shards}
        b = sum(sizes)
        bp = mesh_bucket(b, self.total)
        if bp != b:
            be0.perf.inc("ec_coalesce_pad_waste", bp - b)
        out_avail = {w: cat[w] for w in todo if w in cat}
        rebuild = [w for w in todo if w not in cat]
        rebuilt = None
        layout = None
        if rebuild:
            if len(cat) < sig[0]:
                raise IOError(f"cannot decode {rebuild}")
            # ONE decode_selection definition serves both planes —
            # bit-identity with the single-chip path by construction
            survivors, D = be0.ec.decode_selection(cat, rebuild)
            ap = self._applier(sig, ("dec", survivors, tuple(rebuild)),
                               lambda: D)
            if any_dev:
                stacked = torch.stack([cat[s] for s in survivors],
                                      dim=1)
            else:
                stacked = np.stack([cat[s] for s in survivors], axis=1)
            stacked = pad_batch_to(stacked, bp)
            self.buckets.add(bp)
            x = await asyncio.to_thread(ap.place, stacked)
            layout = shard_layout(x)
            rebuilt = (await asyncio.to_thread(ap.run_placed, x)
                       ).assemble(be0.device)
            self._note_layout(layout)
            for be in {id(it.backend): it.backend for it in items
                       }.values():
                be.mesh_stats["decodes"] += 1
                be.mesh_stats["decode_buckets"].add(bp)
        return self._scatter_dec(items, sizes, todo, out_avail,
                                 rebuild, rebuilt, any_dev)

    def _note_layout(self, layout: dict[int, int]) -> None:
        self.last_per_device = dict(layout)
        for dev, rows in layout.items():
            self.per_device_stripes[dev] = (
                self.per_device_stripes.get(dev, 0) + rows)

    def _scatter_enc(self, items, sizes, full, any_dev) -> list:
        res, off = [], 0
        host_full = None
        for it, sz in zip(items, sizes):
            if it.backend._is_device(it.payload):
                res.append(full[off:off + sz])
            else:
                if host_full is None:
                    host_full = full.cpu().numpy()
                sl = host_full[off:off + sz]
                it.backend.perf.inc("ec_resident_d2h_bytes", sl.nbytes)
                res.append(sl)
            off += sz
        return res

    def _scatter_dec(self, items, sizes, todo, out_avail, rebuild,
                     rebuilt, any_dev) -> list:
        host_rebuilt = None
        res, off = [], 0
        for it, sz in zip(items, sizes):
            host_op = not any(it.backend._is_device(c)
                              for c in it.payload.values())
            out = {}
            for w in todo:
                if w in out_avail:
                    c = out_avail[w][off:off + sz]
                    if host_op and it.backend._is_device(c):
                        c = c.cpu().numpy()
                    out[w] = c
            for i, w in enumerate(rebuild):
                if host_op:
                    if host_rebuilt is None:
                        host_rebuilt = rebuilt.cpu().numpy()
                    c = host_rebuilt[off:off + sz, i]
                    it.backend.perf.inc("ec_resident_d2h_bytes",
                                        c.nbytes)
                else:
                    c = rebuilt[off:off + sz, i]
                out[w] = c
            res.append(out)
            off += sz
        return res

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        return {
            "devices": self.total if self._devices is not None else 0,
            "window_us": self.window_s * 1e6,
            "max_stripes": self.max_stripes,
            "backends": len(self._backends),
            "launches": self.launches,
            "ops": self.ops,
            "occupancy": (self.ops / self.launches
                          if self.launches else 0.0),
            "cross_backend_launches": self.cross_backend_launches,
            "repair_mesh_grants": self.repair_mesh_grants,
            "max_backends_in_launch": self.max_backends_in_launch,
            "solo_retries": self.solo_retries,
            "failed_ops": self.failed_ops,
            "cancelled_waiters": self.cancelled_waiters,
            "buckets": sorted(self.buckets),
            "per_device_stripes": dict(sorted(
                self.per_device_stripes.items())),
            "last_per_device": dict(sorted(
                self.last_per_device.items())),
            "pending_ops": self._npending,
            "pending_stripes": self._nstripes,
        }


# -- process-level singleton (the "one launcher per vstart host") --------
_HOST: MeshCoalescer | None = None


def host_coalescer(window_us: float = 200.0,
                   max_stripes: int = 4096, device=None) -> MeshCoalescer:
    """The shared per-process launcher every OSDDaemon wires its EC
    backends to (first caller's window/max_stripes/device win — they are
    host policy, not per-OSD policy).  ``device``: whose local devices
    form the pool (CUDA when None)."""
    global _HOST
    if _HOST is None:
        _HOST = MeshCoalescer(window_us=window_us,
                              max_stripes=max_stripes, device=device)
    return _HOST


def reset_host_coalescer() -> None:
    """Test isolation hook: drop the singleton (its appliers pin their
    per-slot kernel constants; a fresh process-level window starts
    clean)."""
    global _HOST
    _HOST = None
