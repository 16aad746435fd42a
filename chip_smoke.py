#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's erasure-code data path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit.  It imports ``ceph_tpu_torch`` (never JAX, never ceph_tpu)
and, phase by phase, raising on any failure:

1. builds the CUDA kernels from ``ceph_tpu_torch/csrc`` (nvcc, all sources
   at once) and prints the build seconds, each kernel's registers and
   spills (ptxas) and its loops with their instruction mix
   (``testing.sass``); fails if the lab's unpack kernel (L2) lost its
   expansion or repack loop (a compiler that folded the planes away would
   leave a copy), if a field-table row loop (B1, B2, B3, B4, B5b, B5c)
   takes 70 or more instructions per input word (per group for B3/B4; the
   bit-spread design they replaced), if B2's, B3's, B4's or B5c's interior
   row loop calls a subroutine (the 64-bit division) or loads more than
   one 16-byte row per unit and input row (a byte-by-byte path inline), or
   if B1's or B2's row loop or registers moved from their field-table
   redesign's (the split2 kernels share their kernel body);
2. prints the card (torch's name, nvidia-smi's name and power limit);
3. holds each kernel against its plain PyTorch version on the card, exact
   (``torch.equal``): the dense kernels at the headline k=8 m=4 encode, a
   4-erasure decode matrix, a ragged length and the w=16 / w=32 packet
   matrices, and B2 at the OSD path's CRC contraction (4 x 65536 blocks
   over 12 and 768 streams); the encode-variant kernels at the headline
   encode, the decode matrix, a ragged length (the split2 kernels' last
   block with only its first half live), a length whose last block has
   both halves live, a 32
   x 32 matrix at the variants' gate (mout*kin = 1024), inputs 4 bytes off
   16-byte alignment and, for the byte ones, the (B, k, C) batch, at the
   gate and at C = 1001 with a base 4 bytes off; the lab's
   copy kernel at the headline, a ragged length and its edges (input and
   output 4 bytes off 16-byte alignment, off by different amounts, n = 1
   and 3, under one block, one block and four); B1 at each tile of the
   lab's sweep (headline, ragged, the blocked w=32 matrix); the lab's bit
   kernels at the headline and ragged shapes (L2 on words, L3 on the lab's
   bm32 with 0/1 bits and on asymmetric int8 over the whole range, n % 8 !=
   0 included); B2 at the byte view's edges (a (B, k, 1001) batch, streams
   whose base is 4 bytes off alignment); the grouped kernels on the CLAY
   k=8 m=4 d=11 repair operator at the headline repair (words and the
   (B, 176, sc) batch), the CLAY k=16 m=4 d=19 operator, random sparse
   plans with short groups and with the pair-padding group, a ragged
   length, and a (B, 176, 1001) batch whose base is 4 bytes off;
4. runs the main paths with every launch count set to 0: the corpus check
   (all 16 archives bit-identical, under both encode variants), the
   exhaustive k=8 m=4 erasure sweep (793 patterns), a 64 MiB object split
   into 16384 stripes, encoded, 4 shards dropped, decoded and merged back
   bit-identical, the headline encode / 4-erasure decode through the word
   entries; then CLAY k=8 m=4 d=11: encode, all 12 single-chunk repairs
   through ``batched_clay_plane_repair_device`` (each one grouped-kernel
   launch), a 4-erasure full decode; the CLAY k=16 m=4 d=19 repair of
   chunk 16 (the paired kernel); an LRC k=8 l=3 m=4 and a SHEC k=4 m=3 c=2
   round trip with one lost chunk; then, under each of the five encode
   variants, the corpus check and the 64 MiB object round trip, each
   variant's kernel launched and a blocked matrix's apply launching the
   production kernel B1; then the perf lab
   (``ceph_tpu_torch.testing.perf_lab``), all 14 experiments through the
   device-loop timer, each checked bit-identical first.  It reads the
   counts after each path and fails if a kernel was not launched;
5. times each kernel and its plain version with CUDA events beside its
   bound: the dense kernels at the jax_rs headline (16384 stripes x 4 KiB,
   k=8 m=4, 64 MiB of data per launch); the grouped kernel at the CLAY
   headline repair (512 stripes x 64 KiB chunks), beside the dense byte
   kernel on the same operator, and the paired kernel at the k=16 repair
   (1024 stripes x 16 KiB chunks); the variant kernels at the headline;
   the copy kernel beside its bound and ``torch.bitwise_xor``, the two
   and B1's encode timed in turn in one loop (the measured copy ceiling,
   and B1's rate against it); B1 against B5b and B2 against B5c (one row
   load in flight per thread against two) in one loop, encode and decode;
   B1 at the four tiles; B1 beside B5a and the bit-spread B1's time;
   B2-B5c beside their bit-spread times; L2 beside ``x.clone()`` and L3
   beside ``torch._int_mm``; the entries around them, the CLAY k=16 repair
   entry beside its gather plus B4; the lab's roof_copy step once more
   through the old timer (CUDA events around steps issued from Python),
   beside the device loop's reading and L1's kernel-alone time; the
   device CRC (B2, kin = 65536, mout = 4) at the write path's 12 streams
   and the scrub group's 768, and the scrub verdict ``verify_batch``;
6. runs the OSD path (``osd_phase``) with the counts set to 0, after the
   timings so that its host state cannot move them: ``ECBackend`` over 12
   MemStore shards of a k=8 m=4 pool with 4 KiB stripes, 64 objects of
   4 MiB written concurrently through the coalesced launcher, read,
   degraded-read with shards 0-3 gone and rebuilt by ``recover_batch``;
   then the resident write-back backend with 64 objects of 512 KiB (64 KiB
   shard streams, every hinfo by the device CRC, checked against the host
   crc32c), a batched scrub (2 launches), one bit flipped at rest and
   scrubbed (exactly that object and shard flagged), two waves of 64
   concurrent 512-byte overwrites, flushed, evicted and read back, each
   wave's wall time, client GiB/s, launches and device share printed.  It
   fails if B1 or B2 was not launched, if 64 concurrent writes did not
   coalesce into fewer launches than ops, or if a scrub of one group took
   other than 2 launches; its launches join the ``kernels`` line's counts;
7. prints the ``kernels`` JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without CUDA, or when the package is
not beside it.
"""

from __future__ import annotations

import functools
import json
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 rate and
# int8 tensor-core rate.  A bound is the larger of bytes / rate and
# operations / rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

K, M = 8, 4
CHUNK = 512                  # 4 KiB stripes of 8 chunks
STRIPES = 16384              # 64 MiB of data per launch
HEADLINE_LOST = [0, 1, 2, 3]  # the JAX benchmark's --erasures 4 choice
OBJECT_LOST = [1, 4, 8, 10]   # two data shards, one parity, one data
SEED = 20261016

# CLAY headline repair: k=8 m=4 d=11, one OSD repair batch of 64 objects of
# 4 MiB = 512 stripes of 64 KiB chunks (sc = 1024, the JAX bench's cfg4).
CLAY = {"k": "8", "m": "4", "d": "11"}
CLAY_STRIPES, CLAY_SC = 512, 1024
CLAY_LOST = 3
CLAY_DECODE_LOST = [0, 5, 9, 11]
# The paired-kernel repair: k=16 m=4 d=19, 1024 stripes of 16 KiB chunks.
CLAY16 = {"k": "16", "m": "4", "d": "19"}
CLAY16_STRIPES, CLAY16_SC, CLAY16_LOST = 1024, 16, 16
# A (mout x kin) matrix at the encode variants' gate, mout*kin = 1024.
GATE_EDGE = (32, 32)
# B1's inner loop covers one input row's 4 words (gf2_io.cuh VEC); the
# bit-spread design it replaced took 70 instructions per input word (280 per
# 32 word-bit pairs) and 68.93 us at the headline encode (chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W).
B1_LOOP_WORDS = 4
B1_OLD_PER_WORD = 70
B1_OLD_US = 68.93
# The field-table row loop looks up each input row's 4 words in 4 output
# rows' (B3: slots') tables, 3 prmt each: 48 PRMT per input row.  B2, B3 and
# B4 ran the bit spread until their field-table redesign; their last times
# (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): B2 at the headline
# encode bytes, B3 on the CLAY k=8 repair's (176, N) streams, B4 at the
# k=16 repair.
FIELD_LOOP_PRMT = 3 * B1_LOOP_WORDS * 4
B2_OLD_US = 82.67
B3_OLD_US = 157.17
B4_OLD_US = 143.19
# L2's expansion and repack loops each cover one 16-word unit.
L2_UNIT_WORDS = 16
# B1's and B2's row loops and registers since their field-table redesign
# (SASS instructions per iteration, ptxas registers; chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W), which the shared kernel body of the
# split2 variants must leave as they are.
B1_LOOP, B1_REGS = 162, 64
B2_LOOP, B2_REGS = 252, 80
# B5b's and B5c's last times on the bit spread, at the headline encode
# (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).
B5B_OLD_US = 65.28
B5C_OLD_US = 67.69
# Rounds of the interleaved timing loops (B1/B5b, B2/B5c; L1/bitwise_xor).
INTERLEAVED_ROUNDS = 6
# The copy kernel's block: 1024 threads of one 16-byte unit (lab_copy.cu).
L1_BLOCK_WORDS = 1024 * 4


def log(*args) -> None:
    print(*args, flush=True)


# The OSD phase: an EC pool of k=8 m=4 reed_sol_van with 512-byte chunks
# (4 KiB stripes), one MemStore per shard.  (a) the classic coalesced
# backend: 64 objects of 4 MiB (an RBD pool's default object size, and the
# repair engine's batch of 64) written concurrently, read, degraded-read
# with shards 0-3 gone and rebuilt by recover_batch; (b) the resident
# write-back backend: 64 objects of 512 KiB, so every shard stream is
# 64 KiB (the device CRC's length gate) and every hinfo is computed on the
# card, then scrubbed, one bit flipped and scrubbed again, and two waves
# of 64 concurrent 512-byte overwrites (bench.py's cfg7 pattern).
OSD_PROFILE = {"k": "8", "m": "4", "technique": "reed_sol_van"}
OSD_OBJECTS = 64
OSD_OBJECT_BYTES = 4 << 20
OSD_LOST = [0, 1, 2, 3]
OSD_RESIDENT_BYTES = 512 << 10
OSD_VICTIM = (37, 10, 12345, 0x10)   # object, shard, offset, bit flipped
OSD_BUDGET_S = 120.0


def osd_phase(dev, seed: int) -> dict:
    """Drive the port's OSD data path (``ECBackend`` over ``MemStore``
    shards) on the CUDA device ``dev`` and check every result; return
    per-wave readings.  Each B1/B2 launch is bracketed by CUDA events (an
    upper bound of its device time: the wrapper's host work after the
    first event is included)."""
    import asyncio

    import numpy as np
    import torch

    from ceph_tpu_torch.common import crc32c as crc_mod
    from ceph_tpu_torch.common import failpoint as fp
    from ceph_tpu_torch.ec import checksum
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import HINFO_ATTR, ECBackend, LocalShard
    from ceph_tpu_torch.osd.ec_util import HashInfo
    from ceph_tpu_torch.store import (CollectionId, GHObject, MemStore,
                                      Transaction)

    t_phase = time.perf_counter()
    log(f"[osd] host crc32c: {crc_mod.backend()} "
        f"({crc_mod.library_path().name})")
    if crc_mod.backend() != "native":
        raise AssertionError("the native crc32c did not build or load")
    rng = np.random.default_rng(seed)
    codec = ErasureCodePluginRegistry().factory("jax_rs", OSD_PROFILE,
                                                device=dev)
    n = codec.get_chunk_count()
    events: list = []
    shimmed = {}

    def timed(fn):
        def shim(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return shim

    for name in ("gf2_apply_words", "gf2_apply_u8"):
        shimmed[name] = ck.KERNELS[name]
        ck.KERNELS[name] = timed(shimmed[name])
        setattr(ck, name, ck.KERNELS[name])

    async def backend(**kw):
        stores, shards = {}, {}
        for i in range(n):
            store = MemStore()
            cid = CollectionId(1, 0, shard=i)
            await store.queue_transactions(
                Transaction().create_collection(cid))
            stores[i] = (store, cid)
            shards[i] = LocalShard(store, cid, pool=1, shard=i)
        be = ECBackend(codec, shards, stripe_unit=512, **kw)
        return be, stores

    waves = []

    async def wave(label, be, nbytes, fn):
        """One wave: its wall time, client GiB/s, launches, the backend's
        summed launch times and the kernels' event time, each against
        the wall time."""
        k0 = dict(ck.LAUNCHES)
        p0 = {key: be.perf.value(key) for key in (
            "ec_device_launches", "ec_encode_launch_us",
            "ec_decode_launch_us", "ec_coalesce_launches",
            "ec_coalesce_ops", "ec_scrub_launches")}
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = await fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        kern_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        d = {key: be.perf.value(key) - v for key, v in p0.items()}
        launch_s = (d["ec_encode_launch_us"] + d["ec_decode_launch_us"]) / 1e6
        rec = {"wave": label, "wall_s": sec,
               "client_gib_s": nbytes / sec / 2**30,
               "kernel_launches": {k: ck.LAUNCHES[k] - k0[k] for k in k0
                                   if ck.LAUNCHES[k] != k0[k]},
               "kernel_event_s": kern_s, "kernel_share": kern_s / sec,
               "launch_s": launch_s, "launch_share": launch_s / sec,
               **{key: d[key] for key in ("ec_device_launches",
                                          "ec_coalesce_launches",
                                          "ec_coalesce_ops",
                                          "ec_scrub_launches")}}
        if be.resident is not None:
            rec["resident"] = be.resident_stats()
        waves.append(rec)
        log(f"[osd] {json.dumps(rec)}")
        return out

    async def classic():
        be, stores = await backend(coalesce=True)
        names = [f"rbd_data.{i:04x}" for i in range(OSD_OBJECTS)]
        blob = rng.bytes(OSD_OBJECTS * OSD_OBJECT_BYTES)
        datas = {nm: blob[i * OSD_OBJECT_BYTES:(i + 1) * OSD_OBJECT_BYTES]
                 for i, nm in enumerate(names)}
        total = OSD_OBJECTS * OSD_OBJECT_BYTES
        await wave("a: write", be, total, lambda: asyncio.gather(*(
            be.write(nm, d) for nm, d in datas.items())))
        w = waves[-1]
        if w["ec_coalesce_ops"] != OSD_OBJECTS:
            raise AssertionError(f"{OSD_OBJECTS} concurrent writes coalesced "
                                 f"{w['ec_coalesce_ops']} ops")
        if not w["ec_coalesce_launches"] < w["ec_coalesce_ops"]:
            raise AssertionError(f"coalesced launches {w} not below ops")
        got = await wave("a: read", be, total, lambda: asyncio.gather(*(
            be.read(nm) for nm in names)))
        if got != [datas[nm] for nm in names]:
            raise AssertionError("classic read-back differs")
        before = {}
        for nm in names:
            for s in OSD_LOST:
                store, cid = stores[s]
                oid = GHObject(1, nm, shard=s)
                before[nm, s] = store.read(cid, oid)
                await store.queue_transactions(
                    Transaction().remove(cid, oid))
        got = await wave("a: degraded read", be, total,
                         lambda: asyncio.gather(*(be.read(nm)
                                                  for nm in names)))
        if got != [datas[nm] for nm in names]:
            raise AssertionError(f"degraded read with {OSD_LOST} lost "
                                 f"differs")
        res = await wave("a: recover_batch", be, total,
                         lambda: be.recover_batch(names, OSD_LOST))
        if sorted(res["recovered"]) != sorted(names):
            raise AssertionError(f"recover_batch left objects: {res}")
        for (nm, s), want in before.items():
            store, cid = stores[s]
            if store.read(cid, GHObject(1, nm, shard=s)) != want:
                raise AssertionError(f"rebuilt shard {s} of {nm} differs")
        log(f"[osd] (a) {OSD_OBJECTS} x {OSD_OBJECT_BYTES} B: writes, reads, "
            f"degraded reads with {OSD_LOST} lost and recover_batch "
            f"({res['strategy']}, {res['batches']} batch) bit-identical")

    async def resident():
        be, stores = await backend(resident=True, resident_writeback=True,
                                   resident_max_bytes=1 << 30)
        names = [f"rbd_data.r{i:04x}" for i in range(OSD_OBJECTS)]
        blob = rng.bytes(OSD_OBJECTS * OSD_RESIDENT_BYTES)
        datas = {nm: bytearray(blob[i * OSD_RESIDENT_BYTES:
                                    (i + 1) * OSD_RESIDENT_BYTES])
                 for i, nm in enumerate(names)}
        total = OSD_OBJECTS * OSD_RESIDENT_BYTES
        await wave("b: write", be, total, lambda: asyncio.gather(*(
            be.write(nm, bytes(d)) for nm, d in datas.items())))
        w = waves[-1]
        if w["ec_coalesce_ops"] != OSD_OBJECTS:
            raise AssertionError(f"{OSD_OBJECTS} concurrent writes coalesced "
                                 f"{w['ec_coalesce_ops']} ops")
        await be.flush_resident()
        shard_len = OSD_RESIDENT_BYTES // 8
        if not checksum.supported_len(shard_len):
            raise AssertionError(f"shard length {shard_len} is beyond the "
                                 f"device CRC's gate")
        for nm in names:
            store0, cid0 = stores[0]
            raw = store0.getattr(cid0, GHObject(1, nm, shard=0), HINFO_ATTR)
            hinfo = HashInfo.from_dict(n, json.loads(raw))
            for s in range(n):
                store, cid = stores[s]
                stored = store.read(cid, GHObject(1, nm, shard=s))
                if (hinfo.total_chunk_size != shard_len
                        or crc_mod.crc32c(0xFFFFFFFF, stored)
                        != hinfo.get_chunk_hash(s)):
                    raise AssertionError(f"hinfo of {nm} shard {s} differs "
                                         f"from the host crc32c")
        log(f"[osd] (b) {OSD_OBJECTS} x {OSD_RESIDENT_BYTES} B written back: "
            f"every hinfo (device CRC, L = {shard_len}) equals the "
            f"{crc_mod.backend()} host crc32c of the stored shards")
        rep = await wave("b: scrub", be, total,
                         lambda: be.scrub_batch(names))
        if waves[-1]["ec_scrub_launches"] != 2 or rep["groups"] != 1:
            raise AssertionError(f"scrub of one group took "
                                 f"{waves[-1]['ec_scrub_launches']} "
                                 f"launches, {rep['groups']} groups")
        if not all(r["clean"] and r["hinfo"]
                   for r in rep["reports"].values()):
            raise AssertionError("scrub of the written pool not clean")
        obj, shard, off, mask = OSD_VICTIM
        victim = names[obj % OSD_OBJECTS]
        store, cid = stores[shard]

        def flip():
            fp.fp_set("store.corrupt_shard", "error", count=1)
            try:
                return store.corrupt_shard(
                    cid, GHObject(1, victim, shard=shard), offset=off,
                    mask=mask)
            finally:
                fp.fp_clear()

        be.resident.drop_object(be.resident_ns, victim)  # scrub the store
        flipped = flip()
        rep = await wave("b: scrub, one bit flipped", be, total,
                         lambda: be.scrub_batch(names))
        bad = {nm: r for nm, r in rep["reports"].items() if not r["clean"]}
        if (waves[-1]["ec_scrub_launches"] != 2 or list(bad) != [victim]
                or bad[victim]["crc_mismatch"] != [shard]
                or bad[victim]["parity_inconsistent"] != [shard]):
            raise AssertionError(f"flip {flipped}: scrub flagged {bad}")
        flip()
        log(f"[osd] (b) bit flip {flipped}: scrub flagged exactly "
            f"{victim} shard {shard} (crc and parity); bit restored")
        for r in range(2):
            offset = 512 + r * 4096
            patch = bytes([0xA0 + r]) * 512
            await wave(f"b: overwrite {r + 1}", be, OSD_OBJECTS * len(patch),
                       lambda: asyncio.gather(*(
                           be.write(nm, patch, offset=offset)
                           for nm in names)))
            for d in datas.values():
                d[offset:offset + 512] = patch
        await be.flush_resident()
        await be.resident.evict(target=0)
        got = await wave("b: read after evict", be, total,
                         lambda: asyncio.gather(*(be.read(nm)
                                                  for nm in names)))
        if got != [bytes(datas[nm]) for nm in names]:
            raise AssertionError("resident read-back after evict differs")
        log(f"[osd] (b) 2 waves of {OSD_OBJECTS} x 512 B overwrites, "
            f"flushed, evicted to 0: read back bit-identical")

    try:
        asyncio.run(classic())
        asyncio.run(resident())
    finally:
        for name, fn in shimmed.items():
            ck.KERNELS[name] = fn
            setattr(ck, name, fn)
    return {"waves": waves, "seconds": time.perf_counter() - t_phase}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from ceph_tpu_torch.common import cuda_build
        from ceph_tpu_torch.ec import benchmark, checksum, corpus
        from ceph_tpu_torch.ec import cuda_kernels as ck
        from ceph_tpu_torch.ec.bitmatrix import gf_matrix_to_bitmatrix
        from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
        from ceph_tpu_torch.ec.repair_operator import (
            clay_repair_operator,
            lrc_repair_operator,
        )
        from ceph_tpu_torch.osd.ec_util import StripeInfo
        from ceph_tpu_torch.parallel.clay_sharding import (
            batched_clay_plane_repair_device,
        )
        from ceph_tpu_torch.parallel.lrc_sharding import (
            batched_lrc_group_repair,
        )
        from ceph_tpu_torch.testing import perf_lab, sass
    except ImportError as e:
        print(f"chip_smoke: the ceph_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)

    def rand_u8(shape) -> torch.Tensor:
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    walls = {}

    def wall(label, fn):
        """Host-clock seconds of fn(), synchronised both ends: for the
        plane loops and probes, which are launch-bound host code."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0
        return res

    def max_err(got, ref) -> int:
        return int((got.long() - ref.long()).abs().max())

    def helper_planes(ec, chunks, helpers, planes, sc) -> torch.Tensor:
        """(B, d*P, sc): each stripe's helpers' repair planes, stacked in
        the order clay_repair_operator probed R against."""
        b = chunks.shape[0]
        return torch.stack([
            chunks[:, h].reshape(b, ec.sub_chunk_no, sc)[:, planes]
            for h in helpers], dim=1).reshape(b, len(helpers) * len(planes),
                                              sc)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = cuda_build.build(cuda_build.SOURCES)
    log(f"[build] {secs} wall {time.perf_counter() - t0:.2f}s")
    regs = {}
    for name in cuda_build.SOURCES:
        for kernel, r in sass.registers(cuda_build.build_log(name)).items():
            regs[kernel] = r
            log(f"[build] {name}: {kernel}: {r.get('registers')} registers, "
                f"spill stores {r.get('spill_stores')} B, spill loads "
                f"{r.get('spill_loads')} B")
        for line in sass.report(name):
            log(f"[sass] {line}")
    # L2 must keep its work: a loop storing the int8 planes and a loop
    # reading them back (ptxas folding them would leave a copy).
    unpack = {n: found for n, found in sass.kernel_loops("lab_bits").items()
              if "unpack_repack_kernel" in n}
    loop_ops = [ops for found in unpack.values() for _, ops in found]
    if not (any(ops.get("STS", 0) >= 32 for ops in loop_ops)
            and any(ops.get("LDS", 0) >= 32 for ops in loop_ops)):
        raise AssertionError(f"the unpack kernel has no plane expansion "
                             f"and repack loops: {unpack}")
    expand = min(n for found in unpack.values() for n, ops in found
                 if ops.get("STS", 0) >= 32)
    repack = min(n for found in unpack.values() for n, ops in found
                 if ops.get("LDS", 0) >= 32)
    log(f"[sass] L2 unpack_repack_words keeps its expansion loop ({expand} "
        f"instructions, >= 32 STS of int8 planes) and its repack loop "
        f"({repack}, >= 32 LDS): {(expand + repack) / L2_UNIT_WORDS:.2f} "
        f"instructions per word")
    # The field-table row loops: each input row's VEC words applied to 4
    # output rows (B3/B4: a group's 4 slots), 3 prmt per (word, row).  B1
    # keeps one loop of one row for interior and edge units; B2, B3 and B4
    # run an interior-only loop of two rows, which must hold one 16-byte
    # load per row and no call.  The split2 kernels apply one row to each
    # of two units per iteration: B5b in one loop that tests each unit per
    # row, B5c in an interior-only loop (one 16-byte load per unit-row).
    field_kernels = {
        # label: (source, mangled-name test, interior-only row loop)
        "B1 production": ("gf2_apply", lambda n: "gf2_words_kernel" in n
                          and "WordIOELb0E" in n, False),
        "B1 tiled": ("gf2_apply", lambda n: "gf2_words_kernel" in n
                     and "WordIOELb1E" in n, False),
        "B2": ("gf2_apply", lambda n: "gf2_words_kernel" in n
               and "ByteIO" in n, True),
        "B3 bytes": ("gf2_grouped", lambda n: "ByteIOELb0E" in n, True),
        "B3 words": ("gf2_grouped", lambda n: "WordIOELb0E" in n, True),
        "B4 bytes": ("gf2_grouped", lambda n: "ByteIOELb1E" in n, True),
        "B4 words": ("gf2_grouped", lambda n: "WordIOELb1E" in n, True),
        "B5b": ("gf2_variants", lambda n: "gf2_words_kernel" in n
                and "WordIO" in n, False),
        "B5c": ("gf2_variants", lambda n: "gf2_words_kernel" in n
                and "ByteIO" in n, True),
    }
    row_loops = {}
    loop_len = {}
    kernel_of = {}
    for label, (source, match, interior) in field_kernels.items():
        found = {n: f for n, f in sass.kernel_loops(source).items()
                 if match(n)}
        if len(found) != 1:
            raise AssertionError(f"{label}: {len(found)} kernels match")
        (kernel_of[label], found), = found.items()
        loop = sass.row_loop(found, FIELD_LOOP_PRMT)
        if loop is None:
            raise AssertionError(f"no field-table loop in {label}: {found}")
        length, ops = loop
        rows = ops["PRMT"] // FIELD_LOOP_PRMT   # unit-rows per iteration
        per_word = length / (B1_LOOP_WORDS * rows)
        row_loops[label] = per_word
        loop_len[label] = length
        log(f"[sass] {label}: loops of {[n for n, _ in found]} "
            f"instructions; row loop {length} for {rows} unit-row(s) "
            f"(16-byte unit x input row) = {per_word:.2f} per input word"
            f"{' and group' if label.startswith(('B3', 'B4')) else ''} "
            f"(PRMT {ops.get('PRMT', 0)}, LDG {ops.get('LDG', 0)}, "
            f"CALL {ops.get('CALL', 0)})")
        if per_word >= B1_OLD_PER_WORD:
            raise AssertionError(f"{label}'s row loop takes {per_word:.2f} "
                                 f"instructions per input word, not below "
                                 f"the bit-spread design's {B1_OLD_PER_WORD}")
        if interior and (ops.get("CALL", 0) or ops.get("LDG", 0) > rows):
            raise AssertionError(f"{label}'s interior row loop has "
                                 f"{ops.get('CALL', 0)} calls and "
                                 f"{ops.get('LDG', 0)} global loads for "
                                 f"{rows} rows: a division or a byte path "
                                 f"is inline")
    b1_per_word = row_loops["B1 production"]
    for label, want_loop, want_regs in (("B1 production", B1_LOOP, B1_REGS),
                                        ("B2", B2_LOOP, B2_REGS)):
        got = regs[kernel_of[label]].get("registers")
        log(f"[sass] {label} unchanged by the shared kernel body: row loop "
            f"{loop_len[label]} (was {want_loop}), {got} registers (was "
            f"{want_regs})")
        if (loop_len[label], got) != (want_loop, want_regs):
            raise AssertionError(f"{label}'s row loop or registers moved")
    for label in ("B5b", "B5c"):
        r = regs[kernel_of[label]]
        log(f"[build] {label} (two units per thread): {r.get('registers')} "
            f"registers, spills {r.get('spill_stores')}/"
            f"{r.get('spill_loads')} B; row loop {loop_len[label]}")

    # -- 2. the card -------------------------------------------------------
    smi = perf_lab.nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch: {kind}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 3. kernels vs plain versions ----------------------------------------
    ec = ErasureCodeJaxRS({"k": str(K), "m": str(M)}, device=dev)
    gen = ec.generator
    dec = ec.decode_selection(
        [i for i in range(K + M) if i not in HEADLINE_LOST],
        HEADLINE_LOST)[1]
    w16 = ErasureCodeJaxRS({"k": "5", "m": "3", "technique": "reed_sol_van",
                            "w": "16"}, device=dev)
    w32 = ErasureCodeJaxRS({"k": "4", "m": "2", "technique": "reed_sol_van",
                            "w": "32"}, device=dev)
    packet16 = w16.full_bm[5 * 16:]                    # (48, 80) 0/1
    packet32 = w32.full_bm[4 * 32:]                    # (64, 128) 0/1
    n_bytes = STRIPES * CHUNK                          # per shard row
    cases = [
        # (label, coefficient matrix, words shape, bytes shape)
        ("headline encode k=8 m=4", gen[K:], (K, n_bytes // 4), (K, n_bytes)),
        ("decode 4 erasures", dec, (K, n_bytes // 4), (K, n_bytes)),
        ("ragged length", gen[K:], (K, 1_000_003), (K, 1_000_003)),
        ("w=16 packets", packet16, (80, 65_536), (4096, 80, 256)),
        ("w=32 packets", packet32, (128, 65_536), (1024, 128, 4096 // 32)),
    ]
    errs = {name: 0 for name in ck.LAUNCHES}
    for label, coeff, wshape, bshape in cases:
        ap = ck.ShardApply(coeff)
        consts = ap.consts
        words = ck.bytes_to_words(rand_u8(wshape[:-1] + (wshape[-1] * 4,)))
        got = ck.gf2_apply_words(consts, words)
        ref = ck.gf2_apply_words_plain(consts.plain_bm32(dev), words)
        torch.cuda.synchronize()
        err_w = max_err(got, ref)
        data = rand_u8(bshape)
        got8 = ck.gf2_apply_u8(consts, data)
        ref8 = ck.gf2_apply_u8_plain(consts.plain_bm(dev), data)
        torch.cuda.synchronize()
        err_b = max_err(got8, ref8)
        ok = torch.equal(got, ref) and torch.equal(got8, ref8)
        log(f"[exact] {label}: coeff {coeff.shape} words {tuple(wshape)} "
            f"bytes {tuple(bshape)} -> equal={ok}")
        if not ok:
            raise AssertionError(f"kernel != plain version at {label}")
        errs["gf2_apply_words"] = max(errs["gf2_apply_words"], err_w)
        errs["gf2_apply_u8"] = max(errs["gf2_apply_u8"], err_b)
    # B2 at the byte view's edges: a batch whose 16-byte units straddle
    # segments, and streams whose base is 4 bytes off 16-byte alignment
    # (the edge path for every unit).
    enc = ck.ShardApply(gen[K:]).consts
    for label, shape, base in (
            ("(B, k, C) batch, C = 1001", (4096, K, 1001), 0),
            ("(k, N) streams, base 4 bytes off", (K, n_bytes), 4)):
        data = rand_u8((int(np.prod(shape)) + base,))[base:].view(shape)
        got8 = ck.gf2_apply_u8(enc, data)
        ref8 = ck.gf2_apply_u8_plain(enc.plain_bm(dev), data)
        torch.cuda.synchronize()
        ok = torch.equal(got8, ref8)
        log(f"[exact] gf2_apply_u8 {label}: bytes {shape} -> equal={ok}")
        if not ok:
            raise AssertionError(f"gf2_apply_u8 != plain version at {label}")
        errs["gf2_apply_u8"] = max(errs["gf2_apply_u8"], max_err(got8, ref8))
    # B2 at the OSD path's CRC shapes (ec.checksum): 4 output rows over the
    # (L, B) transpose of B streams of L = 64 KiB, for the write path's 12
    # streams (12-byte rows: every unit on the edge path) and the scrub
    # group's 768.
    crc = checksum.crc_constants(checksum.CRC_DEVICE_MAX_LEN)
    for nstreams in (12, 768):
        data = rand_u8((checksum.CRC_DEVICE_MAX_LEN, nstreams))
        got8 = ck.gf2_apply_u8(crc, data)
        ref8 = ck.gf2_apply_u8_plain(crc.plain_bm(dev), data)
        torch.cuda.synchronize()
        ok = torch.equal(got8, ref8)
        log(f"[exact] gf2_apply_u8 CRC contraction (4 x {crc.kin}) over "
            f"{nstreams} streams: bytes {tuple(data.shape)} -> equal={ok}")
        if not ok:
            raise AssertionError(f"gf2_apply_u8 != plain version on the CRC "
                                 f"of {nstreams} streams")
        errs["gf2_apply_u8"] = max(errs["gf2_apply_u8"], max_err(got8, ref8))
    del data, got8, ref8

    # The encode-variant kernels (unblocked matrices only) and the lab's
    # copy kernel.
    edge = rng.integers(0, 256, GATE_EDGE, dtype=np.uint8)
    # The split2 kernels' last block of 512 units: a ragged length leaves
    # 145 word units (37 byte units) there, half 0 live only; 15537 words
    # and 62151 bytes leave 301 units each, both halves live, the last
    # unit partial.
    vcases = [
        # (label, coefficient matrix, words shape or None, bytes shape,
        #  base offset in bytes of both inputs)
        ("headline encode k=8 m=4", gen[K:], (K, n_bytes // 4), (K, n_bytes),
         0),
        ("decode 4 erasures", dec, (K, n_bytes // 4), (K, n_bytes), 0),
        ("ragged length", gen[K:], (K, 1_000_003), (K, 1_000_003), 0),
        ("last block, both halves live", gen[K:], (K, 15_537), (K, 62_151),
         0),
        ("gate edge 32x32", edge, (32, 1 << 18), (32, (1 << 20) + 5), 0),
        ("base 4 bytes off", dec, (K, 1 << 18), (K, 1 << 20), 4),
        ("(B, k, C) batch", gen[K:], None, (STRIPES, K, CHUNK), 0),
        ("(B, k, C) batch, gate edge", edge, None, (2048, 32, 4096 + 3), 0),
        ("(B, k, C) batch, C = 1001, base 4 bytes off", gen[K:], None,
         (4096, K, 1001), 4),
    ]

    def rand_at(shape, base) -> torch.Tensor:
        """Random bytes of ``shape`` starting ``base`` bytes past a 16-byte
        boundary (torch allocations are 16-byte aligned)."""
        return rand_u8((int(np.prod(shape)) + base,))[base:].view(shape)

    for label, coeff, wshape, bshape, base in vcases:
        consts = ck.ShardApply(coeff).consts
        if not ck.variant_applies(consts.kin, consts.mout):
            raise AssertionError(f"{label} is not an unblocked matrix")
        runs = []
        if wshape is not None:
            words = ck.bytes_to_words(
                rand_at(wshape[:-1] + (wshape[-1] * 4,), base))
            runs += [(name, fn, plain, consts.plain_bm32(dev), words)
                     for name, fn, plain in (
                         ("gf2_apply_words_cmp", ck.gf2_apply_words_cmp,
                          ck.gf2_apply_words_cmp_plain),
                         ("gf2_apply_words_split2", ck.gf2_apply_words_split2,
                          ck.gf2_apply_words_split2_plain))]
        runs.append(("gf2_apply_u8_split2", ck.gf2_apply_u8_split2,
                     ck.gf2_apply_u8_split2_plain, consts.plain_bm(dev),
                     rand_at(bshape, base)))
        for name, fn, plain, mat, arg in runs:
            got = fn(consts, arg)
            ref = plain(mat, arg)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref)
            log(f"[exact] {name} {label}: coeff {coeff.shape} input "
                f"{tuple(arg.shape)} {arg.dtype} -> equal={ok}")
            if not ok:
                raise AssertionError(f"{name} != plain version at {label}")
            errs[name] = max(errs[name], max_err(got, ref))
    errs["roof_copy_xor"] = 0

    def words_at(n, offset) -> torch.Tensor:
        """n random int32 words starting ``offset`` words past a 16-byte
        boundary."""
        return ck.bytes_to_words(rand_u8((4 * (n + offset),)))[offset:]

    # L1 at the headline and a ragged length, and at its edges: input and
    # output 4 bytes off 16-byte alignment (head, 16-byte units, tail), off
    # by different amounts (every word on the plain path), n = 1 and 3
    # (plain words only), under one block's units, one block and a
    # multiple of it.
    blk = L1_BLOCK_WORDS
    l1_cases = [
        ("headline (8, 2^21) words", (K, n_bytes // 4), 0, 0),
        ("ragged (8, 1000003) words", (K, 1_000_003), 0, 0),
        ("ragged, input and output 4 bytes off", (1_000_003,), 1, 1),
        ("ragged, input 4 and output 8 bytes off", (1_000_003,), 1, 2),
        ("ragged, input aligned and output 12 bytes off", (1_000_003,), 0,
         3),
        ("n = 1", (1,), 0, 0),
        ("n = 1, input and output 12 bytes off", (1,), 3, 3),
        ("n = 3", (3,), 0, 0),
        ("n = 3, input and output 4 bytes off", (3,), 1, 1),
        (f"n = {blk - 48}, under one block", (blk - 48,), 0, 0),
        (f"n = {blk - 48}, input and output 8 bytes off", (blk - 48,), 2, 2),
        (f"n = {blk}, one block", (blk,), 0, 0),
        (f"n = {4 * blk}, four blocks", (4 * blk,), 0, 0),
        (f"n = {4 * blk}, input 4 and output 12 bytes off", (4 * blk,), 1, 3),
    ]
    for label, shape, a, b in l1_cases:
        n = int(np.prod(shape))
        words = words_at(n, a).view(shape)
        out = words_at(n, b).view(shape)
        got = perf_lab.roof_copy_xor(words, out=out)
        ref = perf_lab.roof_copy_xor_plain(words)
        torch.cuda.synchronize()
        ok = got is out and torch.equal(got, ref)
        log(f"[exact] roof_copy_xor {label} -> equal={ok}")
        if not ok:
            raise AssertionError(f"roof_copy_xor != plain version at {label}")

    # B1 at each tile of the lab's sweep, and the lab's bit kernels.
    enc_consts = ck.ShardApply(gen[K:]).consts
    w32_consts = ck.ShardApply(packet32).consts
    for label, consts, shape in (
            ("headline (8, 2^21) words", enc_consts, (K, n_bytes // 4)),
            ("ragged (8, 1000003) words", enc_consts, (K, 1_000_003)),
            ("blocked w=32 (128, 65541) words", w32_consts, (128, 65_541))):
        words = ck.bytes_to_words(rand_u8(shape[:-1] + (shape[-1] * 4,)))
        ref = ck.gf2_apply_words_plain(consts.plain_bm32(dev), words)
        for tile in perf_lab.TILES:
            got = ck.gf2_apply_words(consts, words, tile=tile)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref)
            log(f"[exact] gf2_apply_words tile {tile} {label} -> equal={ok}")
            if not ok:
                raise AssertionError(f"B1 at tile {tile} != plain version "
                                     f"at {label}")
    errs["unpack_repack_words"] = errs["roof_matmul_s8"] = 0
    for label, shape in (("headline (8, 2^21) words", (K, n_bytes // 4)),
                         ("ragged (8, 1000003) words", (K, 1_000_003)),
                         ("ragged (3, 1001) words", (3, 1001))):
        words = ck.bytes_to_words(rand_u8(shape[:-1] + (shape[-1] * 4,)))
        got = perf_lab.unpack_repack_words(words)
        ref = perf_lab.unpack_repack_words_plain(words)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref) and torch.equal(got, words)
        log(f"[exact] unpack_repack_words {label} -> equal={ok}")
        if not ok:
            raise AssertionError(f"unpack_repack_words != plain version at "
                                 f"{label}")
    lab_a = torch.from_numpy(perf_lab.lab_bm32()).to(dev)
    n_bits = n_bytes // 4 // 8                          # the lab's N4 / 8

    def rand_s8(shape) -> torch.Tensor:
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(
            np.int8)).to(dev)

    for label, a, b in (
            ("lab bm32 x 0/1 bits (256, 262144)", lab_a, torch.from_numpy(
                rng.integers(0, 2, (256, n_bits)).astype(np.int8)).to(dev)),
            ("asymmetric int8 A x B (256, 262144)", rand_s8((128, 256)),
             rand_s8((256, n_bits))),
            ("asymmetric int8, ragged n = 100003", rand_s8((128, 256)),
             rand_s8((256, 100_003))),
            ("asymmetric int8, n = 5", rand_s8((128, 256)), rand_s8((256, 5)))):
        got = perf_lab.roof_matmul_s8(a, b)
        ref = perf_lab.roof_matmul_s8_plain(a, b)
        torch.cuda.synchronize()
        ok = torch.equal(got, ref)
        log(f"[exact] roof_matmul_s8 {label} -> equal={ok}")
        if not ok:
            raise AssertionError(f"roof_matmul_s8 != plain version at {label}")
    del vcases, runs, words, got, ref, a, b

    # The grouped kernels, on the CLAY repair operators probed on the card.
    reg = ErasureCodePluginRegistry()
    clay = reg.factory("clay", CLAY, device=dev)
    clay16 = reg.factory("clay", CLAY16, device=dev)
    R8, helpers8, planes8 = wall(
        "probe R, CLAY k=8 m=4 d=11", lambda: clay_repair_operator(
            clay, CLAY_LOST))
    R16, helpers16, planes16 = wall(
        "probe R, CLAY k=16 m=4 d=19", lambda: clay_repair_operator(
            clay16, CLAY16_LOST))
    plan8, plan16 = ck.GroupedPlan(R8), ck.GroupedPlan(R16)
    if not (plan8.profitable and plan8.fused and plan16.profitable
            and not plan16.fused):
        raise AssertionError("CLAY operators do not route as the JAX "
                             "applier routes them (B3 / B4)")
    sparse = np.zeros((30, 120), np.uint8)   # tests/test_pallas.py:193 case
    srng = np.random.default_rng(2)
    for i in range(30):
        sparse[i, srng.choice(120, size=9, replace=False)] = \
            srng.integers(1, 256, 9)
    plan_sparse = ck.GroupedPlan(sparse)
    padded = np.zeros((10, 96), np.uint8)    # 3 groups + the padding group
    prng = np.random.default_rng(3)
    for i in range(10):
        padded[i, prng.choice(96, size=5, replace=False)] = \
            prng.integers(1, 256, 5)
    plan_padded = ck.GroupedPlan(padded)
    if plan_padded.groups[-1] != []:
        raise AssertionError("the 10 x 96 plan has no pair-padding group")
    kin8 = R8.shape[1]
    n8 = CLAY_STRIPES * CLAY_SC
    gcases = [
        # (label, plan, input)
        ("CLAY k=8 m=4 d=11 R, words", plan8,
         ck.bytes_to_words(rand_u8((kin8, n8)))),
        ("CLAY k=8 m=4 d=11 R, (B, 176, sc) batch", plan8,
         rand_u8((CLAY_STRIPES, kin8, CLAY_SC))),
        ("CLAY k=16 m=4 d=19 R, (B, 4864, sc) batch", plan16,
         rand_u8((CLAY16_STRIPES, R16.shape[1], CLAY16_SC))),
        ("random sparse 30x120, short groups", plan_sparse,
         rand_u8((120, 1 << 16))),
        ("random sparse 10x96, pair-padding group", plan_padded,
         rand_u8((256, 96, 1001))),
        ("ragged length", plan8, rand_u8((kin8, 1_000_003))),
        ("CLAY k=8 m=4 d=11 R, (B, 176, 1001) batch, base 4 bytes off",
         plan8, rand_u8((64 * kin8 * 1001 + 4,))[4:].view(64, kin8, 1001)),
    ]
    for label, plan, data in gcases:
        gathered = data.index_select(data.ndim - 2, plan.gather_index(dev))
        for name, fn, plain, arg in (
                ("gf2_apply_grouped", ck.gf2_apply_grouped,
                 ck.gf2_apply_grouped_plain, data),
                ("gf2_apply_grouped_paired", ck.gf2_apply_grouped_paired,
                 ck.gf2_apply_grouped_paired_plain, gathered)):
            got = fn(plan, arg)
            ref = plain(plan, arg)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref)
            log(f"[exact] {name} {label}: R {plan.mout}x{plan.kin}, "
                f"G={len(plan.groups)} cmax={plan.cmax}, input "
                f"{tuple(arg.shape)} {arg.dtype} -> equal={ok}")
            if not ok:
                raise AssertionError(f"{name} != plain version at {label}")
            errs[name] = max(errs[name], max_err(got, ref))
    del gcases, data, gathered, got, ref
    for label, sec in walls.items():
        log(f"[wall] {label}: {sec:.3f} s (host clock, launch-bound plane "
            f"loops; outside every timed window)")

    def counts() -> dict:
        return dict(ck.LAUNCHES)

    def delta(before) -> dict:
        return {n: counts()[n] - before[n] for n in before}

    # -- 4a. the jax_rs main path, counted -----------------------------------
    ck.reset_launch_counts()
    for variant in ("", "auto"):
        ck.set_encode_variant(variant)
        before = counts()
        failures = corpus.check(device=dev)
        log(f"[corpus] variant {ck.get_encode_variant()!r}: "
            f"{len(corpus.archives())} archives, failures {failures}, "
            f"launches {delta(before)}")
        if failures or len(corpus.archives()) != 16:
            raise AssertionError(f"corpus check failed: {failures}")

    ck.set_encode_variant("")
    before = counts()
    t0 = time.perf_counter()
    combos = benchmark.verify_all_erasures(ec)
    log(f"[sweep] k=8 m=4 reed_sol_van: {combos} erasure patterns decoded "
        f"in {time.perf_counter() - t0:.1f}s, launches {delta(before)}")
    if combos != 793:
        raise AssertionError(f"expected 793 patterns, checked {combos}")

    def object_round_trip() -> None:
        """A 64 MiB object split into stripes, encoded, OBJECT_LOST dropped,
        decoded and merged back bit-identical; a parity shard rebuilt."""
        before = counts()
        info = StripeInfo(k=K, chunk_size=CHUNK)
        obj = rand_u8((64 << 20,))
        chunks = ec.encode_chunks_device(info.split_stripes(obj))
        avail = {i: chunks[:, i] for i in range(K + M)
                 if i not in OBJECT_LOST}
        lost_data = [i for i in OBJECT_LOST if i < K]
        rebuilt = ec.decode_chunks_device(avail, lost_data)
        stripes = chunks[:, :K].clone()
        for j, i in enumerate(lost_data):
            stripes[:, i] = rebuilt[:, j]
        back = info.merge_stripes(stripes)
        torch.cuda.synchronize()
        if not torch.equal(back, obj):
            raise AssertionError("64 MiB object did not round-trip")
        parity_ok = torch.equal(
            ec.decode_chunks_device(avail, [10])[:, 0], chunks[:, 10])
        if not parity_ok:
            raise AssertionError("rebuilt parity shard differs")
        log(f"[object] variant {ck.get_encode_variant()!r}: 64 MiB, "
            f"{chunks.shape[0]} stripes x {K}+{M} x {CHUNK} B, lost "
            f"{OBJECT_LOST}: bit-identical; launches {delta(before)}")

    # The object path under "auto", as an OSD selects it on the card.
    ck.set_encode_variant("auto")
    object_round_trip()

    # The headline word entries once each (the benchmark's path).
    ck.set_encode_variant("")
    data = rng.integers(0, 256, (STRIPES, K, CHUNK), dtype=np.uint8)
    words = benchmark.shard_words(ec, data)
    parity = ec.encode_words_device(words)
    full = torch.cat([words, parity], dim=0)
    surv = [i for i in range(K + M) if i not in HEADLINE_LOST][:K]
    rec = ec.decode_words_device({a: full[a] for a in surv}, HEADLINE_LOST)
    torch.cuda.synchronize()
    if not torch.equal(rec, full[HEADLINE_LOST]):
        raise AssertionError("headline words decode differs")
    rs_launches = counts()
    log(f"[main path: jax_rs] launches {rs_launches}")
    if rs_launches["gf2_apply_words"] == 0:
        raise AssertionError("kernel gf2_apply_words was not launched on the "
                             "jax_rs main path")

    # -- 4b. the repair main path (CLAY, LRC, SHEC), counted -----------------
    ck.reset_launch_counts()
    ck.set_encode_variant("auto")
    C8 = clay.sub_chunk_no * CLAY_SC
    data8 = rand_u8((CLAY_STRIPES, clay.k, C8))
    chunks8 = wall(f"CLAY k=8 encode, {CLAY_STRIPES} x {C8 >> 10} KiB",
                   lambda: clay.encode_chunks_device(data8))
    if not torch.equal(chunks8[:, :clay.k], data8):
        raise AssertionError("CLAY encode changed the data chunks")
    grouped_only = {n: int(n == "gf2_apply_grouped") for n in ck.LAUNCHES}
    for lost in range(clay.get_chunk_count()):
        R, helpers, planes = wall(
            "probe R, CLAY k=8 m=4 d=11 (x12)",
            lambda: clay_repair_operator(clay, lost))
        helper = helper_planes(clay, chunks8, helpers, planes, CLAY_SC)
        before = counts()
        got = batched_clay_plane_repair_device(clay, R, helper)
        torch.cuda.synchronize()
        if delta(before) != grouped_only:
            raise AssertionError(f"CLAY repair of {lost} launched "
                                 f"{delta(before)}, not one grouped kernel")
        if not torch.equal(got, chunks8[:, lost]):
            raise AssertionError(f"CLAY repair of chunk {lost} differs")
    log(f"[clay] k=8 m=4 d=11, {CLAY_STRIPES} stripes x {C8} B: all "
        f"{clay.get_chunk_count()} single-chunk repairs bit-identical, each "
        f"one gf2_apply_grouped launch (helper planes {tuple(helper.shape)})")
    del helper, got
    avail = {i: chunks8[:, i] for i in range(clay.get_chunk_count())
             if i not in CLAY_DECODE_LOST}
    got = wall("CLAY k=8 full decode, 4 erasures",
               lambda: clay.decode_chunks_device(avail, CLAY_DECODE_LOST))
    if not torch.equal(got, chunks8[:, CLAY_DECODE_LOST]):
        raise AssertionError("CLAY 4-erasure decode differs")
    log(f"[clay] k=8 full decode of {CLAY_DECODE_LOST}: bit-identical")
    del avail, got, data8

    C16 = clay16.sub_chunk_no * CLAY16_SC
    data16 = rand_u8((CLAY16_STRIPES, clay16.k, C16))
    chunks16 = wall(f"CLAY k=16 encode, {CLAY16_STRIPES} x {C16 >> 10} KiB",
                    lambda: clay16.encode_chunks_device(data16))
    helper16 = helper_planes(clay16, chunks16, helpers16, planes16,
                             CLAY16_SC)
    before = counts()
    got = batched_clay_plane_repair_device(clay16, R16, helper16)
    torch.cuda.synchronize()
    paired_only = {n: int(n == "gf2_apply_grouped_paired")
                   for n in ck.LAUNCHES}
    if delta(before) != paired_only:
        raise AssertionError(f"CLAY k=16 repair launched {delta(before)}, "
                             f"not one paired kernel")
    if not torch.equal(got, chunks16[:, CLAY16_LOST]):
        raise AssertionError("CLAY k=16 repair differs")
    log(f"[clay] k=16 m=4 d=19, {CLAY16_STRIPES} stripes x {C16} B: repair "
        f"of chunk {CLAY16_LOST} bit-identical, one gf2_apply_grouped_paired "
        f"launch (helper planes {tuple(helper16.shape)})")
    del data16, chunks16, got

    for plugin, profile, lost in (("lrc", {"k": "8", "m": "4", "l": "3"}, 1),
                                  ("shec", {"k": "4", "m": "3", "c": "2"}, 2)):
        codec = reg.factory(plugin, profile, device=dev)
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        cdata = rand_u8((256, k, codec.get_chunk_size(k * 4096)))
        enc = codec.encode_chunks_device(cdata)
        avail = {i: enc[:, i] for i in range(n) if i != lost}
        got = codec.decode_chunks_device(avail, [lost])[:, 0]
        ok = torch.equal(got, enc[:, lost])
        if plugin == "lrc":
            coeffs, minimum = lrc_repair_operator(codec, lost)
            local = batched_lrc_group_repair(
                codec, coeffs, enc[:, minimum].cpu().numpy())
            ok = ok and np.array_equal(local, enc[:, lost].cpu().numpy())
        log(f"[{plugin}] {profile}: {n} chunks of {enc.shape[2]} B x "
            f"{enc.shape[0]} stripes, chunk {lost} lost and rebuilt: "
            f"bit-identical={ok}")
        if not ok:
            raise AssertionError(f"{plugin} round trip differs")
    repair_launches = counts()
    log(f"[main path: repair] launches {repair_launches}")
    for name in ck.LAUNCHES:
        if repair_launches[name] == 0 and name.startswith("gf2_apply_grouped"):
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"repair main path")
    main_launches = dict(rs_launches)
    main_launches.update({n: repair_launches[n] for n in
                          ("gf2_apply_grouped", "gf2_apply_grouped_paired")})

    # -- 4c. the jax_rs path under each encode variant, counted -------------
    ck.reset_launch_counts()
    blocked = ck.ShardApply(packet16)       # 48 x 80: needs a blocked apply
    if ck.variant_applies(blocked.kin, blocked.mout):
        raise AssertionError("the w=16 packet matrix should be blocked")
    blocked_data = rand_u8((80, 1 << 16))
    for variant in ck.ENCODE_VARIANTS:
        ck.set_encode_variant(variant)
        before = counts()
        failures = corpus.check(device=dev)
        if failures or len(corpus.archives()) != 16:
            raise AssertionError(f"corpus check under {variant!r} failed: "
                                 f"{failures}")
        log(f"[corpus] variant {variant!r}: {len(corpus.archives())} "
            f"archives bit-identical, launches {delta(before)}")
        object_round_trip()
        launched = delta(before)
        kernel = ck.route(K, M, CHUNK)      # the variant's own kernel
        if launched[kernel] == 0:
            raise AssertionError(f"variant {variant!r} never launched "
                                 f"{kernel}")
        before = counts()
        got = blocked.apply_bytes(blocked_data)
        torch.cuda.synchronize()
        step = delta(before)
        if step != {n: int(n == "gf2_apply_words") for n in ck.LAUNCHES}:
            raise AssertionError(f"a blocked matrix under {variant!r} "
                                 f"launched {step}, not B1 once")
        if not torch.equal(got, ck.gf2_apply_u8_plain(
                blocked.consts.plain_bm(dev), blocked_data)):
            raise AssertionError(f"blocked apply under {variant!r} differs")
        log(f"[variant] {variant!r}: {kernel} launched {launched[kernel]} "
            f"times; the blocked 48x80 packet matrix took gf2_apply_words")
    variant_launches = counts()
    log(f"[main path: variants] launches {variant_launches}")
    for name in ("gf2_apply_words_cmp", "gf2_apply_words_split2",
                 "gf2_apply_u8_split2"):
        main_launches[name] = variant_launches[name]
    # B2 serves the jax_rs path's byte lengths that are not whole words and,
    # under enc_u8_expand, every unblocked apply: both paths count.
    main_launches["gf2_apply_u8"] += variant_launches["gf2_apply_u8"]
    if main_launches["gf2_apply_u8"] == 0:
        raise AssertionError("kernel gf2_apply_u8 was not launched on the "
                             "jax_rs or variants main path")
    ck.set_encode_variant("")

    # -- 4d. the perf lab, counted -------------------------------------------
    # Every experiment once through its entry, as ``python -m
    # ceph_tpu_torch.testing.perf_lab`` runs them: checked, then timed by
    # the device loop.  The path of the lab's kernels (L1-L3).
    ck.reset_launch_counts()
    perf_lab.reset_launch_counts()
    lab = {}
    for name in perf_lab.EXPERIMENTS:
        lab[name] = perf_lab.run_experiment(name)
        log(f"[lab] {json.dumps(lab[name])}")
    lab_launches = dict(perf_lab.LAUNCHES)
    log(f"[main path: lab] launches {lab_launches}, {counts()}")
    for name, n in list(lab_launches.items()) + [
            (k, counts()[k]) for k in (
                "gf2_apply_words", "gf2_apply_words_cmp", "gf2_apply_u8",
                "gf2_apply_words_split2", "gf2_apply_u8_split2",
                "gf2_apply_grouped")]:
        if n == 0:
            raise AssertionError(f"the lab never launched {name}")
    main_launches.update(lab_launches)

    # -- 5. timing -----------------------------------------------------------
    def bound(nbytes, ops):
        """(seconds, "bytes" | "operations"): the larger of bytes over the
        HBM rate and operations over the int8 tensor-core rate."""
        b_s, o_s = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
        return max(b_s, o_s), ("bytes" if b_s >= o_s else "operations")

    def time_it(fn, iterations=20, runs=5):
        return benchmark.cuda_seconds_per_call(fn, iterations, runs)

    data_bytes = K * n_bytes
    par_bytes = M * n_bytes
    bm = gf_matrix_to_bitmatrix(gen[K:])
    table_bytes = 4 * 8 * M * K
    # the per-byte bit-plane contraction: (8m x 8k) 0/1 matrix x 8k bits per
    # byte column, on int8 tensor cores
    ops = 2 * bm.shape[0] * bm.shape[1] * n_bytes
    b1_bytes = data_bytes + par_bytes + table_bytes
    bound_s, bound_by = bound(b1_bytes, ops)
    log(f"[bound] jax_rs headline: {data_bytes} B in + {par_bytes} B out + "
        f"{table_bytes} B table, {ops} int8 ops -> bound "
        f"{bound_s * 1e6:.2f} us ({bound_by})")

    def grouped_bound(plan, n, gathered):
        """Bound of one grouped apply over n byte columns: the rows it
        reads (the union of supports, or every gathered support row) and
        writes, its constants, and the bit-plane contraction over the real
        rows and support columns of each group."""
        sup = [plan.cols[g, :plan.ncols[g]] for g in range(len(plan.groups))]
        rows_read = (sum(len(c) for c in sup) if gathered
                     else len(set(np.concatenate(sup).tolist())))
        consts = sum(t.numel() * t.element_size()
                     for t in plan.tensors(dev))
        nbytes = (rows_read + plan.mout) * n + consts
        gops = 2 * sum(8 * len(rows) * 8 * len(c)
                       for rows, c in zip(plan.groups, sup)) * n
        return (*bound(nbytes, gops), nbytes, gops)

    enc_ap = ck.ShardApply(gen[K:])
    dec_ap = ck.ShardApply(dec)
    stream = ck.words_to_bytes(words)        # (k, N) bytes view
    dec_words = full[surv]
    dec_stream = ck.words_to_bytes(dec_words)
    # the CLAY headline repair's inputs: R8's helper planes of one repair
    # batch, as the bench's (176, N) shard layout and as the (B, 176, sc)
    # batch batched_clay_plane_repair reads; the k=16 gathered input
    helper8 = helper_planes(clay, chunks8, helpers8, planes8, CLAY_SC)
    shard8 = helper8.permute(1, 0, 2).reshape(kin8, n8).contiguous()
    shard8_words = ck.bytes_to_words(shard8)
    gathered16 = helper16.index_select(1, plan16.gather_index(dev))
    dense8 = ck.ShardApply(R8)
    b3_s, b3_by, b3_bytes, b3_ops = grouped_bound(plan8, n8, False)
    b4_s, b4_by, b4_bytes, b4_ops = grouped_bound(
        plan16, CLAY16_STRIPES * CLAY16_SC, True)
    # L1 reads and writes the (8, 2^21) words once each, one op per word
    copy_s = 2 * data_bytes / HBM_BYTES_PER_S
    log(f"[bound] copy roof: {2 * data_bytes} B -> {copy_s * 1e6:.2f} us "
        f"(bytes)")
    # L3 reads the bits and bm32 and writes the int32 product; its ops are
    # the int8 multiply-adds of the contraction
    bits_bytes = 256 * n_bits
    mm_bytes = bits_bytes + 128 * 256 + 4 * 128 * n_bits
    mm_ops = 2 * 128 * 256 * n_bits
    mm_s, mm_by = bound(mm_bytes, mm_ops)
    log(f"[bound] L2 unpack_repack_words: {2 * data_bytes} B -> "
        f"{copy_s * 1e6:.2f} us (bytes); L3 roof_matmul_s8: {mm_bytes} B, "
        f"{mm_ops} int8 ops ({mm_ops / INT8_OPS_PER_S * 1e6:.2f} us) -> "
        f"{mm_s * 1e6:.2f} us ({mm_by})")
    log(f"[bound] CLAY k=8 repair, B3: {b3_bytes} B, {b3_ops} int8 ops -> "
        f"{b3_s * 1e6:.2f} us ({b3_by}); CLAY k=16 repair, B4: {b4_bytes} B, "
        f"{b4_ops} int8 ops -> {b4_s * 1e6:.2f} us ({b4_by})")

    lab_bits = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (256, n_bits), np.int8)).to(dev)
    unpack_out = torch.empty_like(words)
    mm_out = torch.empty((128, n_bits), dtype=torch.int32, device=dev)
    rows = [
        # (kernel, label, kernel call, plain call or None, bound seconds, by)
        ("gf2_apply_words", "encode words", lambda: enc_ap.apply_words(words),
         lambda: ck.gf2_apply_words_plain(enc_ap.consts.plain_bm32(dev),
                                          words), bound_s, bound_by),
        ("gf2_apply_words", "decode 4 erasures words",
         lambda: dec_ap.apply_words(dec_words),
         lambda: ck.gf2_apply_words_plain(dec_ap.consts.plain_bm32(dev),
                                          dec_words), bound_s, bound_by),
        ("gf2_apply_u8", "encode bytes",
         lambda: ck.gf2_apply_u8(enc_ap.consts, stream),
         lambda: ck.gf2_apply_u8_plain(enc_ap.consts.plain_bm(dev), stream),
         bound_s, bound_by),
        ("gf2_apply_u8", "decode 4 erasures bytes",
         lambda: ck.gf2_apply_u8(dec_ap.consts, dec_stream),
         lambda: ck.gf2_apply_u8_plain(dec_ap.consts.plain_bm(dev),
                                       dec_stream), bound_s, bound_by),
        ("gf2_apply_words_cmp", "encode words",
         lambda: ck.gf2_apply_words_cmp(enc_ap.consts, words),
         lambda: ck.gf2_apply_words_cmp_plain(enc_ap.consts.plain_bm32(dev),
                                              words), bound_s, bound_by),
        ("gf2_apply_words_cmp", "decode 4 erasures words",
         lambda: ck.gf2_apply_words_cmp(dec_ap.consts, dec_words),
         lambda: ck.gf2_apply_words_cmp_plain(dec_ap.consts.plain_bm32(dev),
                                              dec_words), bound_s, bound_by),
        ("gf2_apply_words_split2", "encode words",
         lambda: ck.gf2_apply_words_split2(enc_ap.consts, words),
         lambda: ck.gf2_apply_words_split2_plain(
             enc_ap.consts.plain_bm32(dev), words), bound_s, bound_by),
        ("gf2_apply_words_split2", "decode 4 erasures words",
         lambda: ck.gf2_apply_words_split2(dec_ap.consts, dec_words),
         lambda: ck.gf2_apply_words_split2_plain(
             dec_ap.consts.plain_bm32(dev), dec_words), bound_s, bound_by),
        ("gf2_apply_u8_split2", "encode bytes",
         lambda: ck.gf2_apply_u8_split2(enc_ap.consts, stream),
         lambda: ck.gf2_apply_u8_split2_plain(enc_ap.consts.plain_bm(dev),
                                              stream), bound_s, bound_by),
        ("gf2_apply_u8_split2", "decode 4 erasures bytes",
         lambda: ck.gf2_apply_u8_split2(dec_ap.consts, dec_stream),
         lambda: ck.gf2_apply_u8_split2_plain(dec_ap.consts.plain_bm(dev),
                                              dec_stream), bound_s, bound_by),
        ("roof_copy_xor", "headline (8, 2^21) words",
         lambda: perf_lab.roof_copy_xor(words),
         lambda: perf_lab.roof_copy_xor_plain(words), copy_s, "bytes"),
        ("unpack_repack_words", "headline (8, 2^21) words",
         lambda: perf_lab.unpack_repack_words(words, out=unpack_out),
         lambda: perf_lab.unpack_repack_words_plain(words), copy_s, "bytes"),
        ("roof_matmul_s8", "lab bm32 x 0/1 bits (256, 262144)",
         lambda: perf_lab.roof_matmul_s8(lab_a, lab_bits, out=mm_out),
         lambda: perf_lab.roof_matmul_s8_plain(lab_a, lab_bits), mm_s,
         mm_by),
    ] + [
        ("gf2_apply_words", f"encode words, tile {tile}",
         functools.partial(ck.gf2_apply_words, enc_ap.consts, words,
                           tile=tile), None, bound_s, bound_by)
        for tile in perf_lab.TILES
    ] + [
        # B3's first row is the main path's layout, the (B, 176, sc) batch
        # batched_clay_plane_repair_device reads
        ("gf2_apply_grouped", "CLAY k=8 repair, (B, 176, sc) batch",
         lambda: ck.gf2_apply_grouped(plan8, helper8),
         lambda: ck.gf2_apply_grouped_plain(plan8, helper8), b3_s, b3_by),
        ("gf2_apply_grouped", "CLAY k=8 repair, (176, N) bytes",
         lambda: ck.gf2_apply_grouped(plan8, shard8),
         lambda: ck.gf2_apply_grouped_plain(plan8, shard8), b3_s, b3_by),
        ("gf2_apply_grouped", "CLAY k=8 repair, (176, N4) words",
         lambda: ck.gf2_apply_grouped(plan8, shard8_words),
         lambda: ck.gf2_apply_grouped_plain(plan8, shard8_words), b3_s,
         b3_by),
        ("gf2_apply_grouped_paired", "CLAY k=16 repair, gathered batch",
         lambda: ck.gf2_apply_grouped_paired(plan16, gathered16),
         lambda: ck.gf2_apply_grouped_paired_plain(plan16, gathered16),
         b4_s, b4_by),
    ]
    times = {}
    library = {}
    row_s = {}                      # (kernel, label) -> kernel seconds
    for name, label, kern, plain, b_s, b_by in rows:
        if plain is None:           # a second launch shape of a kernel
            kern_s, kern_s2 = time_it(kern), time_it(kern)
            k_s = min(kern_s, kern_s2)
            row_s[name, label] = k_s
            log(f"[time] {name} {label}: {k_s * 1e6:.2f} us (runs "
                f"{kern_s * 1e6:.2f}, {kern_s2 * 1e6:.2f} us), bound "
                f"{b_s * 1e6:.2f} us ({b_by}) = {100 * b_s / k_s:.1f}% of "
                f"bound; phase 4 launches {main_launches[name]}")
            continue
        plain_s = time_it(plain, iterations=2, runs=3)
        kern_s = time_it(kern)
        kern_s2 = time_it(kern)
        plain_s2 = time_it(plain, iterations=2, runs=3)
        k_s, p_s = min(kern_s, kern_s2), min(plain_s, plain_s2)
        row_s[name, label] = k_s
        times.setdefault(name, (k_s, p_s, b_s, b_by))
        log(f"[time] {name} {label}: {k_s * 1e6:.2f} us (runs "
            f"{kern_s * 1e6:.2f}, {kern_s2 * 1e6:.2f} us), bound "
            f"{b_s * 1e6:.2f} us ({b_by}) = {100 * b_s / k_s:.1f}% of "
            f"bound; plain {p_s * 1e3:.3f} ms; phase 4 launches "
            f"{main_launches[name]}")
    def interleaved(fns: dict) -> dict:
        """label -> its INTERLEAVED_ROUNDS readings (``time_it``), the
        labels timed in turn, forward in even rounds and backward in odd
        ones, so that a drift of the card's clock falls on all alike."""
        got = {label: [] for label in fns}
        order = list(fns)
        for r in range(INTERLEAVED_ROUNDS):
            for label in (order if r % 2 == 0 else order[::-1]):
                got[label].append(time_it(fns[label]))
        return got

    def versus(label, a, b, got) -> tuple[float, float]:
        """Log and return the best readings of a and b from one
        ``interleaved`` loop, with the rounds in which b was faster."""
        ra, rb = got[a], got[b]
        wins = sum(y < x for x, y in zip(ra, rb))
        log(f"[time] interleaved {label}: {a} best {min(ra) * 1e6:.2f} us "
            f"(readings {[round(x * 1e6, 2) for x in ra]}), {b} best "
            f"{min(rb) * 1e6:.2f} us (readings "
            f"{[round(x * 1e6, 2) for x in rb]}): {b}/{a} = "
            f"{min(rb) / min(ra):.4f}, {b} faster in {wins} of "
            f"{len(ra)} rounds")
        return min(ra), min(rb)

    # L1's yardstick: one PyTorch call computing the same function, timed
    # in turn with L1, and B1's encode in the same loop, so that B1's rate
    # is read against the copy ceiling measured beside it.
    copy_loop = interleaved({
        "roof_copy_xor": lambda: perf_lab.roof_copy_xor(words),
        "torch.bitwise_xor": lambda: torch.bitwise_xor(words, 1),
        "B1 encode": lambda: ck.gf2_apply_words(enc_ap.consts, words)})
    l1_best, xor_s = versus("copy roof, headline (8, 2^21) words",
                            "roof_copy_xor", "torch.bitwise_xor", copy_loop)
    library["roof_copy_xor"] = xor_s
    ceiling = 2 * data_bytes / l1_best
    b1_rate = b1_bytes / min(copy_loop["B1 encode"])
    log(f"[time] torch.bitwise_xor(words, 1), the copy roof's library call: "
        f"{xor_s * 1e6:.2f} us = {100 * copy_s / xor_s:.1f}% of bound; "
        f"measured copy ceiling {ceiling / 1e12:.3f} TB/s (L1) against the "
        f"data sheet's {HBM_BYTES_PER_S / 1e12:.2f}; L1 "
        f"{'no slower' if l1_best <= xor_s else 'slower'} than the library "
        f"call")
    log(f"[time] B1 encode in the copy roof's loop: best "
        f"{min(copy_loop['B1 encode']) * 1e6:.2f} us, {b1_bytes} B at "
        f"{b1_rate / 1e12:.3f} TB/s = {100 * b1_rate / ceiling:.1f}% of the "
        f"measured copy ceiling, {100 * b1_rate / HBM_BYTES_PER_S:.1f}% of "
        f"the data sheet's")
    # One row load in flight per thread (B1, B2) against two (the split2
    # kernels, two units per thread), same bytes, one loop.
    split2_pairs = interleaved({
        "B1 encode": lambda: ck.gf2_apply_words(enc_ap.consts, words),
        "B5b encode": lambda: ck.gf2_apply_words_split2(enc_ap.consts, words),
        "B1 decode": lambda: ck.gf2_apply_words(dec_ap.consts, dec_words),
        "B5b decode": lambda: ck.gf2_apply_words_split2(dec_ap.consts,
                                                        dec_words),
        "B2 encode": lambda: ck.gf2_apply_u8(enc_ap.consts, stream),
        "B5c encode": lambda: ck.gf2_apply_u8_split2(enc_ap.consts, stream),
        "B2 decode": lambda: ck.gf2_apply_u8(dec_ap.consts, dec_stream),
        "B5c decode": lambda: ck.gf2_apply_u8_split2(dec_ap.consts,
                                                     dec_stream)})
    for one, two in (("B1", "B5b"), ("B2", "B5c")):
        for op in ("encode", "decode"):
            versus(f"{op}, headline bytes", f"{one} {op}", f"{two} {op}",
                   split2_pairs)
    # L2's yardstick: x.clone(), the one PyTorch call computing its
    # function (a copy).  L3's: torch._int_mm, int8 x int8 -> int32 through
    # cuBLASLt, on B as it lies if it takes that layout, else on a
    # column-major copy of B made outside the timed call.
    clone_s = min(time_it(lambda: words.clone()),
                  time_it(lambda: words.clone()))
    library["unpack_repack_words"] = clone_s
    l2_s = times["unpack_repack_words"][0]
    log(f"[time] words.clone(), L2's library call: {clone_s * 1e6:.2f} us "
        f"= {100 * copy_s / clone_s:.1f}% of bound; L2 "
        f"{l2_s * 1e6:.2f} us = {l2_s / clone_s:.3f}x clone")
    # B1's yardsticks: B5a, the fastest other formulation, in this run, and
    # the bit-spread B1 that the field-table design replaced.
    b1_s = times["gf2_apply_words"][0]
    b5a_s = times["gf2_apply_words_cmp"][0]
    log(f"[time] B1 field tables, headline encode: {b1_s * 1e6:.2f} us "
        f"({b1_per_word:.2f} SASS instructions per input word) against B5a "
        f"{b5a_s * 1e6:.2f} us in this run ({b1_s / b5a_s:.3f}x) and the "
        f"bit-spread B1's {B1_OLD_US} us ({b1_s * 1e6 / B1_OLD_US:.3f}x)")
    # B2-B5c on field tables beside their bit-spread times and B1.
    for label, sec, old, per_word in (
            ("B2 field tables, headline encode bytes",
             row_s["gf2_apply_u8", "encode bytes"], B2_OLD_US,
             row_loops["B2"]),
            ("B3 field tables, CLAY k=8 repair (176, N) bytes",
             row_s["gf2_apply_grouped", "CLAY k=8 repair, (176, N) bytes"],
             B3_OLD_US, row_loops["B3 bytes"]),
            ("B3 field tables, CLAY k=8 repair (B, 176, sc) batch",
             row_s["gf2_apply_grouped",
                   "CLAY k=8 repair, (B, 176, sc) batch"], B3_OLD_US,
             row_loops["B3 bytes"]),
            ("B4 field tables, CLAY k=16 repair", times[
                "gf2_apply_grouped_paired"][0], B4_OLD_US,
             row_loops["B4 bytes"]),
            ("B5b field tables, two units, headline encode words",
             row_s["gf2_apply_words_split2", "encode words"], B5B_OLD_US,
             row_loops["B5b"]),
            ("B5c field tables, two units, headline encode bytes",
             row_s["gf2_apply_u8_split2", "encode bytes"], B5C_OLD_US,
             row_loops["B5c"])):
        log(f"[time] {label}: {sec * 1e6:.2f} us ({per_word:.2f} SASS "
            f"instructions per input word) against the bit spread's {old} us "
            f"({sec * 1e6 / old:.3f}x) and B1's {b1_s * 1e6:.2f} us in this "
            f"run")
    try:
        int_mm = torch._int_mm(lab_a, lab_bits)
        mm_layout = "B (256, n) row-major, as the kernel reads it"
        mm_arg = lab_bits
    except RuntimeError as e:
        log(f"[time] torch._int_mm refuses B row-major ({e}); timing it on "
            f"a column-major copy of B")
        mm_arg = lab_bits.t().contiguous().t()
        int_mm = torch._int_mm(lab_a, mm_arg)
        mm_layout = "B (256, n) column-major (n-major storage)"
    torch.cuda.synchronize()
    if not torch.equal(int_mm, mm_out):
        raise AssertionError("torch._int_mm disagrees with roof_matmul_s8")
    int_mm_s = min(time_it(lambda: torch._int_mm(lab_a, mm_arg)),
                   time_it(lambda: torch._int_mm(lab_a, mm_arg)))
    library["roof_matmul_s8"] = int_mm_s
    log(f"[time] torch._int_mm(A, B), L3's library call on {mm_layout}: "
        f"{int_mm_s * 1e6:.2f} us = {100 * mm_s / int_mm_s:.1f}% of bound")
    del int_mm, mm_arg
    # Host time per call: the host clock over back-to-back calls with no
    # synchronise between them, i.e. what one call costs to enqueue.  A
    # step whose enqueue time reaches its device time is host-bound.
    def enqueue_s(fn, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sec = (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return sec

    lab_words = words.clone()
    roof_step = perf_lab.carry_step(perf_lab.roof_copy_xor)
    cmp_step = perf_lab.carry_step(
        lambda w: ck.gf2_apply_words_cmp(enc_ap.consts, w))
    for label, fn in (
            ("gf2_apply_words", lambda: ck.gf2_apply_words(enc_ap.consts,
                                                           words)),
            ("gf2_apply_words_cmp", lambda: ck.gf2_apply_words_cmp(
                enc_ap.consts, words)),
            ("roof_copy_xor", lambda: perf_lab.roof_copy_xor(words)),
            ("torch.bitwise_xor", lambda: torch.bitwise_xor(words, 1)),
            ("lab step roof_copy", lambda: roof_step(lab_words)),
            ("lab step enc_cmp_expand", lambda: cmp_step(lab_words))):
        s1, s2 = enqueue_s(fn), enqueue_s(fn)
        log(f"[host] {label}: {min(s1, s2) * 1e6:.2f} us to enqueue one call "
            f"(host clock, runs {s1 * 1e6:.2f}, {s2 * 1e6:.2f} us)")
    del lab_words
    # Beside the grouped kernels: the dense kernels on the same CLAY
    # operator (what grouping saves), the paired route's gather alone, and
    # the fused kernel on the k=16 operator the paired route serves.
    beside = {}
    for label, fn, b_s in (
            ("gf2_apply_u8 (dense) on CLAY k=8 R, (176, N) bytes",
             lambda: ck.gf2_apply_u8(dense8.consts, shard8), b3_s),
            ("gf2_apply_words (dense) on CLAY k=8 R, (176, N4) words",
             lambda: ck.gf2_apply_words(dense8.consts, shard8_words), b3_s),
            ("index_select gather of the paired route, CLAY k=16",
             lambda: helper16.index_select(1, plan16.gather_index(dev)),
             (helper16.numel() + gathered16.numel()) / HBM_BYTES_PER_S),
            ("gf2_apply_grouped (fused) on CLAY k=16 R, (B, 4864, sc) batch",
             lambda: ck.gf2_apply_grouped(plan16, helper16),
             grouped_bound(plan16, CLAY16_STRIPES * CLAY16_SC, False)[0])):
        s1, s2 = time_it(fn, iterations=5), time_it(fn, iterations=5)
        beside[label] = min(s1, s2)
        log(f"[time] {label}: {min(s1, s2) * 1e6:.2f} us (runs "
            f"{s1 * 1e6:.2f}, {s2 * 1e6:.2f} us), bound {b_s * 1e6:.2f} us "
            f"= {100 * b_s / min(s1, s2):.1f}% of bound")
    # End to end through the entries (allocation, gather included), each
    # beside the bound of the function it computes.
    entries = [
        ("", "encode_words_device", data_bytes, bound_s,
         lambda: ec.encode_words_device(words)),
        ("", "decode_words_device", data_bytes, bound_s,
         lambda: ec.decode_words_device({a: full[a] for a in surv},
                                        HEADLINE_LOST)),
        ("auto", "encode_shards_device", data_bytes, bound_s,
         lambda: ec.encode_shards_device(stream)),
        ("auto", "batched_clay_plane_repair_device, CLAY k=8 (B3)",
         CLAY_STRIPES * C8, b3_s,
         lambda: batched_clay_plane_repair_device(clay, R8, helper8)),
        ("auto", "batched_clay_plane_repair_device, CLAY k=16 (gather + B4)",
         CLAY16_STRIPES * C16,
         grouped_bound(plan16, CLAY16_STRIPES * CLAY16_SC, False)[0],
         lambda: batched_clay_plane_repair_device(clay16, R16, helper16)),
    ]
    entry_s = {}
    for variant, label, nbytes, b_s, fn in entries:
        ck.set_encode_variant(variant)
        sec = entry_s[label] = time_it(fn)
        log(f"[time] entry {label} (variant {ck.get_encode_variant()!r}): "
            f"{sec * 1e6:.2f} us, {nbytes / sec / 2**30:.2f} GiB/s of "
            f"{'recovered data' if 'clay' in label else 'data'}; bound "
            f"{b_s * 1e6:.2f} us = {100 * b_s / sec:.1f}% of bound")
    # The k=16 repair entry beside what it launches: the gather and B4 (the
    # engine resolves R16's applier once, so no copy or hash of its 5 MB).
    gather_s = beside["index_select gather of the paired route, CLAY k=16"]
    k16_s = entry_s["batched_clay_plane_repair_device, CLAY k=16 (gather + B4)"]
    b4_s_run = times["gf2_apply_grouped_paired"][0]
    log(f"[time] entry CLAY k=16 repair {k16_s * 1e6:.2f} us against gather "
        f"{gather_s * 1e6:.2f} + B4 {b4_s_run * 1e6:.2f} = "
        f"{(gather_s + b4_s_run) * 1e6:.2f} us in this run "
        f"({k16_s / (gather_s + b4_s_run):.3f}x)")
    ck.set_encode_variant("")
    for label, sec in walls.items():
        log(f"[wall] {label}: {sec:.3f} s")

    # The OSD path's device CRC: B2 with the CRC's (32, 8L) bitmatrix as a
    # (4 x L) contraction over the streams' (L, B) transpose, at the write
    # path's 12 streams of 64 KiB and the scrub group's 64 x 12; then the
    # scrub verdict (parity compare, CRC, both copied to the host) at the
    # scrub group's shape.  Bound: the streams read and the registers
    # written once (the 5 MiB of field tables aside), or the bit-plane
    # contraction's int8 operations.
    for nrows in (12, 768):
        streams = rand_u8((nrows, checksum.CRC_DEVICE_MAX_LEN))
        L = streams.shape[1]
        c_s = time_it(lambda: checksum.crc_bits_device(streams),
                      iterations=3, runs=3)
        c_bound, c_by = bound(nrows * L + 4 * nrows, 2 * 32 * 8 * L * nrows)
        log(f"[time] crc_bits_device ({nrows}, {L}): {c_s * 1e6:.2f} us, "
            f"bound {c_bound * 1e6:.2f} us ({c_by}) = "
            f"{100 * c_bound / c_s:.2f}% of bound")
    stored = streams.reshape(64, 12, L)
    recomputed = stored.clone()
    v_s = time_it(lambda: checksum.verify_batch(recomputed, stored),
                  iterations=3, runs=3)
    v_bound, v_by = bound(2 * stored.numel() + 5 * 64 * 12,
                          2 * 32 * 8 * L * 768)
    log(f"[time] verify_batch (64, 12, {L}): {v_s * 1e6:.2f} us (parity "
        f"compare + B2 CRC + copies to the host), bound "
        f"{v_bound * 1e6:.2f} us ({v_by}) = {100 * v_bound / v_s:.2f}% of "
        f"bound")
    del streams, stored, recomputed

    # The repair of the lab's timer: its roof_copy step through the old
    # timer (CUDA events around steps issued from Python, host-bound for a
    # kernel this short) beside the device loop's reading and L1 alone.
    _, lab_words = perf_lab._data(dev)
    copy_out = torch.empty_like(lab_words)
    old_step = perf_lab.carry_step(
        lambda w: perf_lab.roof_copy_xor(w, out=copy_out))
    old_s = time_it(lambda: old_step(lab_words))
    loop_s = lab["roof_copy"]["sec"]
    l1_s = times["roof_copy_xor"][0]
    log(f"[lab] roof_copy step: device loop {loop_s * 1e6:.2f} us "
        f"({100 * (loop_s / l1_s - 1):+.1f}% against L1 alone, "
        f"{l1_s * 1e6:.2f} us); old timer {old_s * 1e6:.2f} us")
    for name in ("unpack_only", "roof_matmul"):
        log(f"[lab] {name} step: device loop "
            f"{lab[name]['sec'] * 1e6:.2f} us")
    del lab_words, copy_out

    # -- 6. the OSD path, counted ---------------------------------------------
    # ECBackend over 12 MemStore shards: the coalesced launcher, the
    # resident write-back cache, hinfo by the device CRC, batched scrub and
    # repair (osd_phase).  B1 carries every encode and decode, B2 the CRC.
    # It runs after phase 5's timings, so its host state (a large Python
    # heap, the allocator's cache) cannot move the eager readings.
    ck.reset_launch_counts()
    osd = osd_phase(dev, SEED)
    osd_launches = counts()
    log(f"[main path: osd] launches {osd_launches}; {len(osd['waves'])} "
        f"waves in {osd['seconds']:.2f} s (budget {OSD_BUDGET_S:.0f} s)")
    for name in ("gf2_apply_words", "gf2_apply_u8"):
        if osd_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"OSD main path")
        main_launches[name] += osd_launches[name]
    if osd["seconds"] > OSD_BUDGET_S:
        raise AssertionError(f"the OSD phase took {osd['seconds']:.1f} s")

    # -- 7. result lines ------------------------------------------------------
    replaces = {
        "gf2_apply_words": "ceph_tpu/ec/pallas_kernels.py:96",
        "gf2_apply_u8": "ceph_tpu/ec/pallas_kernels.py:199",
        "gf2_apply_words_cmp": "ceph_tpu/ec/pallas_kernels.py:166",
        "gf2_apply_words_split2": "ceph_tpu/ec/pallas_kernels.py:181",
        "gf2_apply_u8_split2": "ceph_tpu/ec/pallas_kernels.py:216",
        "gf2_apply_grouped": "ceph_tpu/ec/pallas_kernels.py:429",
        "gf2_apply_grouped_paired": "ceph_tpu/ec/pallas_kernels.py:495",
        "roof_copy_xor": "ceph_tpu/testing/perf_lab.py:150",
        "unpack_repack_words": "ceph_tpu/testing/perf_lab.py:189",
        "roof_matmul_s8": "ceph_tpu/testing/perf_lab.py:235",
    }
    sources = {
        "gf2_apply_words": "ceph_tpu_torch/csrc/gf2_apply.cu",
        "gf2_apply_u8": "ceph_tpu_torch/csrc/gf2_apply.cu",
        "gf2_apply_words_cmp": "ceph_tpu_torch/csrc/gf2_variants.cu",
        "gf2_apply_words_split2": "ceph_tpu_torch/csrc/gf2_variants.cu",
        "gf2_apply_u8_split2": "ceph_tpu_torch/csrc/gf2_variants.cu",
        "gf2_apply_grouped": "ceph_tpu_torch/csrc/gf2_grouped.cu",
        "gf2_apply_grouped_paired": "ceph_tpu_torch/csrc/gf2_grouped.cu",
        "roof_copy_xor": "ceph_tpu_torch/csrc/lab_copy.cu",
        "unpack_repack_words": "ceph_tpu_torch/csrc/lab_bits.cu",
        "roof_matmul_s8": "ceph_tpu_torch/csrc/lab_bits.cu",
    }
    kernels = []
    for name in list(ck.LAUNCHES) + list(perf_lab.LAUNCHES):
        k_s, p_s, b_s, b_by = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": main_launches[name],
            "exact": True,          # phase 3 raised on any difference
            "max_abs_err": errs[name],
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
            "bound_ms": b_s * 1e3, "bound_by": b_by,
            "library_ms": (library[name] * 1e3 if name in library
                           else None),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
