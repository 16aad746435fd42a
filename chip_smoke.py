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
   matrices, and the OSD path's device CRC (``checksum.CrcPlan``, B2's
   split-L launches) over 12 and 768 streams of 64 KiB against its plain
   version and the host crc32c; the encode-variant kernels at the headline
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
   device CRC at the write path's 12 streams and the scrub group's 768
   (a "[crc]" JSON line each: its B2 launches, time, enqueue time, plain
   version, PR 9's one-launch form and the JAX package's bf16-matmul form
   as the library yardstick, bound), and the scrub verdict
   ``verify_batch``;
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
   wave's wall time, client GiB/s, launches and device share printed;
   then (c) durable EC with backfill: the same pool on 12 ``WalStore``s
   (the native WAL tier asserted) under a temporary directory, 64 objects
   of 4 MiB written concurrently, every store unmounted and mounted fresh
   and the objects read back, shard 2 moved to a fresh WalStore and
   drained by ``BackfillEngine.drain_pg`` through the repair scheduler
   (class ``backfill``; 64 objects, its bytes and hinfo equal to the old
   store's), and every object read with shards 0, 1, 3 and 4 down through
   the moved shard; then (d) a map-driven backfill on the Ceph docs' 8+4
   deployment (12 hosts of 4 OSDs, one pool of 512 PGs): the port's CRUSH
   maps every PG through ``OSDMap.mapping()`` (each up set on distinct
   hosts, the table equal to the scalar walk), osd.17 is marked out
   through an ``Incremental``, ``PoolTables.diff`` names the moved PGs
   (every PG that held it among them) and ``backfill.plan_motion`` groups
   them; 64 objects of 4 MiB that ``object_to_ps`` sends to one moved PG
   are written to 12 WalStores in its old up order, the changed shard
   positions drained by ``BackfillEngine.drain_pg`` onto their new OSDs'
   stores, osd.17's store deleted and everything read back (bytes, each
   rebuilt shard and hinfo exact, ``backfill_objects`` 64); then (e) the
   same deployment committed by a quorum of three port ``Monitor``s
   (``mon_map_wave``): 48 OSDs boot through ``MonClient.send_boot``, a
   port ``Rados`` client injects (d)'s CRUSH map (``osd setcrushmap``),
   sets the 8+4 profile and creates the pool of 512 PGs, and its map at
   the pool's epoch must give (d)'s table row for row; ``osd out 17``
   through the client, and the epoch its subscription delivers must move
   exactly (d)'s PGs with (d)'s rows and ``plan_motion`` groups; the moved
   PG with the most changed positions other than (d)'s is targeted by the
   client's ``Objecter`` at its new primary for 64 object names, and
   drained as in (d) (one "[mon]" line per step).  It fails if
   B1 or B2 was not launched, if 64
   concurrent writes did not coalesce into fewer launches than ops, or if
   a scrub of one group took other than 2 launches; its launches join the
   ``kernels`` line's counts;
7. runs the cluster (``cluster_phase``, wave (f)) with the counts set to
   0: three port ``Monitor``s, twelve port ``OSDDaemon``s (one per CRUSH
   host, on the card) and a port ``Rados`` client in this process, serving
   the Ceph docs' 8+4 pool through the daemons' sub-ops over the
   messenger, on the dev cluster's scale-profile liveness timers.  On
   WalStores: 64 objects of 4 MiB written concurrently to a pool of one PG
   and read back (the daemons' coalescer must take them in fewer
   launches than ops); a pool of 64 PGs, 64 objects of 4 MiB, one OSD
   killed and marked down by ``osd down``, 16 degraded writes into one
   PG, every object read degraded, the OSD revived, HEALTH_OK, the batched
   repair engine's ``ec_repair_stats`` polled over the wire until it
   reports batches, everything read back; no OSD but the victim may be
   marked down at any epoch.  Then a second cluster (1 mon, 12 OSDs on
   MemStores, the resident shard cache, the background deep scrub held
   off by ``osd set noscrub``): 64 objects of 512 KiB read back warm with
   no bytes moved to the device and ``ec_resident_stats`` reporting
   cached shards; then ``osd unset noscrub``, and the batched sweep must
   verify every object, its CRC by B2 (64 KiB shard streams).  Every
   read-back is bit-identical.  One "[cluster]" JSON line per step: wall seconds,
   client GiB/s, kernel launches, the daemons' summed counters and launch
   seconds, and per map epoch the seconds from the first OSD's map
   handler to the last's.  It fails if B1 or B2 was not launched or the
   phase outran its budget (240 s); its launches join the ``kernels``
   line's counts;
8. runs the mesh planes (``mesh_phase``, wave (g)) with the counts set to
   0, 8 slots forced over the card (``parallel.mesh.forced_device_count``),
   each with its own stream: ``sharded_encode`` and ``distributed_ec_step``
   of the headline batch (16384 x 4 KiB, k=8 m=4, dp=2 cs=4) against the
   single-device ``encode_words_device`` result and the encoded chunk 3,
   ``ShardedApplier`` encode and 4-erasure decode, ``sharded_clay_repair``
   (CLAY k=8 m=4 d=11) and ``sharded_lrc_repair`` (k=12 m=4 l=4, 4 groups
   of 2 slots, chunks 0 and 6) at 512 stripes of 64 KiB chunks, each timed
   with CUDA events beside the single-device call for the same work; then
   bench.py's cfg8 arms: two ``ECBackend``s on one ``MeshCoalescer``, 64
   concurrent 4 MiB writes each, read back (a launch must carry both
   backends' ops, and the stripes reach all 8 slots), SHEC k=4 m=3 c=2's
   sharded encode, CLAY and LRC degraded reads through the sub-chunk
   repair (modelled interconnect bytes at most half the whole-chunk
   bytes), the ``osd_ec_mesh_cs`` plane writing, reading and
   ``recover_batch``-ing 64 x 4 MiB, a resident batchmate with no bytes to
   the device; then 1 port mon and 12 port OSD daemons with
   ``osd_ec_mesh_coalesce`` on MemStores, the 8+4 pool of 16 PGs, 64 x 4
   MiB written and read back, one OSD killed and marked down, every object
   read degraded, the ``ec mesh stats`` wire reply naming the
   mesh-coalesced plane with fewer launches than ops and two or more
   backends in one launch.  One "[mesh]" JSON line per step; it fails on
   any difference, if B1 or B3 was not launched, if a batch axis does not
   split over all 8 slots, or if the phase outran its budget (120 s); its
   launches join the ``kernels`` line's counts;
9. runs the manager (``mgr_phase``, wave (h)) with the counts set to 0: 1
   port mon and 12 port OSD daemons (one per CRUSH host, on the card) on
   MemStores with the resident shard cache and the background deep scrub,
   the 8+4 pool of 16 PGs, and a port mgr with its dashboard, the SLO
   targets of a 150 ms put p99 over a 1.5 s window and the QoS
   controller on.  Serve: 64 concurrent 4 MiB writes read back exactly, a seeded
   closed-loop ``LoadGen`` of one client in ``bench.py --serve``'s shape
   with zero errors, ``osd unset noscrub`` and one batched sweep of every
   object;
   judge: the digest's utilization section from the card's launches
   (device GiB/s, its share of ``ec_hbm_peak_gibps``, launch seconds,
   coalescer occupancy and waits, resident hit rate) beside the daemons'
   summed ``ec_launch_bytes`` and B1's and B2's launches; scrape: the
   mgr's Prometheus text and the dashboard's ``/api/status``, ``/api/slo``
   and ``/metrics`` over 127.0.0.1 carry the utilization and burn gauges,
   and the TSDB their series; defend: a delayed ``osd.sub_op`` raises
   SLO_VIOLATION through the mgr into the mon's health and moves the QoS
   controller, and both clear once the failpoint does.  One "[mgr]" JSON
   line per step; it fails on any difference, if B1 or B2 was not
   launched, or if the phase outran its budget (120 s); its launches join
   the ``kernels`` line's counts;
10. runs the gateway (``rgw_phase``, wave (i)) with the counts set to 0:
    1 port mon and 12 port OSD daemons (one per CRUSH host, on the card)
    on MemStores with the resident shard cache, a port mgr with its
    dashboard, and the port's S3 gateway from ``start_rgw(cold_pool=
    "rgw.cold", ec_k=8, ec_m=4)``: a replicated hot pool and the 8+4 COLD
    class at 8 PGs.  Every request SigV4-signed over 127.0.0.1.  Put-cold:
    32 concurrent 4 MiB PUTs with ``x-amz-storage-class: COLD``;
    put-hot + transition: 32 x 4 MiB through the load generator's
    ``S3Backend`` and a 64 MiB multipart upload in 8 MiB parts into the
    hot pool, a lifecycle rule (30 days to COLD) and ``lc_process`` 31 days
    on, every hot key moved; read-back: every GET exact (sha256, ETag,
    storage class), the dashboard's placement and lifecycle panels;
    degraded: one OSD killed and marked down, every GET exact again,
    revived, PGs clean; load: a seeded closed-loop ``LoadGen`` of one
    client over ``S3Backend`` with zero errors; scrub: one batched sweep
    verifying every cold object; gc: 16 cold objects deleted and reaped by
    ``gc_process``, the cold pool down by exactly their RADOS objects.  One
    "[rgw]" JSON line per step; it fails on any difference, if B1 was not
    launched in the put-cold, transition and degraded steps, or if the
    phase outran its budget (120 s); its launches join the ``kernels``
    line's counts;
11. runs multisite (``multisite_phase``, wave (j)) with the counts set to
    0: a port realm of zones a and b, each 1 port mon, 12 port OSD daemons
    on the card (MemStores, the resident shard cache) and the port's
    gateway, each zone's COLD class on an 8+4 pool of 8 PGs set through
    the port's ``rgw_admin``.  Put-a: 32 concurrent 4 MiB SigV4 PUTs with
    user metadata into COLD on zone a; sync: zone b caught up
    (``realm.lag()`` 0 entries and 0 bytes), b's lifecycle rule tiering
    every replica into b's 8+4 pool, every GET from b exact (sha256,
    length, metadata, class), ``rgw_admin sync status``; swift + file:
    the port's ``SwiftFrontend`` on zone a (TempAuth, 8 x 4 MiB segments,
    an SLO manifest read back exact), ``RGWFileSystem`` (mkdir, 4 x 4 MiB
    files, readdir, rename, reads), b caught up, tiered and read back
    exact; degraded: one OSD of b killed and marked down, every body read
    from b exact, revived, PGs clean; dr: ``run_zone_loss_dr_drill`` at
    its defaults (the measured RPO equal to its ledger, the conflict won
    by b, convergence).  One "[multisite]" JSON line per step; it fails
    on any difference, if B1 was not launched in the put-a, sync and
    degraded steps, or if the phase outran its budget (150 s); its
    launches join the ``kernels`` line's counts;
12. runs the admin CLIs and block images (``block_phase``, wave (k)) with
    the counts set to 0: 1 port mon and 12 port OSD daemons on the card
    over durable stores.  Ec-cli: the port's CLI (argv parser) sets the
    8+4 profile, creates the EC pool of 8 PGs, ``rados put``/``get`` of 16
    x 4 MiB seeded files, exact; degraded-cli: one OSD killed and ``osd
    down``, every file got exact, revived, PGs clean, ``status`` and ``osd
    df``; block: on a replicated pool, the port's rbd tool imports a 64
    MiB image, snapshots, protects and clones it, 16 MiB written into the
    clone, both exported exact, ``rbd bench`` of 64 MiB in 4 MiB writes,
    a group snapshot, a journaled 16 MiB image mirrored into ``rbd-dr``
    and read back exact (0 launches: RBD needs omap and object classes,
    which EC pools refuse); offline: one OSD stopped, the objectstore
    tool lists exactly the EC shards the map places on it,
    ``osdmaptool --test-map-pgs`` agrees with the map, the dencoder's
    OSDMap round trip gives the same bytes; restarted, PGs clean.  One
    "[block]" JSON line per step; it fails on any difference, if B1 was
    not launched in the ec-cli and degraded-cli steps, or if the phase
    outran its budget (120 s); its launches join the ``kernels`` line's
    counts;
13. runs CephFS (``cephfs_phase``, wave (l)) with the counts set to 0: 1
    port mon and 12 port OSD daemons on the card (MemStores, the resident
    shard cache), a replicated metadata pool and the 8+4 EC data pool (8
    PGs each), port MDSs ``a`` (active) and ``b`` (standby) with 4 MiB
    data blocks.  Write: a small tree and 16 seeded files of 16 MiB over 4
    directories, written concurrently under their write caps, read back
    exact with ``readdir`` and ``stat``; overwrite: 8 writes of 64 KiB at
    odd offsets through read handles, which hold no cap, so each is the EC
    backend's read-modify-write; degraded: one OSD killed and marked down,
    every file exact, revived, PGs clean; failover: MDS ``a`` shut down,
    ``b`` takes rank 0, a new mount reads every file exact and writes one
    more; volumes: the CLI's ``fs subvolume create`` and ``fs quota set``,
    4 files of 4 MiB in the subvolume exact and one past the quota refused
    with EDQUOT; recover: the MDSs stopped, ``cephfs-journal-tool journal
    inspect``, one directory's dentries removed and put back by
    ``cephfs-data-scan scan``/``inject`` from the backtraces in the EC
    pool, read exact through a new MDS.  One "[cephfs]" JSON line per
    step; it fails on any difference, if B1 was not launched in the write,
    overwrite, degraded and failover steps, or if the phase outran its
    budget (120 s); its launches join the ``kernels`` line's counts;
14. prints the ``kernels`` JSON line, the nvidia-smi line, and last
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
# of 64 concurrent 512-byte overwrites (bench.py's cfg7 pattern); (c) the
# classic backend on 12 WalStores (the dev cluster's default store): 64
# objects of 4 MiB written, remounted and read, one shard backfilled to a
# fresh store, degraded reads through it.
OSD_PROFILE = {"k": "8", "m": "4", "technique": "reed_sol_van"}
OSD_OBJECTS = 64
OSD_OBJECT_BYTES = 4 << 20
OSD_LOST = [0, 1, 2, 3]
OSD_RESIDENT_BYTES = 512 << 10
OSD_VICTIM = (37, 10, 12345, 0x10)   # object, shard, offset, bit flipped
OSD_MOVED = 2                        # (c): the shard backfilled
OSD_DOWN = [0, 1, 3, 4]              # (c): the shards down for reads
OSD_BUDGET_S = 120.0

# (d) the map-driven backfill, on the deployment the Ceph docs give for an
# 8+4 EC pool (docs.ceph.com/en/pacific/rados/operations/
# erasure-code-profile and .../placement-groups): the profile k=8 m=4
# crush-failure-domain=host on reed_sol_van, 12 hosts of 4 OSDs, a pool of
# 512 PGs (512 x 12 / 48 = 128 PG shards per OSD, near the autoscaler's
# mon_target_pg_per_osd of 100).  One OSD is marked out; the port's CRUSH
# and PoolTables.diff name the PGs and shard positions that move.
MAP_HOSTS = 12
MAP_OSDS_PER_HOST = 4
MAP_PG_NUM = 512
MAP_POOL = 1
MAP_OUT_OSD = 17
# Ceph's EC rules carry "step set_choose_tries 100" (CrushWrapper::
# add_simple_rule for indep); the map's one rule takes it as the tunable
MAP_CHOOSE_TRIES = 100
MAP_PROFILE = {"plugin": "jax_rs", "technique": "reed_sol_van", "k": "8",
               "m": "4", "crush-failure-domain": "host"}


def ec_pool_map(crush_map, osd_map, pg_num: int = MAP_PG_NUM):
    """Epoch 1 of the (d) deployment, built from one package's
    ``placement.crush_map`` and ``osd.osd_map`` modules: 12 hosts of 4
    OSDs under one root (host h holds OSDs 4h..4h+3), every OSD up and in,
    the profile's indep rule over hosts (100 choose tries) and the pool of
    ``pg_num`` PGs (512)."""
    crush = crush_map.CrushMap()
    crush.tunables.choose_total_tries = MAP_CHOOSE_TRIES
    root = crush.add_bucket("default", "root")
    for h in range(MAP_HOSTS):
        host = crush.add_bucket(f"host{h}", "host")
        for i in range(MAP_OSDS_PER_HOST):
            crush.add_item(host, h * MAP_OSDS_PER_HOST + i, 1.0)
        crush.add_item(root, host)
    k, m = int(MAP_PROFILE["k"]), int(MAP_PROFILE["m"])
    crush.create_ec_rule("ec84", chunk_count=k + m,
                         failure_domain=MAP_PROFILE["crush-failure-domain"])
    osdmap = osd_map.OSDMap(crush)
    inc = osd_map.Incremental(1)
    for osd in range(MAP_HOSTS * MAP_OSDS_PER_HOST):
        inc.new_up[osd] = f"osd.{osd}"
    inc.new_ec_profiles["ec84"] = dict(MAP_PROFILE)
    inc.new_pools.append(osd_map.PoolInfo(
        MAP_POOL, "ecpool", "erasure", size=k + m, min_size=k + 1,
        pg_num=pg_num, crush_rule="ec84", ec_profile="ec84"))
    osdmap.apply_incremental(inc)
    return osdmap


def check_ec_tables(osdmap, tables) -> list:
    """Every up set of the pool holds k+m positions, its OSDs on as many
    distinct hosts, and the cached table equals the scalar CRUSH walk on
    every PG.  Returns the PGs left with a hole: with as many hosts as
    chunks, indep CRUSH can run out of tries before it finds the last
    free host (Ceph's own rule also takes per-rule chooseleaf tries,
    which this CRUSH does not model)."""
    size = osdmap.pools[MAP_POOL].size
    holes = []
    for ps in range(tables.pg_num):
        up = tables.lookup(ps)[0]
        osds = [osd for osd in up if osd >= 0]
        hosts = {osd // MAP_OSDS_PER_HOST for osd in osds}
        if len(up) != size or len(hosts) != len(osds):
            raise AssertionError(f"PG {ps}: up set {up} is not {size} "
                                 f"positions on distinct hosts")
        if len(osds) < size:
            holes.append(ps)
        raw = osdmap.mapping().raw_row(MAP_POOL, ps)
        if raw != osdmap._pg_to_raw_osds_scalar(MAP_POOL, ps):
            raise AssertionError(f"PG {ps}: the mapping's row {raw} differs "
                                 f"from the scalar CRUSH walk")
    return holes


def map_motion(osdmap, osd_map, backfill) -> dict:
    """Mark MAP_OUT_OSD out through an Incremental and plan the motion
    (``motion_between`` the pool's tables before and after)."""
    before = osdmap.mapping().up_acting_tables(MAP_POOL)
    osdmap.apply_incremental(osd_map.Incremental(
        osdmap.epoch + 1, new_weights={MAP_OUT_OSD: 0}))
    after = osdmap.mapping().up_acting_tables(MAP_POOL)
    return {**motion_between(before, after, backfill),
            "epoch": osdmap.epoch}


def motion_between(before, after, backfill, exclude=()) -> dict:
    """The motion from the pool's up/acting tables ``before`` MAP_OUT_OSD
    was marked out to those ``after``: their diff (every PG that held the
    OSD must be in it), each moved PG's (old, new) up rows,
    ``backfill.plan_motion``'s groups, and the PG to drain: the moved PG
    with the most shard positions changed (lowest ps on ties) among those
    that held the OSD and are left with a complete up set, other than
    ``exclude``."""
    moved = [int(ps) for ps in after.diff(before)]
    held = [int(ps) for ps in before.pgs_of(MAP_OUT_OSD)]
    if not set(held) <= set(moved):
        raise AssertionError(f"PGs {sorted(set(held) - set(moved))} held "
                             f"osd.{MAP_OUT_OSD} but are not in the diff")
    rows = {ps: (before.lookup(ps)[0], after.lookup(ps)[0]) for ps in moved}
    plan = backfill.plan_motion({MAP_POOL: rows})
    # with k+m hosts, a position whose host lost an OSD can only move to
    # that host's other OSDs; indep CRUSH may exhaust its tries first and
    # leave a hole (the PG stays undersized): such a PG has no target
    undersized = [ps for ps in moved if min(rows[ps][1]) < 0]

    def positions(ps):
        old, new = rows[ps]
        return [i for i, (a, b) in enumerate(zip(old, new)) if a != b]

    ps = min(set(held) - set(undersized) - set(exclude),
             key=lambda p: (-len(positions(p)), p))
    return {"before": before, "after": after, "moved": moved, "held": held,
            "undersized": undersized, "rows": rows, "plan": plan, "ps": ps,
            "positions": positions(ps)}


def pg_object_names(object_to_ps, ps: int, count: int, seed: int,
                    pg_num: int = MAP_PG_NUM) -> list:
    """``count`` RBD-style object names that ``object_to_ps`` sends to PG
    ``ps`` of a pool of ``pg_num`` PGs, drawn in order from a seeded
    sequence."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = []
    while len(names) < count:
        for v in rng.integers(0, 2**63, 4096, dtype=np.int64):
            name = f"rbd_data.{int(v):016x}"
            if object_to_ps(name, pg_num) == ps:
                names.append(name)
                if len(names) == count:
                    break
    return names


async def map_drain(ns, codec, root: str, motion: dict, datas: dict,
                    wave=None, tag: str = "d") -> dict:
    """Wave (d)'s drain, over one package's OSD surface ``ns`` (WalStore,
    MemStore, Transaction, CollectionId, GHObject, LocalShard, ECBackend,
    BackfillEngine, RepairScheduler, pg_log, HINFO_ATTR).

    One WalStore per OSD of the moved PG's old up set under ``root``, each
    holding the collection of its shard position; ``datas`` written
    through a coalescing ECBackend.  Every position whose OSD changed gets
    its new OSD's store (a fresh one, or the store of an OSD already in
    the set) and ``BackfillEngine.drain_pg`` rebuilds it through the
    repair scheduler.  The out OSD's store is then unmounted and deleted
    and everything read back.  ``wave(label, backend, nbytes, fn)`` runs
    each step (the chip's instrumented runner; plain awaits by default),
    its labels led by ``tag``.
    Returns the read-back verdict, the old and rebuilt shard images
    (bytes and hinfo) and the backfill counters."""
    import asyncio
    import os
    import shutil

    if wave is None:
        async def wave(label, be, nbytes, fn):
            return await fn()
    ps, pool = motion["ps"], MAP_POOL
    old_up, new_up = motion["rows"][ps]
    stores = {}

    async def store_of(osd):
        if osd not in stores:
            stores[osd] = ns.WalStore(os.path.join(root, f"osd.{osd}"))
            await stores[osd].mount()
        return stores[osd]

    async def shard(osd, pos):
        store = await store_of(osd)
        cid = ns.CollectionId(pool, ps, shard=pos)
        await store.queue_transactions(
            ns.Transaction().create_collection(cid))
        return ns.LocalShard(store, cid, pool=pool, shard=pos)

    shards = {pos: await shard(osd, pos) for pos, osd in enumerate(old_up)}
    be = ns.ECBackend(codec, shards, stripe_unit=512, coalesce=True)
    names = list(datas)
    total = sum(len(d) for d in datas.values())
    await wave(f"{tag}: write", be, total, lambda: asyncio.gather(*(
        be.write(nm, d) for nm, d in datas.items())))

    def image(sh):
        out = {}
        for nm in names:
            oid = ns.GHObject(pool, nm, shard=sh.shard)
            out[nm] = (sh.store.read(sh.cid, oid),
                       sh.store.getattrs(sh.cid, oid)[ns.HINFO_ATTR])
        return out

    positions = motion["positions"]
    old = {pos: image(shards[pos]) for pos in positions}
    for pos in positions:
        be.shards[pos] = await shard(new_up[pos], pos)
    meta = ns.MemStore()
    await meta.queue_transactions(ns.Transaction().create_collection(
        ns.pg_log.meta_cid(pool, ps)))
    engine = ns.BackfillEngine(ns.RepairScheduler(be.perf), be.perf,
                               store=meta)
    done = await wave(f"{tag}: backfill {len(positions)} positions of PG "
                      f"{pool}.{ps:x}", be, total, lambda: engine.drain_pg(
                          be, {nm: list(positions) for nm in names},
                          pool=pool, ps=ps, epoch=motion["epoch"]))
    counters = {key: be.perf.value(key) for key in (
        "backfill_objects", "backfill_batches", "backfill_bytes")}
    rebuilt = {pos: image(be.shards[pos]) for pos in positions}
    gone = stores.pop(MAP_OUT_OSD)
    await gone.umount()
    shutil.rmtree(os.path.join(root, f"osd.{MAP_OUT_OSD}"))
    got = await wave(f"{tag}: read, osd.{MAP_OUT_OSD} gone", be, total,
                     lambda: asyncio.gather(*(be.read(nm) for nm in names)))
    for store in stores.values():
        await store.umount()
    return {"done": sorted(done), "names": sorted(names),
            "reads": got == [datas[nm] for nm in names], "old": old,
            "rebuilt": rebuilt, "counters": counters}


# (e) the (d) deployment committed by a quorum of three monitors in this
# process (local:// addresses); every wait is bounded by MON_WAIT_S.
MON_NAMES = ("a", "b", "c")
MON_WAIT_S = 60.0


def tables_equal(a, b) -> bool:
    """Two PoolTables hold the same rows, lengths and primaries."""
    import numpy as np

    return a.pg_num == b.pg_num and all(
        np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
        for k in ("up", "up_len", "up_primary", "acting", "acting_len",
                  "acting_primary"))


async def mon_map_wave(ns, crush_text: str, pg_num: int, motion_d: dict,
                       count: int, seed: int, drain=None,
                       note=log) -> dict:
    """Wave (e)'s control plane, over one package's mon and client surface
    ``ns`` (Monitor, MonClient, Rados, ConfigProxy, backfill,
    object_to_ps, reset_local_namespace).

    Three mons form a quorum; the deployment's 48 OSDs boot through a
    ``MonClient`` session each (no OSD daemon runs); a ``Rados`` client
    injects ``crush_text`` (``osd setcrushmap``), sets the 8+4 profile and
    creates the erasure pool of ``pg_num`` PGs on rule ec84.  The client's
    map at the pool's epoch must give ``motion_d``'s table before the
    out-mark, row for row.  ``osd out`` MAP_OUT_OSD goes through the
    client; at the epoch its subscription delivers, the tables, the diff,
    the moved rows and the ``plan_motion`` groups must be ``motion_d``'s.
    The moved PG to drain is chosen as (d) chose its own, (d)'s excluded;
    ``count`` object names are drawn for it and the client's ``Objecter``
    must target each at the new up set's primary.  ``drain(motion,
    names)`` then runs while the cluster is up.  The client shuts down,
    then the OSD sessions, then the mons; a "[mon]" line is noted for
    each step.  Raises on any difference; returns the motion, the names,
    the targets, the epochs and the drain's result."""
    import asyncio

    async def until(cond, what):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + MON_WAIT_S
        while not cond():
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {MON_WAIT_S:.0f} s")
            await asyncio.sleep(0.01)

    def line(step, t0, **kw):
        rec = {"step": step, "s": time.perf_counter() - t0, **kw}
        note(f"[mon] {json.dumps(rec)}")

    ns.reset_local_namespace()
    monmap = {n: f"local://mon.{n}" for n in MON_NAMES}
    mons, sessions, rados = [], [], None
    try:
        t0 = time.perf_counter()
        for n in MON_NAMES:
            mons.append(ns.Monitor(n, monmap, ns.ConfigProxy()))
            await mons[-1].start()

        def quorate():
            leaders = {m.elector.leader for m in mons}
            return (len(leaders) == 1 and None not in leaders
                    and all(m.is_leader or m.elector.in_quorum()
                            for m in mons)
                    and any(m.is_leader and m.paxos.ready
                            and len(m.elector.quorum) == len(mons)
                            and m.osd_monitor.osdmap.epoch >= 1
                            for m in mons))

        await until(quorate, "quorum of three")
        leader = next(m for m in mons if m.is_leader)
        line("quorum", t0, leader=leader.name, quorum=leader.elector.quorum,
             epoch=leader.osd_monitor.osdmap.epoch)

        t0 = time.perf_counter()
        e0 = leader.osd_monitor.osdmap.epoch
        n_osds = MAP_HOSTS * MAP_OSDS_PER_HOST

        async def boot(osd):
            mc = ns.MonClient(f"osd.{osd}", monmap, ns.ConfigProxy())
            sessions.append(mc)
            await mc.start(MON_WAIT_S)
            mc.sub_want("osdmap")
            mc.renew_subs()
            await mc.send_boot(osd, f"local://osd.{osd}",
                               host=f"host{osd // MAP_OSDS_PER_HOST}",
                               timeout=MON_WAIT_S)

        await asyncio.gather(*(boot(osd) for osd in range(n_osds)))
        booted = leader.osd_monitor.osdmap
        if sorted(o for o in booted.osds if booted.is_up(o)) != list(
                range(n_osds)):
            raise AssertionError(f"not every OSD of {n_osds} is up")
        line("boot", t0, osds=n_osds, epochs=booted.epoch - e0,
             epoch=booted.epoch)

        t0 = time.perf_counter()
        rados = ns.Rados(monmap, ns.ConfigProxy(), name="client.admin")
        await rados.connect(MON_WAIT_S)
        line("connect", t0, epoch=rados.monc.osdmap.epoch)

        async def command(prefix, **kw):
            t0 = time.perf_counter()
            r = await rados.mon_command(prefix, timeout=MON_WAIT_S, **kw)
            if r["rc"] != 0:
                raise AssertionError(f"{prefix}: {r}")
            line("command", t0, prefix=prefix,
                 epoch=leader.osd_monitor.osdmap.epoch)
            return r

        await command("osd setcrushmap", map=crush_text)
        await command("osd erasure-code-profile set", name="ec84",
                      profile=dict(MAP_PROFILE))
        t0 = time.perf_counter()
        pool_id = await rados.pool_create(
            "ecpool", pool_type="erasure", erasure_code_profile="ec84",
            crush_rule="ec84", pg_num=pg_num)
        if pool_id != MAP_POOL:
            raise AssertionError(f"the pool is {pool_id}, not {MAP_POOL}")
        line("command", t0, prefix="osd pool create",
             epoch=rados.monc.osdmap.epoch)

        async def table(what):
            """The client's map's table of the pool (the pool's whole
            host CRUSH, off the event loop so the mons keep their
            leases)."""
            m = rados.monc.osdmap
            t0 = time.perf_counter()
            t = await asyncio.to_thread(
                lambda: m.mapping().up_acting_tables(MAP_POOL))
            line("map", t0, what=what, epoch=m.epoch, pg_num=t.pg_num)
            return m.epoch, t

        pool_epoch, before = await table("pool created")
        if not tables_equal(before, motion_d["before"]):
            raise AssertionError("the committed map's table differs from "
                                 "the locally built map's")
        await command("osd out", ids=[MAP_OUT_OSD])
        await until(lambda: rados.monc.osdmap.osds[MAP_OUT_OSD].weight == 0,
                    f"epoch with osd.{MAP_OUT_OSD} out at the client")
        out_epoch, after = await table(f"osd.{MAP_OUT_OSD} out")
        if not tables_equal(after, motion_d["after"]):
            raise AssertionError("the table after the out-mark differs from "
                                 "the locally built map's")
        motion = {**motion_between(before, after, ns.backfill,
                                   exclude={motion_d["ps"]}),
                  "epoch": out_epoch}
        for key in ("moved", "held", "undersized", "rows", "plan"):
            if motion[key] != motion_d[key]:
                raise AssertionError(f"the committed maps' {key} differ "
                                     f"from the locally built maps'")
        ps = motion["ps"]
        names = pg_object_names(ns.object_to_ps, ps, count, seed, pg_num)
        t0 = time.perf_counter()
        targets = [rados.objecter._target_for(MAP_POOL, nm) for nm in names]
        primary = after.lookup(ps)[1]
        if set(targets) != {primary}:
            raise AssertionError(f"the Objecter targets {set(targets)} for "
                                 f"PG {MAP_POOL}.{ps:x}, not {primary}")
        line("target", t0, pg=ps, positions=motion["positions"],
             primary=primary, names=len(names))
        drained = await drain(motion, names) if drain is not None else None
        return {"motion": motion, "names": names, "targets": targets,
                "pool_epoch": pool_epoch, "out_epoch": out_epoch,
                "drained": drained}
    finally:
        if rados is not None:
            await rados.shutdown()
        for mc in sessions:
            await mc.shutdown()
        for mon in mons:
            await mon.shutdown()
        ns.reset_local_namespace()


# (f) the Ceph docs' 8+4 pool served by OSD daemons: three monitors, twelve
# OSDDaemons (one per CRUSH host, so every PG spans every OSD) and a Rados
# client in this process (local://), the daemons' sub-ops over the
# messenger.  Liveness runs on the dev cluster's scale-profile timers (a
# pool's map epoch blocks the shared loop for each daemon's CRUSH pass in
# turn) and the victim is marked down by the operator's "osd down".
CLUSTER_MONS = 3
CLUSTER_OSDS = 12
CLUSTER_PROFILE = dict(MAP_PROFILE)
# mon_target_pg_per_osd 100 x 12 OSDs / 12 shards is 100, 128 as a power
# of two; cut to 64 to keep the whole script near 500 s once waves (j)
# and (k) joined it (each daemon's CRUSH pass over the pool's epoch is
# host work linear in the PG count)
CLUSTER_PG_NUM = 64
CLUSTER_OBJECTS = 64
CLUSTER_OBJECT_BYTES = 4 << 20
CLUSTER_DEGRADED = 16
CLUSTER_RESIDENT_BYTES = 512 << 10   # 64 KiB shard streams: the device CRC
CLUSTER_VICTIM = 7
CLUSTER_DEGRADED_PG = 0
CLUSTER_SCRUB_INTERVAL_S = 0.5
CLUSTER_BUDGET_S = 240.0
CLUSTER_WAIT_S = 120.0
CLUSTER_LIVENESS = ("mon_lease", "mon_lease_interval", "mon_election_timeout",
                    "mon_tick_interval", "mon_accept_timeout",
                    "paxos_propose_interval", "osd_heartbeat_interval",
                    "osd_heartbeat_grace")
CLUSTER_COUNTERS = ("ec_coalesce_ops", "ec_coalesce_launches",
                    "ec_device_launches", "ec_encode_launch_us",
                    "ec_decode_launch_us", "ec_resident_h2d_bytes",
                    "ec_resident_hits")


def pgs_clean(osds) -> bool:
    """Every primary PG of the OSD daemons ``osds`` is active, with no
    shard missing and no backfill pending."""
    return not any(
        pg.is_primary and (pg.state != "active" or (
            pg.missing is not None
            and (pg.missing.by_shard or pg.missing.backfill)))
        for osd in osds for pg in osd.pgs.values())


class _EpochWatch:
    """Per map epoch, the OSD daemons' map handlers: when the first began,
    when the last ended, and each one's seconds (the handler of each
    daemon ``track``ed, timed; a daemon fed a newer map skips one)."""

    def __init__(self):
        self.handlers: dict[int, list] = {}

    def track(self, osd) -> None:
        inner = osd.monc.on_osdmap
        if getattr(inner, "timed", False):
            return

        async def timed(osdmap):
            t0 = time.perf_counter()
            try:
                await inner(osdmap)
            finally:
                self.handlers.setdefault(osdmap.epoch, []).append(
                    (t0, time.perf_counter()))

        timed.timed = True
        osd.monc.on_osdmap = timed

    def spread(self, since: int) -> list:
        """[epoch, seconds from the first handler's start to the last's
        end, the slowest handler's seconds, the handlers' summed seconds]
        for each epoch past ``since``."""
        out = []
        for e in sorted(self.handlers):
            if e > since:
                hs = self.handlers[e]
                out.append([e, max(b for _, b in hs) - min(a for a, _ in hs),
                            max(b - a for a, b in hs),
                            sum(b - a for a, b in hs)])
        return out


async def cluster_wave(ns, store_dir: str, *, pg_num: int = CLUSTER_PG_NUM,
                       objects: int = CLUSTER_OBJECTS,
                       object_bytes: int = CLUSTER_OBJECT_BYTES,
                       degraded: int = CLUSTER_DEGRADED,
                       resident_bytes: int = CLUSTER_RESIDENT_BYTES,
                       seed: int = SEED, note=log) -> dict:
    """Wave (f) over one package's dev cluster ``ns`` (DevCluster, a
    constructor that places the OSD daemons; SCALE_TEST_OVERRIDES,
    reset_local_namespace, compiler, object_to_ps; ``launches()``, the kernel counts so
    far, empty where the package keeps none; ``sync()``, a device
    barrier).

    Four steps, a "[cluster]" JSON line each (wall seconds, client GiB/s,
    kernel launches, the daemons' summed counters, and per map epoch the
    seconds from the first OSD's map handler to the last's):

    1. coalesce: a 12-OSD, 3-mon cluster on WalStores under ``store_dir``
       with the 8+4 profile on 12 hosts (CRUSH's choose tries at Ceph's
       EC-rule 100); pool ``coal`` of 1 PG; ``objects`` concurrent writes
       of ``object_bytes``, each read back; the daemons' coalescer must
       have taken at least ``objects`` ops in fewer launches than ops;
    2. repair: pool ``ec`` of ``pg_num`` PGs, ``objects`` writes; the
       victim OSD killed and marked down through the client, ``degraded``
       writes more into one PG, every object read while it is down;
       revived, HEALTH_OK, ``ec_repair_stats`` polled over the wire until
       the batched engine reports batches; every object read back once
       every primary PG is clean.  No OSD but the victim may be marked
       down at any epoch;
    3. resident: a second cluster, 1 mon and 12 OSDs on MemStores with the
       resident shard cache and the background deep scrub (held off by
       ``osd set noscrub``); pool ``res`` of 1 PG, ``objects`` writes of
       ``resident_bytes``; every object read back warm: no bytes host to
       device, at least ``objects`` hits, and ``ec_resident_stats`` over
       the wire reports cached shards;
    4. scrub: ``osd unset noscrub``, and ``ec_scrub_stats`` polled over
       the wire until a batched sweep verified every object of ``res``
       (its CRC on the device where the shard streams are at most 64 KiB),
       with no error.

    Every read must be bit-identical.  Raises on any failure; returns
    each step's record."""
    import asyncio

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(seed)
    k_plus_m = int(CLUSTER_PROFILE["k"]) + int(CLUSTER_PROFILE["m"])
    daemons: dict[int, object] = {}
    steps: dict[str, dict] = {}

    def adopt(cluster, watch) -> None:
        for osd in cluster.osds.values():
            daemons[id(osd)] = osd
            watch.track(osd)

    def summed() -> dict:
        return {key: sum(o.perf.value(key) for o in daemons.values())
                for key in CLUSTER_COUNTERS}

    async def until(cond, what):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + CLUSTER_WAIT_S
        while not await cond():
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {CLUSTER_WAIT_S:.0f} s")
            await asyncio.sleep(0.25)

    def begin():
        ns.sync()
        return time.perf_counter(), summed(), ns.launches()

    def record(step, start, watch, since, nbytes, **kw):
        ns.sync()
        t0, c0, k0 = start
        sec = time.perf_counter() - t0
        c1, k1 = summed(), ns.launches()
        d = {key: c1[key] - c0[key] for key in CLUSTER_COUNTERS}
        rec = {"step": step, "wall_s": sec,
               "client_gib_s": nbytes / sec / 2**30,
               "kernel_launches": {k: k1[k] - k0.get(k, 0) for k in k1
                                   if k1[k] != k0.get(k, 0)},
               "launch_s": (d.pop("ec_encode_launch_us")
                            + d.pop("ec_decode_launch_us")) / 1e6,
               **d, "epochs": watch.spread(since), **kw}
        rec["launch_share"] = rec["launch_s"] / sec
        steps[step] = rec
        note(f"[cluster] {json.dumps(rec)}")
        return rec

    async def write_all(io, datas):
        await asyncio.gather(*(io.write_full(o, d) for o, d in datas.items()))

    async def read_all(io, datas, what):
        got = await asyncio.gather(*(io.read(o) for o in datas))
        bad = [o for o, g in zip(datas, got) if g != datas[o]]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} objects differ "
                                 f"({bad[:4]})")

    async def command(rados, prefix, **kw):
        r = await rados.mon_command(prefix, timeout=CLUSTER_WAIT_S, **kw)
        if r["rc"] != 0:
            raise AssertionError(f"{prefix}: {r}")
        return r

    async def active(pool_id):
        """Each PG of the pool is active on its primary."""
        pg_num = rados.monc.osdmap.pools[pool_id].pg_num
        return sum(1 for o in cluster.osds.values()
                   for pgid, pg in o.pgs.items()
                   if pgid.pool == pool_id and pg.is_primary
                   and pg.state == "active") == pg_num

    async def profile_and_tries(rados):
        """The 8+4 profile, and the map's CRUSH with Ceph's EC-rule choose
        tries (the mon's rules carry no set_choose_tries step)."""
        m = rados.monc.osdmap
        text = ns.compiler.decompile(m.crush)
        tunable = "tunable choose_total_tries 50\n"
        if tunable not in text:
            raise AssertionError("the map's choose_total_tries is not 50")
        await command(rados, "osd setcrushmap", map=text.replace(
            tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
        await command(rados, "osd erasure-code-profile set", name="ec84",
                      profile=dict(CLUSTER_PROFILE))

    async def pool(rados, name, pgs):
        pool_id = await rados.pool_create(
            name, pool_type="erasure", erasure_code_profile="ec84",
            pg_num=pgs)
        await until(lambda: active(pool_id), f"active PGs of {name}")
        m = rados.monc.osdmap
        holes = sum(1 for ps in range(pgs)
                    if len([o for o in m.pg_to_up_acting(pool_id, ps)[2]
                            if o >= 0]) != k_plus_m)
        return await rados.open_ioctx(name), holes

    t_phase = time.perf_counter()
    victim = CLUSTER_VICTIM
    ns.reset_local_namespace()
    cluster = ns.DevCluster(
        n_mons=CLUSTER_MONS, n_osds=CLUSTER_OSDS, osds_per_host=1,
        store_dir=f"{store_dir}/durable",
        overrides={**liveness, "mon_osd_down_out_interval": 300.0})
    watch = _EpochWatch()
    rados = None
    try:
        t0 = time.perf_counter()
        await cluster.start()
        adopt(cluster, watch)
        rados = await cluster.client()
        boot_epoch = rados.monc.osdmap.epoch
        steps["boot"] = {"step": "boot", "wall_s": time.perf_counter() - t0,
                         "mons": len(cluster.mons),
                         "osds": len(cluster.osds), "epoch": boot_epoch}
        note(f"[cluster] {json.dumps(steps['boot'])}")
        await profile_and_tries(rados)

        # 1. coalesce
        since = rados.monc.osdmap.epoch
        io, holes = await pool(rados, "coal", 1)
        datas = {f"coal-{i}": rng.bytes(object_bytes)
                 for i in range(objects)}
        start = begin()
        await write_all(io, datas)
        w_s = time.perf_counter() - start[0]
        await read_all(io, datas, "coalesce read-back")
        rec = record("coalesce", start, watch, since,
                     2 * objects * object_bytes, write_s=w_s,
                     write_gib_s=objects * object_bytes / w_s / 2**30,
                     holes=holes)
        if rec["ec_coalesce_ops"] < objects:
            raise AssertionError(f"the coalescer saw {rec['ec_coalesce_ops']}"
                                 f" ops of {objects}")
        # fewer launches than ops: 4 MiB ops reach the primary's backend
        # one event-loop pass apart, and the coalescer flushes as soon as
        # every op in flight is parked (tier1.sh's ops / 4 holds for 4 KiB
        # ops, not here: PERF.md §6)
        if not rec["ec_coalesce_launches"] < rec["ec_coalesce_ops"]:
            raise AssertionError(
                f"no coalescing: {rec['ec_coalesce_launches']} "
                f"launches for {rec['ec_coalesce_ops']} ops")

        # 2. repair
        since = rados.monc.osdmap.epoch
        t0 = time.perf_counter()
        io, holes = await pool(rados, "ec", pg_num)
        pool_s = time.perf_counter() - t0
        datas = {f"ec-{i}": rng.bytes(object_bytes) for i in range(objects)}
        start = begin()
        await write_all(io, datas)
        w_s = time.perf_counter() - start[0]
        await cluster.kill_osd(victim)
        await command(rados, "osd down", ids=[victim])

        async def victim_down():
            return not rados.monc.osdmap.is_up(victim)

        await until(victim_down, f"epoch with osd.{victim} down")
        # into one PG: the batched engine rebuilds a lost shard position
        # for two or more objects of a PG at once, fewer fall to the
        # per-object path
        more = {nm: rng.bytes(object_bytes) for nm in pg_object_names(
            ns.object_to_ps, CLUSTER_DEGRADED_PG, degraded, seed, pg_num)}
        await write_all(io, more)
        datas.update(more)
        t0 = time.perf_counter()
        await read_all(io, datas, "degraded read")
        degraded_read_s = time.perf_counter() - t0
        await cluster.revive_osd(victim)
        adopt(cluster, watch)
        await cluster.wait_health_ok(timeout=CLUSTER_WAIT_S)
        repair = {}

        async def repaired():
            repair.clear()
            for osd_id in cluster.osds:
                stats = await rados.osd_daemon_command(
                    osd_id, "ec_repair_stats", timeout=CLUSTER_WAIT_S)
                eng = stats.get("engine", {})
                for key in ("batches", "objects"):
                    repair[key] = repair.get(key, 0) + eng.get(key, 0)
            return repair["batches"] > 0

        await until(repaired, "batched repair")

        async def clean():
            return pgs_clean(cluster.osds.values())

        await until(clean, "clean PGs after the repair")
        await repaired()
        await read_all(io, datas, "read-back after repair")
        downs = sorted({o for inc in
                        cluster.mons[next(iter(cluster.mons))]
                        .osd_monitor.incrementals_since(boot_epoch)
                        for o in inc["new_down"]})
        if downs != [victim]:
            raise AssertionError(f"OSDs marked down {downs}, only osd."
                                 f"{victim} may be")
        record("repair", start, watch, since,
               (2 * objects + 2 * degraded) * object_bytes, write_s=w_s,
               write_gib_s=objects * object_bytes / w_s / 2**30,
               pool_s=pool_s, degraded_read_s=degraded_read_s,
               holes=holes, victim=victim, marked_down=downs,
               repair_batches=repair["batches"],
               repair_objects=repair["objects"])
    finally:
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()

    # 3. resident
    cluster = ns.DevCluster(
        n_mons=1, n_osds=CLUSTER_OSDS, osds_per_host=1,
        overrides={**liveness, "mon_osd_down_out_interval": 300.0,
                   "osd_ec_resident": True,
                   "osd_scrub_interval": CLUSTER_SCRUB_INTERVAL_S})
    watch = _EpochWatch()
    rados = None
    try:
        await cluster.start()
        adopt(cluster, watch)
        rados = await cluster.client()
        await command(rados, "osd set", flag="noscrub")
        await profile_and_tries(rados)
        since = rados.monc.osdmap.epoch
        io, holes = await pool(rados, "res", 1)
        datas = {f"res-{i}": rng.bytes(resident_bytes)
                 for i in range(objects)}
        start = begin()
        await write_all(io, datas)
        w_s = time.perf_counter() - start[0]
        warm = summed()
        await read_all(io, datas, "resident read-back")
        after = summed()
        h2d = after["ec_resident_h2d_bytes"] - warm["ec_resident_h2d_bytes"]
        hits = after["ec_resident_hits"] - warm["ec_resident_hits"]
        entries = 0
        for osd_id in cluster.osds:
            stats = await rados.osd_daemon_command(
                osd_id, "ec_resident_stats", timeout=CLUSTER_WAIT_S)
            entries += stats.get("cache", {}).get("entries", 0)
        record("resident", start, watch, since,
               2 * objects * resident_bytes, write_s=w_s,
               write_gib_s=objects * resident_bytes / w_s / 2**30,
               holes=holes, warm_h2d_bytes=h2d, warm_hits=hits,
               cached_shards=entries)
        if h2d != 0:
            raise AssertionError(f"warm reads moved {h2d} bytes to the "
                                 f"device")
        if hits < objects:
            raise AssertionError(f"the resident cache barely hit: {hits}")
        if entries <= 0:
            raise AssertionError("no OSD reported cached resident shards")

        # the background deep scrub, held off so far: one batched sweep of
        # the pool's PG, its CRC by the device (64 KiB shard streams)
        since = rados.monc.osdmap.epoch
        start = begin()
        await command(rados, "osd unset", flag="noscrub")
        scrub = {}

        async def swept():
            scrub.clear()
            for osd_id in cluster.osds:
                stats = await rados.osd_daemon_command(
                    osd_id, "ec_scrub_stats", timeout=CLUSTER_WAIT_S)
                for key in ("sweeps", "objects", "errors"):
                    scrub[key] = scrub.get(key, 0) + \
                        stats["engine"].get(key, 0)
            return scrub["objects"] >= objects

        await until(swept, "background scrub sweep")
        if scrub["errors"]:
            raise AssertionError(f"the scrub found {scrub['errors']} errors")
        record("scrub", start, watch, since, objects * resident_bytes,
               sweeps=scrub["sweeps"], objects=scrub["objects"],
               errors=scrub["errors"])
    finally:
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def cluster_phase(dev) -> dict:
    """Wave (f) on the port's dev cluster, its OSD daemons on the CUDA
    device ``dev``, under a temporary directory.  Counts the codecs built
    meanwhile and their seconds, through the registry's ``factory``: a
    daemon's one per primary EC PG at each peering, and a mon's two per
    profile check."""
    import asyncio
    import functools
    import tempfile
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.osd.pg import object_to_ps
    from ceph_tpu_torch.placement import compiler

    ns = SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        object_to_ps=object_to_ps, launches=lambda: dict(ck.LAUNCHES),
        sync=torch.cuda.synchronize)
    built = {"codecs": 0, "seconds": 0.0}
    factory = ErasureCodePluginRegistry.factory

    def counted(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return factory(self, *args, **kw)
        finally:
            built["codecs"] += 1
            built["seconds"] += time.perf_counter() - t0

    ErasureCodePluginRegistry.factory = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = asyncio.run(cluster_wave(ns, tmp))
    finally:
        ErasureCodePluginRegistry.factory = factory
    log(f"[cluster] {json.dumps({'step': 'codecs', **built})}")
    return {**out, "codecs": built}


def osd_phase(dev, seed: int) -> dict:
    """Drive the port's OSD data path (``ECBackend`` over ``MemStore``
    shards, then ``WalStore`` shards with a backfill, then a backfill
    that the port's OSD map plans, then one that a port monitor quorum's
    committed maps plan) on the CUDA device ``dev`` and check every
    result; return per-wave readings.  Each B1/B2 launch is bracketed by
    CUDA events (an upper bound of its device time: the wrapper's host
    work after the first event is included)."""
    import asyncio
    import os
    import tempfile

    import numpy as np
    import torch

    from ceph_tpu_torch.common import crc32c as crc_mod
    from ceph_tpu_torch.common import failpoint as fp
    from ceph_tpu_torch.ec import checksum
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd import pg_log
    from ceph_tpu_torch.osd.backfill import BackfillEngine
    from ceph_tpu_torch.osd.ec_backend import (HINFO_ATTR, ECBackend,
                                               LocalShard, ShardReadError)
    from ceph_tpu_torch.osd.ec_util import HashInfo
    from ceph_tpu_torch.osd.repair import RepairScheduler
    from ceph_tpu_torch.store import (CollectionId, GHObject, MemStore,
                                      Transaction, WalStore, native_wal)

    t_phase = time.perf_counter()
    log(f"[osd] host crc32c: {crc_mod.backend()} "
        f"({crc_mod.library_path().name})")
    if crc_mod.backend() != "native":
        raise AssertionError("the native crc32c did not build or load")
    if not native_wal.available():
        raise AssertionError("the native WAL engine did not build or load")
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

    async def wave(label, be, nbytes, fn, prefix="[osd]"):
        """One wave: its wall time, client GiB/s, launches, the backend's
        summed launch times and the kernels' event time, each against
        the wall time, logged after ``prefix``."""
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
        log(f"{prefix} {json.dumps(rec)}")
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

    async def wal_backend(root):
        """ECBackend over one WalStore per shard under ``root`` (mounted,
        the native WAL tier asserted), coalescing."""
        stores, shards = {}, {}
        for i in range(n):
            store = WalStore(os.path.join(root, f"osd.{i}"))
            await store.mount()
            if not store.native:
                raise AssertionError(f"WalStore {i} is not on the native "
                                     f"WAL tier")
            cid = CollectionId(1, 0, shard=i)
            if cid not in store.list_collections():
                await store.queue_transactions(
                    Transaction().create_collection(cid))
            stores[i] = (store, cid)
            shards[i] = LocalShard(store, cid, pool=1, shard=i)
        return ECBackend(codec, shards, stripe_unit=512, coalesce=True), \
            stores

    class DownShard:
        """A shard whose OSD is down: every call fails as unavailable."""

        async def _down(self, *args, **kwargs):
            raise ShardReadError("osd down")

        write_shard = read_shard = get_attr = remove_shard = _down
        stat_shard = get_attrs = _down

    async def durable(root):
        be, stores = await wal_backend(root)
        names = [f"rbd_data.d{i:04x}" for i in range(OSD_OBJECTS)]
        blob = rng.bytes(OSD_OBJECTS * OSD_OBJECT_BYTES)
        datas = {nm: blob[i * OSD_OBJECT_BYTES:(i + 1) * OSD_OBJECT_BYTES]
                 for i, nm in enumerate(names)}
        total = OSD_OBJECTS * OSD_OBJECT_BYTES
        await wave("c: write", be, total, lambda: asyncio.gather(*(
            be.write(nm, d) for nm, d in datas.items())))
        if waves[-1]["ec_coalesce_ops"] != OSD_OBJECTS:
            raise AssertionError(f"{OSD_OBJECTS} concurrent writes coalesced "
                                 f"{waves[-1]['ec_coalesce_ops']} ops")
        # every store unmounted and mounted fresh on its directory
        t0 = time.perf_counter()
        for store, _ in stores.values():
            await store.umount()
        t_umount = time.perf_counter() - t0
        be, stores = await wal_backend(root)
        log(f"[osd] (c) umount of {n} WalStores {t_umount:.3f} s, mount "
            f"{time.perf_counter() - t0 - t_umount:.3f} s")
        got = await wave("c: read after remount", be, total,
                         lambda: asyncio.gather(*(be.read(nm)
                                                  for nm in names)))
        if got != [datas[nm] for nm in names]:
            raise AssertionError("read-back after remount differs")
        # the up set changes: shard OSD_MOVED moves to a fresh store
        old_store, cid = stores[OSD_MOVED]
        new_store = WalStore(os.path.join(root, f"osd.{OSD_MOVED}.new"))
        await new_store.mount()
        await new_store.queue_transactions(
            Transaction().create_collection(cid))
        be.shards[OSD_MOVED] = LocalShard(new_store, cid, pool=1,
                                          shard=OSD_MOVED)
        meta = MemStore()
        await meta.queue_transactions(Transaction().create_collection(
            pg_log.meta_cid(1, 0)))
        engine = BackfillEngine(RepairScheduler(be.perf), be.perf,
                                store=meta)
        done = await wave(f"c: backfill shard {OSD_MOVED}", be, total,
                          lambda: engine.drain_pg(
                              be, {nm: [OSD_MOVED] for nm in names},
                              pool=1, ps=0, epoch=2))
        moved = {key: be.perf.value(key) for key in (
            "backfill_objects", "backfill_batches", "backfill_bytes")}
        if (sorted(done) != names
                or moved["backfill_objects"] != OSD_OBJECTS
                or moved["backfill_batches"] < 1):
            raise AssertionError(f"backfill moved {len(done)} objects: "
                                 f"{moved}")
        for nm in names:
            oid = GHObject(1, nm, shard=OSD_MOVED)
            if (new_store.read(cid, oid) != old_store.read(cid, oid)
                    or new_store.getattrs(cid, oid)[HINFO_ATTR]
                    != old_store.getattrs(cid, oid)[HINFO_ATTR]):
                raise AssertionError(f"backfilled shard {OSD_MOVED} of {nm} "
                                     f"differs from the old store's")
        log(f"[osd] (c) backfill: {moved}, every moved shard and hinfo "
            f"equal to the old store's")
        for s in OSD_DOWN:
            be.shards[s] = DownShard()
        got = await wave("c: degraded read", be, total,
                         lambda: asyncio.gather(*(be.read(nm)
                                                  for nm in names)))
        if got != [datas[nm] for nm in names]:
            raise AssertionError(f"degraded read with {OSD_DOWN} down "
                                 f"differs")
        for store, _ in stores.values():
            await store.umount()
        await new_store.umount()
        log(f"[osd] (c) {OSD_OBJECTS} x {OSD_OBJECT_BYTES} B on {n} "
            f"WalStores (native WAL): remount read-back, backfill of shard "
            f"{OSD_MOVED} and degraded reads with {OSD_DOWN} down through "
            f"the moved shard bit-identical")

    async def mapped(root):
        from types import SimpleNamespace

        from ceph_tpu_torch.osd import backfill, osd_map
        from ceph_tpu_torch.osd.pg import object_to_ps
        from ceph_tpu_torch.placement import crush_map

        t0 = time.perf_counter()
        osdmap = ec_pool_map(crush_map, osd_map)
        tables = osdmap.mapping().up_acting_tables(MAP_POOL)
        t1 = time.perf_counter()
        holes = check_ec_tables(osdmap, tables)
        t2 = time.perf_counter()
        motion = map_motion(osdmap, osd_map, backfill)
        t3 = time.perf_counter()
        ps, positions = motion["ps"], motion["positions"]
        old_up, new_up = motion["rows"][ps]
        names = pg_object_names(object_to_ps, ps, OSD_OBJECTS, seed)
        t4 = time.perf_counter()
        rec = {"osds": MAP_HOSTS * MAP_OSDS_PER_HOST, "hosts": MAP_HOSTS,
               "pg_num": MAP_PG_NUM, "out": MAP_OUT_OSD,
               "pgs_with_holes": holes,
               "map_ms": (t1 - t0) * 1e3, "scalar_check_ms": (t2 - t1) * 1e3,
               "remap_diff_plan_ms": (t3 - t2) * 1e3,
               "names_ms": (t4 - t3) * 1e3,
               "held_pgs": len(motion["held"]),
               "moved_pgs": motion["plan"]["moved_pgs"],
               "undersized_pgs": len(motion["undersized"]),
               "groups": len(motion["plan"]["groups"]), "pg": ps,
               "positions": positions, "old_up": old_up, "new_up": new_up}
        log(f"[osd] (d) map {json.dumps(rec)}")
        blob = rng.bytes(OSD_OBJECTS * OSD_OBJECT_BYTES)
        datas = {nm: blob[i * OSD_OBJECT_BYTES:(i + 1) * OSD_OBJECT_BYTES]
                 for i, nm in enumerate(names)}
        ns = SimpleNamespace(
            WalStore=WalStore, MemStore=MemStore, Transaction=Transaction,
            CollectionId=CollectionId, GHObject=GHObject,
            LocalShard=LocalShard, ECBackend=ECBackend,
            BackfillEngine=BackfillEngine, RepairScheduler=RepairScheduler,
            pg_log=pg_log, HINFO_ATTR=HINFO_ATTR)
        res = await map_drain(ns, codec, root, motion, datas, wave=wave)
        checked_drain(res, names, "the map-driven backfill")
        log(f"[osd] (d) {OSD_OBJECTS} x {OSD_OBJECT_BYTES} B in PG "
            f"{MAP_POOL}.{ps:x}: positions {positions} rebuilt by "
            f"BackfillEngine.drain_pg ({res['counters']}), every shard and "
            f"hinfo equal to the old stores', read back bit-identical with "
            f"osd.{MAP_OUT_OSD}'s store gone")
        return osdmap, motion, ns

    def checked_drain(res, names, what):
        """A drain's verdict: every object moved and read back, every
        rebuilt shard and hinfo equal to the old store's, 64 objects
        counted."""
        if res["done"] != sorted(names) or not res["reads"]:
            raise AssertionError(f"{what} moved {len(res['done'])} objects, "
                                 f"read-back equal: {res['reads']}")
        if res["rebuilt"] != res["old"]:
            raise AssertionError(f"{what}: a rebuilt shard or hinfo differs "
                                 f"from the old store's")
        if res["counters"]["backfill_objects"] != OSD_OBJECTS:
            raise AssertionError(f"{what}: backfill counters "
                                 f"{res['counters']}")

    async def monitored(root, osdmap, motion_d, osd_ns):
        from types import SimpleNamespace

        from ceph_tpu_torch import client, mon
        from ceph_tpu_torch.common.config import ConfigProxy
        from ceph_tpu_torch.msg import reset_local_namespace
        from ceph_tpu_torch.osd import backfill
        from ceph_tpu_torch.osd.pg import object_to_ps
        from ceph_tpu_torch.placement import compiler

        ns = SimpleNamespace(
            Monitor=mon.Monitor, MonClient=mon.MonClient, Rados=client.Rados,
            ConfigProxy=ConfigProxy, backfill=backfill,
            object_to_ps=object_to_ps,
            reset_local_namespace=reset_local_namespace)

        async def mon_wave(label, be, nbytes, fn):
            return await wave(label, be, nbytes, fn, prefix="[mon]")

        async def drain(motion, names):
            blob = rng.bytes(OSD_OBJECTS * OSD_OBJECT_BYTES)
            datas = {nm: blob[i * OSD_OBJECT_BYTES:(i + 1) * OSD_OBJECT_BYTES]
                     for i, nm in enumerate(names)}
            res = await map_drain(osd_ns, codec, root, motion, datas,
                                  wave=mon_wave, tag="e")
            checked_drain(res, names, "the quorum-driven backfill")
            return res

        t0 = time.perf_counter()
        out = await mon_map_wave(ns, compiler.decompile(osdmap.crush),
                                 MAP_PG_NUM, motion_d, OSD_OBJECTS, seed,
                                 drain=drain)
        motion = out["motion"]
        log(f"[mon] (e) a port quorum committed the {MAP_PG_NUM}-PG pool "
            f"(epoch {out['pool_epoch']}) and osd.{MAP_OUT_OSD} out (epoch "
            f"{out['out_epoch']}): the client's tables equal (d)'s, "
            f"{motion['plan']['moved_pgs']} PGs moved in "
            f"{len(motion['plan']['groups'])} groups as in (d); PG "
            f"{MAP_POOL}.{motion['ps']:x} positions {motion['positions']} "
            f"targeted at osd.{out['targets'][0]} and drained "
            f"({out['drained']['counters']}), read back bit-identical; "
            f"{time.perf_counter() - t0:.2f} s")

    try:
        asyncio.run(classic())
        asyncio.run(resident())
        with tempfile.TemporaryDirectory(prefix="chip_smoke_osd_") as root:
            asyncio.run(durable(root))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_map_") as root:
            osdmap, motion, osd_ns = asyncio.run(mapped(root))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mon_") as root:
            asyncio.run(monitored(root, osdmap, motion, osd_ns))
    finally:
        for name, fn in shimmed.items():
            ck.KERNELS[name] = fn
            setattr(ck, name, fn)
    return {"waves": waves, "seconds": time.perf_counter() - t_phase}


# The mesh phase, wave (g): the multi-device planes on MESH_SLOTS slots
# forced over one device (parallel.mesh.forced_device_count), each slot with
# its own stream.  Planes at the headline (k=8 m=4 reed_sol_van, 16384 x 4
# KiB on dp=2 cs=4; CLAY k=8 m=4 d=11 and LRC k=12 m=4 l=4 at 512 stripes of
# 64 KiB chunks), bench.py's cfg8 arms at the OSD phase's width (64 x 4 MiB
# writes through two backends on one MeshCoalescer, SHEC k=4 m=3 c=2, the
# CLAY/LRC sub-chunk repairs at 128 stripes of 64 KiB chunks, the
# osd_ec_mesh_cs plane, a resident batchmate), then 12 port OSD daemons on
# the host coalescer serving the Ceph docs' 8+4 pool of MESH_PG_NUM PGs.
MESH_SLOTS = 8
MESH_CS = 4
MESH_BUDGET_S = 120.0
MESH_LRC = {"k": "12", "m": "4", "l": "4"}
MESH_LRC_GROUPS = 4
MESH_LRC_LOST = (0, 6)
MESH_SHEC = {"k": "4", "m": "3", "c": "2"}
MESH_SHEC_STRIPES = 4096          # 16 MiB of data at 1 KiB chunks
MESH_BACKEND_REPAIR_STRIPES = 128
MESH_PG_NUM = 16
MESH_VICTIM = 5


def mesh_phase(dev, *, stripes: int = STRIPES,
               repair_stripes: int = CLAY_STRIPES,
               repair_sc: int = CLAY_SC,
               backend_repair_stripes: int = MESH_BACKEND_REPAIR_STRIPES,
               objects: int = OSD_OBJECTS,
               object_bytes: int = OSD_OBJECT_BYTES,
               shec_stripes: int = MESH_SHEC_STRIPES,
               pg_num: int = MESH_PG_NUM, seconds=None, sync=None,
               seed: int = SEED, note=log) -> dict:
    """Wave (g) on ``dev`` (the card, or the CPU for a rehearsal at small
    sizes): every step checked exact, one "[mesh]" JSON line each (wall
    seconds, client GiB/s where a client writes, kernel launches, the
    per-slot stripes read off the placed batch, the modelled interconnect
    bytes beside the whole-chunk bytes where a repair has them, and the
    bytes the mesh moved: ``slot`` between slots, ``host`` uploaded,
    ``place`` device to device).  ``seconds(fn)``: device seconds per call
    of fn (CUDA events on the card), each plane beside its single-device
    call for the same work.  Raises on any failure, on a batch axis that
    does not split over every slot, and when B1 or B3 was not launched;
    returns the steps, the launches and the phase's seconds."""
    import asyncio

    import numpy as np
    import torch

    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.ec import reference
    from ceph_tpu_torch.ec.engine import default_engine
    from ceph_tpu_torch.ec.matrix import generator_matrix
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.ec.repair_operator import (clay_repair_operator,
                                                   lrc_repair_operator)
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
    from ceph_tpu_torch.osd.mesh_coalesce import (MeshCoalescer,
                                                  reset_host_coalescer)
    from ceph_tpu_torch.parallel import clay_sharding, lrc_sharding, mesh
    from ceph_tpu_torch.parallel.ec_sharding import (ShardedApplier,
                                                     distributed_ec_step,
                                                     make_ec_mesh,
                                                     shard_layout,
                                                     sharded_encode)
    from ceph_tpu_torch.placement import compiler
    from ceph_tpu_torch.store import (CollectionId, GHObject, MemStore,
                                      Transaction)

    dev = torch.device(dev)
    sync = sync or (torch.cuda.synchronize if dev.type == "cuda"
                    else (lambda: None))
    rng = np.random.default_rng(seed)
    registry = ErasureCodePluginRegistry()
    steps: dict = {}
    t_phase = time.perf_counter()

    def factory(plugin, profile):
        return registry.factory(plugin, dict(profile), device=dev)

    def rand_dev(shape) -> torch.Tensor:
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def split_over_all(layout, what):
        if len(layout) != MESH_SLOTS or min(layout.values()) <= 0:
            raise AssertionError(f"{what}: the batch axis split as {layout},"
                                 f" not over all {MESH_SLOTS} slots")

    def exact(got, want, what):
        got = got if isinstance(got, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(got))
        want = want if isinstance(want, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(want))
        if not torch.equal(got.to(want.device), want):
            raise AssertionError(f"{what} differs")

    def begin():
        sync()
        return time.perf_counter(), dict(ck.LAUNCHES), dict(mesh.TRAFFIC)

    def record(step, start, nbytes=None, timing=None, **kw):
        """The step's line: what ran since ``start``, then (``timing``)
        its device times, which neither its wall time nor its counts
        include."""
        sync()
        t0, k0, m0 = start
        sec = time.perf_counter() - t0
        rec = {"step": step, "wall_s": sec,
               "client_gib_s": (None if nbytes is None
                                else nbytes / sec / 2**30),
               "kernel_launches": {k: v - k0[k] for k, v in
                                   ck.LAUNCHES.items() if v != k0[k]},
               "moved_bytes": {k: v - m0[k] for k, v in
                               mesh.TRAFFIC.items()}, **kw}
        if timing is not None:
            rec.update(timing())
        steps[step] = rec
        note(f"[mesh] {json.dumps(rec)}")
        return rec

    def timed(mesh_fn, single_fn):
        """A ``timing`` of the mesh call beside the single-device call for
        the same work; their launches and moved bytes are not counted."""
        if seconds is None:
            return None

        def timing():
            k0, m0 = dict(ck.LAUNCHES), dict(mesh.TRAFFIC)
            out = {"mesh_ms": seconds(mesh_fn) * 1e3,
                   "single_ms": seconds(single_fn) * 1e3}
            ck.LAUNCHES.update(k0)
            mesh.TRAFFIC.update(m0)
            return out
        return timing

    # -- 1. the planes at the headline ----------------------------------------
    slots = mesh.local_devices(dev)
    if len(slots) != MESH_SLOTS or {s.device for s in slots} != {dev}:
        raise AssertionError(f"slots {slots}: not {MESH_SLOTS} over {dev}")
    m_ec = make_ec_mesh(slots, cs=MESH_CS)
    G = generator_matrix("reed_sol_van", K, M)
    codec = factory("jax_rs", {"k": str(K), "m": str(M),
                               "technique": "reed_sol_van"})
    eng = default_engine(dev)
    data = rand_dev((stripes, K, CHUNK))
    words = ck.bytes_to_words(data.permute(1, 0, 2).reshape(K, -1))
    parity = ck.words_to_bytes(codec.encode_words_device(words)) \
        .reshape(M, stripes, CHUNK).permute(1, 0, 2)
    full = torch.cat([data, parity], dim=1)
    nbytes = data.numel()

    start = begin()
    enc = sharded_encode(m_ec, G, data)
    layout = shard_layout(enc)
    exact(enc.assemble(), full, "sharded_encode")
    split_over_all(layout, "sharded_encode")
    record("sharded_encode", start, per_slot_stripes=layout,
           data_bytes=nbytes, timing=timed(
               lambda: sharded_encode(m_ec, G, data),
               lambda: codec.encode_chunks_device(data)))

    lost = 3
    survivors = [i for i in range(K + M) if i != lost][:K]
    D1 = reference.decode_matrix(G, survivors, [lost])
    surv_idx = torch.tensor(survivors, dtype=torch.long, device=dev)
    start = begin()
    shard, repaired = distributed_ec_step(m_ec, G, data, lost_chunk=lost)
    exact(shard.assemble(), full, "distributed_ec_step's shard slices")
    exact(repaired.assemble(), full[:, lost], "the repaired chunk 3")
    layout = shard_layout(shard)
    split_over_all(layout, "distributed_ec_step")
    record("distributed_ec_step", start, per_slot_stripes=layout,
           data_bytes=nbytes, timing=timed(
               lambda: distributed_ec_step(m_ec, G, data, lost_chunk=lost),
               lambda: eng.apply(D1, codec.encode_chunks_device(data)
                                 .index_select(1, surv_idx))))

    enc_ap = ShardedApplier(m_ec, G[K:])
    start = begin()
    x = enc_ap.place(data)
    layout = shard_layout(x)
    split_over_all(layout, "ShardedApplier encode")
    exact(enc_ap.run_placed(x).assemble(), parity, "ShardedApplier encode")
    record("applier_encode", start, per_slot_stripes=layout,
           data_bytes=nbytes, timing=timed(
               lambda: enc_ap.run_placed(enc_ap.place(data)),
               lambda: eng.apply(G[K:], data)))

    avail = [i for i in range(K + M) if i not in HEADLINE_LOST][:K]
    D4 = reference.decode_matrix(G, avail, HEADLINE_LOST)
    stacked = full.index_select(
        1, torch.tensor(avail, dtype=torch.long, device=dev))
    dec_ap = ShardedApplier(m_ec, D4)
    start = begin()
    x = dec_ap.place(stacked)
    layout = shard_layout(x)
    split_over_all(layout, "ShardedApplier decode")
    exact(dec_ap.run_placed(x).assemble(), full.index_select(
        1, torch.tensor(HEADLINE_LOST, dtype=torch.long, device=dev)),
          f"ShardedApplier decode of {HEADLINE_LOST}")
    record("applier_decode", start, per_slot_stripes=layout,
           lost=HEADLINE_LOST, timing=timed(
               lambda: dec_ap.run_placed(dec_ap.place(stacked)),
               lambda: eng.apply(D4, stacked)))
    del data, words, parity, full, enc, shard, repaired, x, stacked

    clay = factory("clay", CLAY)
    C = clay.sub_chunk_no * repair_sc
    chunks = clay.encode_chunks_device(rand_dev((repair_stripes, K, C)))
    R, helpers, planes = clay_repair_operator(clay, CLAY_LOST)
    moved, whole = clay_sharding.clay_repair_ici_bytes(
        clay, len(helpers), repair_stripes, C)

    def clay_single():
        """The same work on one device: the operator's probe (which the
        mesh call makes too), the helpers' planes, one B3 apply."""
        R, helpers, planes = clay_repair_operator(clay, CLAY_LOST)
        b = chunks.shape[0]
        hp = torch.stack([chunks[:, h].reshape(b, clay.sub_chunk_no,
                                               repair_sc)[:, planes]
                          for h in helpers], dim=1)
        return clay_sharding.batched_clay_plane_repair_device(
            clay, R, hp.reshape(b, -1, repair_sc))

    start = begin()
    got = clay_sharding.sharded_clay_repair(m_ec, clay, chunks, CLAY_LOST)
    exact(got.assemble(), chunks[:, CLAY_LOST], "sharded_clay_repair")
    layout = shard_layout(got)
    if len(layout) != MESH_SLOTS:
        raise AssertionError(f"sharded_clay_repair ran on {layout}")
    record("sharded_clay_repair", start, per_slot_stripes=layout,
           ici_bytes=moved, ici_whole_bytes=whole,
           repaired_bytes=repair_stripes * C, timing=timed(
               lambda: clay_sharding.sharded_clay_repair(
                   m_ec, clay, chunks, CLAY_LOST), clay_single))
    del chunks, got

    lrc = factory("lrc", MESH_LRC)
    m_grp = lrc_sharding.make_group_mesh(slots, MESH_LRC_GROUPS)
    chunks = lrc.encode_chunks_device(
        rand_dev((repair_stripes, lrc.get_data_chunk_count(), C)))

    def lrc_single(lost_one):
        """The same work on one device: the operator's probe, the group's
        chunks, one apply, the chunk back to the host (the mesh call
        returns it there too)."""
        coeffs, minimum = lrc_repair_operator(lrc, lost_one)
        idx = torch.tensor(minimum, dtype=torch.long, device=dev)
        return eng.apply(coeffs, chunks.index_select(1, idx)).cpu().numpy()

    for lrc_lost in MESH_LRC_LOST:
        coeffs, minimum = lrc_repair_operator(lrc, lrc_lost)
        moved, whole = lrc_sharding.lrc_repair_ici_bytes(
            lrc, len(minimum), repair_stripes, C)
        start = begin()
        got = lrc_sharding.sharded_lrc_repair(m_grp, lrc, chunks, lrc_lost)
        exact(got, chunks[:, lrc_lost], f"sharded_lrc_repair of {lrc_lost}")
        record(f"sharded_lrc_repair_{lrc_lost}", start,
               groups=MESH_LRC_GROUPS, gs=MESH_SLOTS // MESH_LRC_GROUPS,
               ici_bytes=moved, ici_whole_bytes=whole,
               repaired_bytes=repair_stripes * C, timing=timed(
                   lambda: lrc_sharding.sharded_lrc_repair(
                       m_grp, lrc, chunks, lrc_lost),
                   functools.partial(lrc_single, lrc_lost)))
    del chunks, got

    # -- 2. cfg8 at the OSD phase's width, backend level ----------------------
    async def backend(plugin, profile, unit, **kw):
        ec = factory(plugin, profile)
        stores, shards = {}, {}
        for i in range(ec.get_chunk_count()):
            store = MemStore()
            cid = CollectionId(1, 0, shard=i)
            await store.queue_transactions(
                Transaction().create_collection(cid))
            stores[i] = (store, cid)
            shards[i] = LocalShard(store, cid, pool=1, shard=i)
        be = ECBackend(ec, shards, stripe_unit=unit, **kw)
        be._stores = stores
        return be

    def ici(*bes):
        return {k: sum(b.perf.value(k) for b in bes) for k in (
            "ec_mesh_ici_bytes", "ec_mesh_ici_whole_bytes")}

    async def cfg8():
        rs = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
        co = MeshCoalescer(devices=slots)
        b1 = await backend("jax_rs", rs, CHUNK, mesh_coalescer=co)
        b2 = await backend("jax_rs", rs, CHUNK, mesh_coalescer=co)
        if b1.mesh_co is not co or b2.mesh_co is not co:
            raise AssertionError("cfg8: the backends did not join the mesh")
        datas = {f"obj-{i}": rng.bytes(object_bytes) for i in range(objects)}
        start = begin()
        await asyncio.gather(*(b.write(o, d) for o, d in datas.items()
                               for b in (b1, b2)))
        w_s = time.perf_counter() - start[0]
        for b in (b1, b2):
            got = await asyncio.gather(*(b.read(o) for o in datas))
            if got != list(datas.values()):
                raise AssertionError("cfg8: read-back differs")
        st = co.stats()
        if st["cross_backend_launches"] < 1:
            raise AssertionError(f"cfg8: no launch carried two backends' "
                                 f"ops: {st}")
        split_over_all(st["per_device_stripes"], "cfg8's coalescer")
        record("cfg8_coalesced", start, 4 * objects * object_bytes,
               write_s=w_s, write_gib_s=2 * objects * object_bytes / w_s
               / 2**30, **{k: st[k] for k in (
                   "launches", "ops", "cross_backend_launches",
                   "max_backends_in_launch", "buckets",
                   "per_device_stripes")})

        bs = await backend("shec", MESH_SHEC, 1024, mesh_coalescer=co)
        if bs.mesh_co is not co:
            raise AssertionError("cfg8: the shec backend did not join")
        batch = rng.integers(0, 256, (shec_stripes, bs.k,
                                      bs.sinfo.chunk_size), dtype=np.uint8)
        start = begin()
        got = await bs._coalesced_encode(batch)
        exact(got, await bs._encode_batch(batch),
              "cfg8: shec's sharded encode")
        record("cfg8_shec_encode", start, per_slot_stripes=dict(
            co.stats()["last_per_device"]))

        for plugin, profile, lost_one in (("clay", CLAY, CLAY_LOST),
                                          ("lrc", MESH_LRC, 6)):
            be = await backend(plugin, profile, C, mesh_coalescer=co)
            await be_repair(be, plugin, lost_one)

    async def be_repair(be, plugin, lost_one):
        batch = rng.integers(0, 256, (backend_repair_stripes, be.k,
                                      be.sinfo.chunk_size), dtype=np.uint8)
        full = np.asarray(await be._encode_batch(batch))
        avail = {i: full[:, i] for i in range(be.n) if i != lost_one}
        start = begin()
        got = await be._coalesced_decode(avail, [lost_one])
        exact(got[lost_one], full[:, lost_one],
              f"cfg8: {plugin}'s degraded read")
        c = ici(be)
        if be.mesh_stats["repairs"] != 1:
            raise AssertionError(f"cfg8: {plugin}'s degraded read did not "
                                 f"take the sub-chunk repair")
        if not 0 < c["ec_mesh_ici_bytes"] * 2 <= \
                c["ec_mesh_ici_whole_bytes"]:
            raise AssertionError(f"cfg8: {plugin} moved {c}")
        record(f"cfg8_{plugin}_repair", start, lost=lost_one,
               stripes=backend_repair_stripes,
               chunk_bytes=be.sinfo.chunk_size,
               ici_bytes=c["ec_mesh_ici_bytes"],
               ici_whole_bytes=c["ec_mesh_ici_whole_bytes"])

    async def mesh_cs_plane():
        rs = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
        be = await backend("jax_rs", rs, CHUNK,
                           mesh=make_ec_mesh(slots, cs=MESH_CS))
        if be.mesh is None:
            raise AssertionError("osd_ec_mesh_cs plane: no mesh")
        names = [f"cs-{i}" for i in range(objects)]
        datas = {nm: rng.bytes(object_bytes) for nm in names}
        start = begin()
        await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
        got = await asyncio.gather(*(be.read(o) for o in names))
        if got != [datas[o] for o in names]:
            raise AssertionError("osd_ec_mesh_cs plane: read-back differs")
        for nm in names:
            for s in OSD_LOST:
                store, cid = be._stores[s]
                await store.queue_transactions(
                    Transaction().remove(cid, GHObject(1, nm, shard=s)))
        res = await be.recover_batch(names, OSD_LOST)
        if sorted(res["recovered"]) != sorted(names):
            raise AssertionError(f"osd_ec_mesh_cs plane: recover_batch "
                                 f"left objects: {res}")
        got = await asyncio.gather(*(be.read(o) for o in names))
        if got != [datas[o] for o in names]:
            raise AssertionError("osd_ec_mesh_cs plane: read after "
                                 "recover_batch differs")
        if be.mesh_stats["encodes"] < 1:
            raise AssertionError(f"osd_ec_mesh_cs plane: {be.mesh_stats}")
        record("mesh_cs_plane", start, 3 * objects * object_bytes,
               mesh={"dp": MESH_SLOTS // MESH_CS, "cs": MESH_CS},
               encodes=be.mesh_stats["encodes"],
               decodes=be.mesh_stats["decodes"],
               recover_batches=res["batches"])

    async def resident_batchmate():
        co = MeshCoalescer(devices=slots)
        be = await backend("jax_rs", {"k": str(K), "m": str(M),
                                      "technique": "reed_sol_van"},
                           CHUNK, mesh_coalescer=co, resident=True)
        if be.resident is None or be.mesh_co is not co:
            raise AssertionError("resident batchmate: no resident mesh "
                                 "backend")
        batch = rand_dev((stripes // 16, K, CHUNK))
        h2d0 = be.perf.value("ec_resident_h2d_bytes")
        start = begin()
        got = await be._coalesced_encode(batch)
        h2d = be.perf.value("ec_resident_h2d_bytes") - h2d0
        if not be._is_device(got) or h2d != 0:
            raise AssertionError(f"resident batchmate: {h2d} H2D bytes")
        exact(got, codec.encode_chunks_device(batch), "resident batchmate")
        rec = record("resident_batchmate", start, h2d_bytes=h2d,
                     per_slot_stripes=dict(co.stats()["last_per_device"]))
        if rec["moved_bytes"]["host"] or rec["moved_bytes"]["place"]:
            raise AssertionError(f"resident batchmate moved "
                                 f"{rec['moved_bytes']}")
        split_over_all(rec["per_slot_stripes"], "resident batchmate")

    asyncio.run(cfg8())
    asyncio.run(mesh_cs_plane())
    asyncio.run(resident_batchmate())

    # -- 3. the daemons -------------------------------------------------------
    async def daemons():
        """1 mon and 12 OSD daemons (one per CRUSH host, MemStores) with
        ``osd_ec_mesh_coalesce`` on, the 8+4 pool of ``pg_num`` PGs,
        ``objects`` concurrent writes through a ``Rados``, read back; one
        OSD killed and marked down, every object read degraded; the ``ec
        mesh stats`` wire reply must name the mesh-coalesced plane, with
        fewer launches than ops and two or more backends in one launch."""
        liveness = {key: vstart.SCALE_TEST_OVERRIDES[key]
                    for key in CLUSTER_LIVENESS}
        reset_local_namespace()
        reset_host_coalescer()
        cluster = vstart.DevCluster(
            n_mons=1, n_osds=CLUSTER_OSDS, osds_per_host=1, device=dev,
            overrides={**liveness, "mon_osd_down_out_interval": 300.0,
                       "osd_ec_mesh_coalesce": True})
        rados = None
        try:
            start = begin()
            await cluster.start()
            rados = await cluster.client()
            record("daemons_boot", start, osds=len(cluster.osds))

            async def command(prefix, **kw):
                r = await rados.mon_command(prefix, timeout=CLUSTER_WAIT_S,
                                            **kw)
                if r["rc"] != 0:
                    raise AssertionError(f"{prefix}: {r}")

            async def until(cond, what):
                loop = asyncio.get_running_loop()
                deadline = loop.time() + CLUSTER_WAIT_S
                while not cond():
                    if loop.time() > deadline:
                        raise AssertionError(
                            f"no {what} in {CLUSTER_WAIT_S} s")
                    await asyncio.sleep(0.25)

            text = compiler.decompile(rados.monc.osdmap.crush)
            tunable = "tunable choose_total_tries 50\n"
            await command("osd setcrushmap", map=text.replace(
                tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
            await command("osd erasure-code-profile set", name="ec84",
                          profile=dict(CLUSTER_PROFILE))
            start = begin()
            pool_id = await rados.pool_create(
                "mesh", pool_type="erasure", erasure_code_profile="ec84",
                pg_num=pg_num)

            def active():
                return sum(1 for o in cluster.osds.values()
                           for pgid, pg in o.pgs.items()
                           if pgid.pool == pool_id and pg.is_primary
                           and pg.state == "active") == pg_num

            await until(active, "active PGs")
            record("daemons_pool", start, pg_num=pg_num)
            io = await rados.open_ioctx("mesh")
            datas = {f"mesh-{i}": rng.bytes(object_bytes)
                     for i in range(objects)}
            start = begin()
            await asyncio.gather(*(io.write_full(o, d)
                                   for o, d in datas.items()))
            w_s = time.perf_counter() - start[0]
            got = await asyncio.gather(*(io.read(o) for o in datas))
            if got != list(datas.values()):
                raise AssertionError("daemons: read-back differs")
            record("daemons_write_read", start, 2 * objects * object_bytes,
                   write_s=w_s,
                   write_gib_s=objects * object_bytes / w_s / 2**30)
            start = begin()
            await cluster.kill_osd(MESH_VICTIM)
            await command("osd down", ids=[MESH_VICTIM])
            await until(lambda: not rados.monc.osdmap.is_up(MESH_VICTIM),
                        f"osd.{MESH_VICTIM} down")
            t0 = time.perf_counter()
            got = await asyncio.gather(*(io.read(o) for o in datas))
            read_s = time.perf_counter() - t0
            if got != list(datas.values()):
                raise AssertionError("daemons: degraded read differs")
            host, planes, decodes = None, set(), 0
            for osd_id in sorted(cluster.osds):
                reply = await rados.osd_daemon_command(
                    osd_id, "ec_mesh_stats", timeout=CLUSTER_WAIT_S)
                host = reply.get("host") or host
                for key, pg in reply.items():
                    if key not in ("tid", "host"):
                        planes.add(pg["plane"])
                        decodes += pg["decodes"]
            record("daemons_degraded_read", start, objects * object_bytes,
                   read_s=read_s, victim=MESH_VICTIM, planes=sorted(planes),
                   pg_decodes=decodes, **{k: host[k] for k in (
                       "devices", "launches", "ops", "cross_backend_launches",
                       "max_backends_in_launch", "per_device_stripes")})
            if planes != {"mesh-coalesced"}:
                raise AssertionError(f"daemons: planes {planes}")
            if decodes < 1:
                raise AssertionError("daemons: no degraded read took the mesh "
                                     "decode plane")
            if not host["launches"] < host["ops"] or \
                    host["max_backends_in_launch"] < 2 or \
                    host["cross_backend_launches"] < 1:
                raise AssertionError(f"daemons: the host coalescer {host}")
            split_over_all({int(k): v for k, v in
                            host["per_device_stripes"].items()},
                           "the daemons' host coalescer")
        finally:
            if rados is not None:
                await rados.shutdown()
            await cluster.stop()
            reset_local_namespace()
            reset_host_coalescer()

    asyncio.run(daemons())
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


# Wave (h): a port mgr watches, judges and defends the 8+4 pool that twelve
# port OSD daemons serve.  The round-10 recipe's SLO targets (a small put
# p99, a short window, one eval to raise or clear) with the QoS controller
# on; the scale profile's liveness timers.  The put target is 150 ms, not
# the recipe's 50: healthy 4 KiB writes through twelve daemons in one
# process took a p99 over 50 ms on a slow host (the check never cleared),
# and the failpoint's 0.3 s delay burns either.
MGR_PG_NUM = 16
MGR_BUDGET_S = 120.0
MGR_WAIT_S = 60.0
MGR_LOADGEN_OPS = 200
MGR_FP_DELAY_S = 0.3
MGR_SMALL_BYTES = 4 << 10
MGR_OVERRIDES = {
    "mon_osd_down_out_interval": 300.0,
    "osd_ec_resident": True,
    "osd_scrub_interval": CLUSTER_SCRUB_INTERVAL_S,
    "slo_put_p99_ms": 150.0, "slo_window": 1.5,
    "slo_raise_evals": 1, "slo_clear_evals": 1,
    "qos_enable": True, "qos_ramp_ops": 64.0,
}
MGR_UTIL = ("device_gibps", "roofline_pct", "launch_bytes", "launch_seconds",
            "coalesce_occupancy", "coalesce_launches", "coalesce_wait_p50_us",
            "coalesce_wait_p99_us", "resident_hit_rate", "window_s")
MGR_GAUGES = ("ceph_util_device_gibps", "ceph_util_roofline_pct",
              "ceph_util_coalesce_occupancy", "ceph_util_resident_hit_rate",
              "ceph_slo_burn_rate")


async def _http(host: str, port: int, method: str, path: str,
                headers: dict | None = None, body: bytes = b""):
    """One HTTP/1.1 request over a fresh connection (the dashboard's, the
    S3 and Swift front ends'): (status, headers, body)."""
    import asyncio

    reader, writer = await asyncio.open_connection(host, port)
    try:
        hdrs = {"host": f"{host}:{port}", "content-length": str(len(body)),
                "connection": "close", **(headers or {})}
        head = "\r\n".join([f"{method} {path} HTTP/1.1"]
                           + [f"{k}: {v}" for k, v in hdrs.items()])
        writer.write(head.encode() + b"\r\n\r\n" + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    out = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        out[k.strip().lower()] = v.strip()
    return int(lines[0].split(" ")[1]), out, payload


async def mgr_wave(ns, *, pg_num: int = MGR_PG_NUM,
                   objects: int = CLUSTER_OBJECTS,
                   object_bytes: int = CLUSTER_OBJECT_BYTES,
                   loadgen_ops: int = MGR_LOADGEN_OPS, seed: int = SEED,
                   note=log) -> dict:
    """Wave (h) over one package's dev cluster ``ns`` (as ``cluster_wave``'s,
    plus ``fp``, the failpoint module, and ``loadgen``).

    1 mon and 12 OSD daemons (one per CRUSH host) on MemStores with the
    resident shard cache and the background deep scrub (held off by ``osd
    set noscrub``), the 8+4 profile with choose tries 100, a pool of
    ``pg_num`` PGs, and ``start_mgr(dashboard=True)`` with
    ``MGR_OVERRIDES``.  Four steps, an "[mgr]" JSON line each:

    1. serve: ``objects`` concurrent writes of ``object_bytes`` through a
       ``Rados``, each read back exactly; a seeded closed-loop ``LoadGen``
       over ``RadosBackend`` in ``bench.py --serve``'s shape (48 keys,
       tenant class gold, the default size mix, reads 0.7, zipf 1.1) with
       one client, ending with zero errors and every key read back as the
       generator wrote it; ``osd unset noscrub`` and one batched sweep
       verifying every object;
    2. judge: the digest's ``utilization`` section with launch bytes and
       coalesced launches in its window (the digest with the most launch
       bytes seen while the mgr reported), beside the daemons' summed
       ``ec_launch_bytes`` and the wave's kernel launches so far;
    3. scrape: ``mgr.prometheus_text()``, and ``/api/status``, ``/api/slo``
       and ``/metrics`` from the dashboard on 127.0.0.1: the scrape and
       ``/metrics`` carry the utilization and burn gauges, ``/api/slo``
       the utilization section, and the TSDB module holds their series;
    4. defend: once health is clear of SLO_VIOLATION, ``osd.sub_op``
       delayed ``MGR_FP_DELAY_S`` and small writes until the mon's health
       carries SLO_VIOLATION through the mgr and the QoS controller has
       retuned; the failpoint cleared, small writes until the check
       clears; then the QoS controller's position back at its ceilings.

    Raises on any failure; returns each step's record."""
    import asyncio

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(seed)
    steps: dict[str, dict] = {}
    loop = asyncio.get_running_loop()

    async def until(cond, what, timeout=MGR_WAIT_S, every=0.1):
        deadline = loop.time() + timeout
        while True:
            got = cond()
            if asyncio.iscoroutine(got):
                got = await got
            if got:
                return got
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {timeout:.0f} s")
            await asyncio.sleep(every)

    def record(step, t0, **kw):
        ns.sync()
        rec = {"step": step, "wall_s": time.perf_counter() - t0, **kw}
        steps[step] = rec
        note(f"[mgr] {json.dumps(rec)}")
        return rec

    def summed(key):
        return sum(o.perf.value(key) for o in cluster.osds.values())

    async def command(prefix, **kw):
        r = await rados.mon_command(prefix, timeout=MGR_WAIT_S, **kw)
        if r["rc"] != 0:
            raise AssertionError(f"{prefix}: {r}")
        return r

    async def checks():
        return (await command("health detail"))["data"]["checks"]

    t_phase = time.perf_counter()
    ns.reset_local_namespace()
    ns.fp.fp_clear()
    cluster = ns.DevCluster(n_mons=1, n_osds=CLUSTER_OSDS, osds_per_host=1,
                            overrides={**liveness, **MGR_OVERRIDES})
    rados = watcher = None
    peak: dict = {}

    async def watch_digests(mgr):
        """Keep the digest with the most launch bytes in its window."""
        while True:
            u = (mgr.last_digest or {}).get("utilization") or {}
            if u.get("launch_bytes", 0) > peak.get("launch_bytes", 0) and \
                    u.get("coalesce_launches", 0) > 0:
                peak.clear()
                peak.update(u)
            await asyncio.sleep(0.05)

    try:
        t0 = time.perf_counter()
        await cluster.start()
        rados = await cluster.client()
        await command("osd set", flag="noscrub")
        text = ns.compiler.decompile(rados.monc.osdmap.crush)
        tunable = "tunable choose_total_tries 50\n"
        await command("osd setcrushmap", map=text.replace(
            tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
        await command("osd erasure-code-profile set", name="ec84",
                      profile=dict(CLUSTER_PROFILE))
        pool_id = await rados.pool_create(
            "mgr", pool_type="erasure", erasure_code_profile="ec84",
            pg_num=pg_num)
        await command("osd pool set", pool="mgr", var="pg_autoscale_mode",
                      val="off")

        def active():
            return sum(1 for o in cluster.osds.values()
                       for pgid, pg in o.pgs.items()
                       if pgid.pool == pool_id and pg.is_primary
                       and pg.state == "active") == pg_num

        await until(active, "active PGs")
        mgr = await cluster.start_mgr(dashboard=True)
        mgr.modules["balancer"].active = False
        watcher = loop.create_task(watch_digests(mgr))
        record("boot", t0, mons=len(cluster.mons), osds=len(cluster.osds),
               pg_num=pg_num, dashboard=[mgr.dashboard.host,
                                         mgr.dashboard.port])

        # 1. serve
        t0 = time.perf_counter()
        k0 = ns.launches()
        io = await rados.open_ioctx("mgr")
        datas = {f"mgr-{i}": rng.bytes(object_bytes) for i in range(objects)}
        await asyncio.gather(*(io.write_full(o, d) for o, d in datas.items()))
        w_s = time.perf_counter() - t0
        got = await asyncio.gather(*(io.read(o) for o in datas))
        bad = [o for o, g in zip(datas, got) if g != datas[o]]
        if bad:
            raise AssertionError(f"serve: {len(bad)} objects differ")
        # one client: an EC read racing an overwrite of its own object can
        # fail in both packages (ROADMAP Queue C)
        lg = ns.loadgen
        gen = lg.LoadGen(lg.RadosBackend(io, prefix="serve"), seed=seed,
                         mode="closed", clients=1, total_ops=loadgen_ops,
                         n_keys=48, tenant_class="gold", read_fraction=0.7,
                         zipf_s=1.1)
        await gen.populate()
        res = await gen.run()
        if res["errors"] or res["ops"] != loadgen_ops:
            raise AssertionError(f"serve: load generator {res}")
        for key, size in gen.key_sizes().items():
            if await io.read(f"serve-{key}") != lg._payload(key, size):
                raise AssertionError(f"serve: key {key} differs")
        t1 = time.perf_counter()
        await command("osd unset", flag="noscrub")
        scrub = {}
        n_objects = objects + len(gen.key_sizes())

        async def swept():
            scrub.clear()
            for osd_id in cluster.osds:
                stats = await rados.osd_daemon_command(
                    osd_id, "ec_scrub_stats", timeout=MGR_WAIT_S)
                for key in ("sweeps", "objects", "errors"):
                    scrub[key] = scrub.get(key, 0) + \
                        stats["engine"].get(key, 0)
            return scrub["objects"] >= n_objects

        await until(swept, "background scrub sweep", every=0.25)
        if scrub["errors"]:
            raise AssertionError(f"the scrub found {scrub['errors']} errors")
        # no more sweeps: the defend step's window holds client writes only
        await command("osd set", flag="noscrub")
        k1 = ns.launches()
        record("serve", t0, write_s=w_s,
               write_gib_s=objects * object_bytes / w_s / 2**30,
               loadgen={k: res[k] for k in (
                   "ops", "errors", "puts", "gets", "bytes_put", "bytes_get",
                   "wall_s", "ops_per_s", "p50_ms", "p99_ms", "p999_ms")},
               scrub_s=time.perf_counter() - t1, scrub=dict(scrub),
               kernel_launches={k: k1[k] - k0.get(k, 0) for k in k1
                                if k1[k] != k0.get(k, 0)})

        # 2. judge
        t0 = time.perf_counter()
        await until(lambda: peak, "a utilization window with launches")
        util = {key: peak.get(key) for key in MGR_UTIL}
        k2 = ns.launches()
        record("judge", t0, utilization=util,
               ec_launch_bytes=summed("ec_launch_bytes"),
               ec_launch_s=(summed("ec_encode_launch_us")
                            + summed("ec_decode_launch_us")) / 1e6,
               peak_gibps=float(mgr.conf["ec_hbm_peak_gibps"]),
               kernel_launches={k: v for k, v in k2.items() if v})
        for key in MGR_UTIL:
            if not isinstance(util[key], (int, float)) or \
                    not np.isfinite(util[key]):
                raise AssertionError(f"judge: utilization {key} {util}")

        # 3. scrape
        t0 = time.perf_counter()
        text = mgr.prometheus_text(await mgr.collect(),
                                   mgr.prometheus_extra())
        host, port = mgr.dashboard.host, mgr.dashboard.port
        codes, bodies = {}, {}
        for path in ("/api/status", "/api/slo", "/metrics"):
            codes[path], _, bodies[path] = await _http(host, port, "GET",
                                                       path)
        status = json.loads(bodies["/api/status"])
        slo = json.loads(bodies["/api/slo"])
        metrics = bodies["/metrics"].decode()
        missing = [(where, g) for where, body in (("scrape", text),
                                                  ("/metrics", metrics))
                   for g in MGR_GAUGES if f"\n{g}" not in f"\n{body}"]
        series = mgr.ts_query()["names"]
        want = ["util.device_gibps", "util.roofline_pct",
                "util.launch_bytes", "slo.put_p99_ms.burn"]
        record("scrape", t0, codes=codes, scrape_lines=len(
            text.splitlines()), metrics_lines=len(metrics.splitlines()),
            status_pgs=status.get("pgmap", {}).get("num_pgs"),
            slo_keys=sorted(slo), utilization_keys=len(slo.get(
                "utilization", {})), tsdb_series=len(series),
            missing=missing)
        if set(codes.values()) != {200} or missing:
            raise AssertionError(f"scrape: {codes} missing {missing}")
        if not slo.get("utilization") or status.get("pgmap", {}).get(
                "num_pgs") != pg_num:
            raise AssertionError(f"scrape: /api/slo {sorted(slo)} "
                                 f"/api/status {status.get('pgmap')}")
        if [s for s in want if s not in series]:
            raise AssertionError(f"scrape: tsdb lacks "
                                 f"{[s for s in want if s not in series]}")

        # 4. defend
        t0 = time.perf_counter()

        async def clear():
            return "SLO_VIOLATION" not in await checks()

        await until(clear, "health clear of SLO_VIOLATION")

        def qos():
            return (mgr.last_digest or {}).get("qos") or {}

        before = dict(qos())
        ns.fp.fp_set("osd.sub_op", "delay", delay=MGR_FP_DELAY_S)
        small = rng.bytes(MGR_SMALL_BYTES)
        n = 0
        try:
            async def raised():
                nonlocal n
                await io.write_full(f"slow-{n}", small)
                n += 1
                return (await checks()).get("SLO_VIOLATION")

            check = await until(raised, "SLO_VIOLATION", every=0.02)
            t_raise = time.perf_counter() - t0

            async def retuned():
                nonlocal n
                await io.write_full(f"slow-{n}", small)
                n += 1
                q = qos()
                return q.get("burning") and \
                    q.get("retunes", 0) > before.get("retunes", 0) and q

            moved = dict(await until(retuned, "a QoS retune", every=0.02))
        finally:
            ns.fp.fp_clear("osd.sub_op")
        t1 = time.perf_counter()

        async def cleared():
            await io.write_full("fast", small)
            return await clear()

        await until(cleared, "SLO_VIOLATION to clear", every=0.02)
        t_clear = time.perf_counter() - t1

        def ceiled():
            q = qos()
            return not q.get("burning", True) and all(
                q.get(f"{c}_limit") == q.get(f"{c}_ceiling")
                for c in ("recovery", "backfill", "scrub", "replication"))

        await until(ceiled, "the QoS controller back at its ceilings")
        after = dict(qos())
        record("defend", t0, raise_s=t_raise, clear_s=t_clear,
               slow_writes=n, check={"severity": check["severity"],
                                     "message": check["message"]},
               qos_before={k: before.get(k) for k in (
                   "retunes", "recovery_limit", "burning")},
               qos_moved={k: moved.get(k) for k in (
                   "retunes", "recovery_limit", "scrub_limit", "burning",
                   "burn")},
               qos_after={k: after.get(k) for k in (
                   "retunes", "recovery_limit", "burning")})
        if check["severity"] != "HEALTH_WARN" or \
                "put_p99_ms" not in check["message"]:
            raise AssertionError(f"defend: SLO_VIOLATION {check}")
        if not moved["recovery_limit"] < before.get(
                "recovery_ceiling", moved["recovery_limit"] + 1):
            raise AssertionError(f"defend: the QoS controller {moved}")
    finally:
        if watcher is not None:
            watcher.cancel()
        ns.fp.fp_clear()
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def mgr_phase(dev) -> dict:
    """Wave (h) on the port's dev cluster, its OSD daemons on the CUDA
    device ``dev``."""
    import asyncio
    import functools
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.common import failpoint
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.placement import compiler
    from ceph_tpu_torch.testing import loadgen

    ns = SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        fp=failpoint, loadgen=loadgen, launches=lambda: dict(ck.LAUNCHES),
        sync=torch.cuda.synchronize)
    return asyncio.run(mgr_wave(ns))


# Wave (i): S3 traffic through the port's gateway, tiered into the 8+4 EC
# cold pool that twelve port OSD daemons serve.  The gateway's zone
# placement provisions the cold class at ensure_pool's 8 PGs with the
# headline jax_rs profile over OSD failure domains; the hot pool is
# replicated.  GC entries wait an hour, so deletes ride the GC queue.
RGW_BUDGET_S = 120.0
RGW_WAIT_S = 60.0
# 64 until waves (j) and (k) joined the script; 32 keeps it near 500 s
RGW_OBJECTS = 32
RGW_OBJECT_BYTES = 4 << 20
RGW_MULTIPART_BYTES = 64 << 20
RGW_PART_BYTES = 8 << 20
RGW_LOADGEN_OPS = 200
RGW_DELETES = 16
RGW_TRANSITION_DAYS = 30
RGW_TOKEN = "wave-i"
RGW_OVERRIDES = {
    "mon_osd_down_out_interval": 300.0,
    "osd_ec_resident": True,
    "osd_scrub_interval": CLUSTER_SCRUB_INTERVAL_S,
    "rgw_gc_obj_min_wait": 3600.0,
}
B1, B2 = "gf2_apply_words", "gf2_apply_u8"


async def _s3(rgw_http, host: str, port: int, ak: str, sk: str,
              method: str, path: str, body: bytes = b"",
              headers: dict | None = None):
    """One SigV4-signed S3 request, signed with the gateway's own
    ``_Request``/``sigv4_sign`` as the load generator's S3 client signs:
    (status, headers, body)."""
    import hashlib

    hdrs = {"host": f"{host}:{port}",
            "x-amz-date": time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
            "x-amz-content-sha256": hashlib.sha256(body).hexdigest(),
            **(headers or {})}
    hdrs["authorization"] = rgw_http.sigv4_sign(
        rgw_http._Request(method, path, hdrs, body), ak, sk)
    return await _http(host, port, method, path, hdrs, body)


async def rgw_wave(ns, *, n_osds: int = CLUSTER_OSDS, ec_k: int = 8,
                   ec_m: int = 4, objects: int = RGW_OBJECTS,
                   object_bytes: int = RGW_OBJECT_BYTES,
                   multipart_bytes: int = RGW_MULTIPART_BYTES,
                   part_bytes: int = RGW_PART_BYTES,
                   loadgen_ops: int = RGW_LOADGEN_OPS,
                   deletes: int = RGW_DELETES, victim: int = CLUSTER_VICTIM,
                   need: tuple = (B1,), seed: int = SEED,
                   note=log) -> dict:
    """Wave (i) over one package's dev cluster ``ns`` (as ``mgr_wave``'s,
    plus ``rgw_http``, the gateway's front-end module).

    1 mon and ``n_osds`` OSD daemons (one per CRUSH host, MemStores, the
    resident shard cache, the background deep scrub held off by ``osd set
    noscrub``), CRUSH's choose tries at 100, a mgr with its dashboard, and
    ``start_rgw(cold_pool="rgw.cold", ec_k=, ec_m=)``: a replicated hot
    pool ``rgw`` and the cold class ``COLD`` on an erasure-coded pool of 8
    PGs.  One user; every request SigV4-signed over 127.0.0.1.  Seven
    steps, an "[rgw]" JSON line each (wall seconds, bytes, GiB/s, kernel
    launches):

    1. put-cold: ``objects`` concurrent PUTs of ``object_bytes`` with
       ``x-amz-storage-class: COLD`` into bucket ``cold``;
    2. put-hot + transition: ``objects`` PUTs through the load generator's
       ``S3Backend`` into bucket ``hot`` (STANDARD, the hot pool), one
       multipart upload of ``multipart_bytes`` in ``part_bytes`` parts, a
       lifecycle rule moving everything to COLD after
       ``RGW_TRANSITION_DAYS`` days, then ``lc_process`` a day later:
       every hot key reported ``key->COLD``;
    3. read-back: every object GET over HTTP, body (sha256), ETag and
       storage class exact; the dashboard's ``/api/rgw/placement`` and
       ``/api/rgw/lifecycle`` name the cold pool and the rule;
    4. degraded: OSD ``victim`` killed and marked down, every object read
       again exactly; revived, every primary PG clean;
    5. load: a seeded closed-loop ``LoadGen`` of one client over
       ``S3Backend`` in ``bench.py --serve``'s shape, zero errors, every
       key read back as generated;
    6. scrub: ``osd unset noscrub``, one batched sweep of the cold pool
       verifying every cold object, zero errors;
    7. gc: ``deletes`` cold objects deleted, ``gc_process`` past
       ``rgw_gc_obj_min_wait``: the cold pool loses exactly their RADOS
       objects.

    The kernels of ``need`` must launch in steps 1, 2 and 4.  Raises on
    any failure; returns each step's record."""
    import asyncio
    import hashlib
    import xml.etree.ElementTree as ET

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(seed)
    steps: dict[str, dict] = {}
    loop = asyncio.get_running_loop()
    s3ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}

    async def until(cond, what, timeout=RGW_WAIT_S, every=0.1):
        deadline = loop.time() + timeout
        while True:
            got = cond()
            if asyncio.iscoroutine(got):
                got = await got
            if got:
                return got
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {timeout:.0f} s")
            await asyncio.sleep(every)

    def record(step, t0, k0, nbytes=0, launched=(), **kw):
        ns.sync()
        wall = time.perf_counter() - t0
        k1 = ns.launches()
        delta = {k: k1[k] - k0.get(k, 0) for k in k1
                 if k1[k] != k0.get(k, 0)}
        rec = {"step": step, "wall_s": wall, "bytes": nbytes,
               "gib_s": nbytes / wall / 2**30 if nbytes else 0.0,
               "b1_launches": delta.get(B1, 0),
               "b2_launches": delta.get(B2, 0), **kw,
               "kernel_launches": delta}
        steps[step] = rec
        note(f"[rgw] {json.dumps(rec)}")
        missing = [k for k in launched if not delta.get(k)]
        if missing:
            raise AssertionError(f"{step}: {missing} not launched")
        return rec

    async def command(prefix, **kw):
        r = await rados.mon_command(prefix, timeout=RGW_WAIT_S, **kw)
        if r["rc"] != 0:
            raise AssertionError(f"{prefix}: {r}")
        return r

    async def s3(method, path, body=b"", headers=None, ok=(200,)):
        st, hdrs, out = await _s3(ns.rgw_http, fe.host, fe.port,
                                  user["access_key"], user["secret_key"],
                                  method, path, body, headers)
        if st not in ok:
            raise AssertionError(f"{method} {path}: HTTP {st} {out[:200]}")
        return hdrs, out

    async def cold_objects():
        return len(await cold_io.list_objects())

    t_phase = time.perf_counter()
    ns.reset_local_namespace()
    cluster = ns.DevCluster(n_mons=1, n_osds=n_osds, osds_per_host=1,
                            overrides={**liveness, **RGW_OVERRIDES})
    rados = None
    try:
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.start()
        rados = await cluster.client()
        await command("osd set", flag="noscrub")
        text = ns.compiler.decompile(rados.monc.osdmap.crush)
        tunable = "tunable choose_total_tries 50\n"
        await command("osd setcrushmap", map=text.replace(
            tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
        mgr = await cluster.start_mgr(dashboard=True,
                                      dashboard_token=RGW_TOKEN)
        mgr.modules["balancer"].active = False
        fe, users = await cluster.start_rgw(cold_pool="rgw.cold",
                                            ec_k=ec_k, ec_m=ec_m)
        user = await users.create("wave")
        cold_io = await rados.open_ioctx("rgw.cold")
        cold_id = next(pid for pid, p in rados.monc.osdmap.pools.items()
                       if p.name == "rgw.cold")
        cold_pg_num = rados.monc.osdmap.pools[cold_id].pg_num

        def active():
            return sum(1 for o in cluster.osds.values()
                       for pgid, pg in o.pgs.items()
                       if pgid.pool == cold_id and pg.is_primary
                       and pg.state == "active") == cold_pg_num

        await until(active, "active cold PGs")
        await s3("PUT", "/cold")
        await s3("PUT", "/hot")
        record("boot", t0, k0, mons=len(cluster.mons),
               osds=len(cluster.osds), cold_pg_num=cold_pg_num,
               profile={"k": ec_k, "m": ec_m},
               endpoint=[fe.host, fe.port],
               dashboard=[mgr.dashboard.host, mgr.dashboard.port])
        want: dict[tuple, tuple] = {}      # (bucket, key) -> (sha, etag)

        # 1. put-cold
        t0, k0 = time.perf_counter(), ns.launches()
        cold = {f"obj-{i:03d}": rng.bytes(object_bytes)
                for i in range(objects)}
        replies = await asyncio.gather(*(
            s3("PUT", f"/cold/{k}", d, {"x-amz-storage-class": "COLD"})
            for k, d in cold.items()))
        for (k, d), (hdrs, _) in zip(cold.items(), replies):
            etag = hashlib.md5(d).hexdigest()
            if hdrs.get("etag", "").strip('"') != etag:
                raise AssertionError(f"put-cold {k}: etag {hdrs}")
            want[("cold", k)] = (hashlib.sha256(d).hexdigest(), etag)
        n_cold = await cold_objects()
        if n_cold != objects:
            raise AssertionError(f"put-cold: {n_cold} cold objects")
        record("put-cold", t0, k0, objects * object_bytes, launched=need,
               cold_rados_objects=n_cold)

        # 2. put-hot + transition
        t0, k0 = time.perf_counter(), ns.launches()
        hot = {f"obj-{i:03d}": rng.bytes(object_bytes)
               for i in range(objects)}
        be = ns.loadgen.S3Backend(fe.host, fe.port, user["access_key"],
                                  user["secret_key"], bucket="hot")
        await asyncio.gather(*(be.put(k, d) for k, d in hot.items()))
        for k, d in hot.items():
            want[("hot", k)] = (hashlib.sha256(d).hexdigest(),
                                hashlib.md5(d).hexdigest())
        k_hot = ns.launches()
        hot_launches = {k: k_hot[k] - k0.get(k, 0) for k in k_hot
                        if k_hot[k] != k0.get(k, 0)}
        _, body = await s3("POST", "/hot/multi?uploads")
        upload = ET.fromstring(body).findtext("s3:UploadId", None, s3ns)
        parts = [rng.bytes(part_bytes)
                 for _ in range(multipart_bytes // part_bytes)]
        etags = [hdrs["etag"] for hdrs, _ in await asyncio.gather(*(
            s3("PUT", f"/hot/multi?partNumber={i}&uploadId={upload}", part)
            for i, part in enumerate(parts, 1)))]
        done = "".join(f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag>"
                       f"</Part>" for i, e in enumerate(etags, 1))
        await s3("POST", f"/hot/multi?uploadId={upload}",
                 f"<CompleteMultipartUpload>{done}"
                 f"</CompleteMultipartUpload>".encode())
        mp_etag = hashlib.md5(b"".join(
            hashlib.md5(p).digest() for p in parts)).hexdigest() + \
            f"-{len(parts)}"
        want[("hot", "multi")] = (hashlib.sha256(b"".join(parts))
                                  .hexdigest(), mp_etag)
        t_put = time.perf_counter() - t0
        rule = (f"<LifecycleConfiguration><Rule><ID>to-cold</ID>"
                f"<Filter><Prefix></Prefix></Filter>"
                f"<Status>Enabled</Status><Transition>"
                f"<Days>{RGW_TRANSITION_DAYS}</Days>"
                f"<StorageClass>COLD</StorageClass></Transition>"
                f"</Rule></LifecycleConfiguration>").encode()
        await s3("PUT", "/hot?lifecycle", rule)
        t1, k1 = time.perf_counter(), ns.launches()
        moved = await fe.rgw.lc_process(
            now=time.time() + (RGW_TRANSITION_DAYS + 1) * 86400)
        t_lc = time.perf_counter() - t1
        k2 = ns.launches()
        if sorted(moved.get("hot", [])) != sorted(
                f"{k}->COLD" for k in [*hot, "multi"]) or \
                set(moved) - {"hot", "cold"} or moved.get("cold"):
            raise AssertionError(f"transition: {moved}")
        n_cold = await cold_objects()
        if n_cold != 2 * objects + len(parts):
            raise AssertionError(f"transition: {n_cold} cold objects")
        record("put-hot+transition", t0, k0,
               (objects * object_bytes + multipart_bytes) * 2,
               launched=need, put_s=t_put, lc_s=t_lc,
               lc_gib_s=(objects * object_bytes + multipart_bytes)
               / t_lc / 2**30, moved=len(moved["hot"]),
               hot_put_launches=hot_launches,
               lc_b1_launches=k2.get(B1, 0) - k1.get(B1, 0),
               cold_rados_objects=n_cold)

        # 3. read-back
        async def read_back(step):
            bad = []

            async def one(bucket, key):
                hdrs, body = await s3("GET", f"/{bucket}/{key}")
                sha, etag = want[(bucket, key)]
                if hashlib.sha256(body).hexdigest() != sha or \
                        hdrs.get("etag", "").strip('"') != etag or \
                        hdrs.get("x-amz-storage-class") != "COLD":
                    bad.append((bucket, key, hdrs))
                return len(body)

            got = await asyncio.gather(*(one(b, k) for b, k in want))
            if bad:
                raise AssertionError(f"{step}: {len(bad)} objects differ, "
                                     f"first {bad[0]}")
            return sum(got)

        t0, k0 = time.perf_counter(), ns.launches()
        nbytes = await read_back("read-back")
        dash = (mgr.dashboard.host, mgr.dashboard.port)
        bearer = {"authorization": f"Bearer {RGW_TOKEN}"}
        pst, _, pbody = await _http(*dash, "GET", "/api/rgw/placement",
                                    bearer)
        lst, _, lbody = await _http(*dash, "GET",
                                    "/api/rgw/lifecycle?bucket=hot", bearer)
        placement = json.loads(pbody) if pst == 200 else []
        lifecycle = json.loads(lbody) if lst == 200 else {}
        cold_class = (placement[0]["storage_classes"].get("COLD", {})
                      if placement else {})
        rules = lifecycle.get("hot", [])
        record("read-back", t0, k0, nbytes, objects_read=len(want),
               dashboard={"placement": pst, "lifecycle": lst,
                          "cold_pool": cold_class.get("pool"),
                          "rules": [r.get("id") for r in rules]})
        if cold_class.get("pool") != "rgw.cold" or [
                (r.get("id"), r.get("transition_class")) for r in rules] \
                != [("to-cold", "COLD")]:
            raise AssertionError(f"dashboard: {placement} {lifecycle}")

        # 4. degraded
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.kill_osd(victim)
        await command("osd down", ids=[victim])
        await until(lambda: not rados.monc.osdmap.is_up(victim),
                    f"an epoch with osd.{victim} down")
        t1 = time.perf_counter()
        nbytes = await read_back("degraded")
        t_read = time.perf_counter() - t1
        k_read = ns.launches()
        read_launches = {k: k_read[k] - k0.get(k, 0) for k in k_read
                         if k_read[k] != k0.get(k, 0)}
        await cluster.revive_osd(victim)
        await until(lambda: victim in cluster.osds and
                    rados.monc.osdmap.is_up(victim),
                    f"osd.{victim} back up")
        await until(lambda: pgs_clean(cluster.osds.values()),
                    "clean PGs after the revive")
        record("degraded", t0, k0, nbytes, read_s=t_read,
               read_gib_s=nbytes / t_read / 2**30,
               read_launches=read_launches, victim=victim)
        if not read_launches.get(B1) and B1 in need:
            raise AssertionError("degraded: the reads launched no B1")

        # 5. load (one client: an EC read racing an overwrite of its own
        # object can fail in both packages, ROADMAP Queue C)
        t0, k0 = time.perf_counter(), ns.launches()
        lg = ns.loadgen
        sbe = lg.S3Backend(fe.host, fe.port, user["access_key"],
                           user["secret_key"], bucket="serve")
        gen = lg.LoadGen(sbe, seed=seed, mode="closed", clients=1,
                         total_ops=loadgen_ops, n_keys=48,
                         tenant_class="gold", read_fraction=0.7,
                         zipf_s=1.1)
        await gen.populate()
        res = await gen.run()
        if res["errors"] or res["ops"] != loadgen_ops:
            raise AssertionError(f"load: load generator {res}")
        for key, size in gen.key_sizes().items():
            if await sbe.get(key) != lg._payload(key, size):
                raise AssertionError(f"load: key {key} differs")
        record("load", t0, k0, res["bytes_put"] + res["bytes_get"],
               loadgen={k: res[k] for k in (
                   "ops", "errors", "puts", "gets", "bytes_put",
                   "bytes_get", "wall_s", "ops_per_s", "p50_ms", "p99_ms",
                   "p999_ms")})

        # 6. scrub
        t0, k0 = time.perf_counter(), ns.launches()
        n_cold = await cold_objects()
        await command("osd unset", flag="noscrub")
        scrub = {}

        async def swept():
            scrub.clear()
            for osd_id in cluster.osds:
                stats = await rados.osd_daemon_command(
                    osd_id, "ec_scrub_stats", timeout=RGW_WAIT_S)
                for key in ("sweeps", "objects", "errors"):
                    scrub[key] = scrub.get(key, 0) + \
                        stats["engine"].get(key, 0)
            return scrub["objects"] >= n_cold

        await until(swept, "background scrub sweep", every=0.25)
        await command("osd set", flag="noscrub")
        record("scrub", t0, k0, scrub=dict(scrub),
               cold_rados_objects=n_cold)
        if scrub["errors"]:
            raise AssertionError(f"the scrub found {scrub['errors']} errors")

        # 7. gc
        t0, k0 = time.perf_counter(), ns.launches()
        before = await cold_objects()
        doomed = list(cold)[:deletes]
        for key in doomed:
            await s3("DELETE", f"/cold/{key}", ok=(204,))
        queued = len(await fe.rgw.gc_list())
        still = await cold_objects()
        reaped = await fe.rgw.gc_process(
            now=time.time() + RGW_OVERRIDES["rgw_gc_obj_min_wait"] + 1)
        after = await cold_objects()
        record("gc", t0, k0, deleted=len(doomed), gc_queued=queued,
               gc_reaped=reaped, cold_before=before,
               cold_before_gc=still, cold_after=after)
        if still != before or before - after != len(doomed):
            raise AssertionError(f"gc: cold pool {before} -> {still} -> "
                                 f"{after} for {len(doomed)} deletes")
        for key in doomed:
            await s3("GET", f"/cold/{key}", ok=(404,))
    finally:
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def rgw_phase(dev) -> dict:
    """Wave (i) on the port's dev cluster, its OSD daemons on the CUDA
    device ``dev``."""
    import asyncio
    import functools
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.placement import compiler
    from ceph_tpu_torch.services import rgw_http
    from ceph_tpu_torch.testing import loadgen

    ns = SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        loadgen=loadgen, rgw_http=rgw_http,
        launches=lambda: dict(ck.LAUNCHES), sync=torch.cuda.synchronize)
    return asyncio.run(rgw_wave(ns))


# Wave (j): multisite.  Two zones of one realm, each a port mon, twelve
# port OSD daemons on the card and the port's gateway; each zone's
# default placement gets a COLD class on an 8+4 data pool (set through the
# port's rgw_admin).  A STANDARD class pointed at that pool would change
# nothing: a PUT in STANDARD rides the zone's own pool whatever the class
# names (services/rgw.py, put_object's context), and the sync agent
# writes each copy without its storage class (services/rgw_sync.py,
# _replicate_put).  So zone a's PUTs name COLD, and zone b tiers every
# replicated body into its own 8+4 pool by a lifecycle rule as soon as it
# has caught up: every body the wave reads on b lives in EC.
MULTISITE_BUDGET_S = 150.0
MULTISITE_OBJECTS = 32
MULTISITE_SWIFT_OBJECTS = 8
MULTISITE_FILES = 4
MULTISITE_OVERRIDES = {
    "mon_osd_down_out_interval": 300.0,
    "osd_ec_resident": True,
}
MULTISITE_SYNC_KEYS = {"rgw-source-mtime", "rgw-source-zone"}
MULTISITE_CLASS = "COLD"


async def _tool_text(tool, argv) -> str:
    """One admin tool run through its own argv parser inside this loop
    (``main`` in a thread for a tool without ``build_parser``): its
    standard output; raises on a non-zero return code."""
    import asyncio
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if hasattr(tool, "build_parser"):
            rc = await tool._run(tool.build_parser().parse_args(argv))
        else:
            rc = await asyncio.to_thread(tool.main, argv)
    if rc != 0:
        raise AssertionError(f"{tool.__name__} {argv}: rc {rc} "
                             f"{buf.getvalue()[:300]}")
    return buf.getvalue()


async def _tool_out(tool, argv):
    """The JSON a tool printed (``{}`` for none)."""
    text = (await _tool_text(tool, argv)).strip()
    return json.loads(text) if text else {}


async def multisite_wave(ns, store_dir: str, *, n_osds: int = CLUSTER_OSDS,
                         ec_k: int = 8, ec_m: int = 4,
                         objects: int = MULTISITE_OBJECTS,
                         object_bytes: int = RGW_OBJECT_BYTES,
                         swift_objects: int = MULTISITE_SWIFT_OBJECTS,
                         files: int = MULTISITE_FILES,
                         victim: int = CLUSTER_VICTIM, need: tuple = (B1,),
                         seed: int = SEED, note=log) -> dict:
    """Wave (j) over one package's ``ns``: ``MultisiteRealm`` (a partial
    with the device), ``rgw_admin``, ``swift``, ``rgw_file``, ``rgw_http``,
    ``compiler``, ``zone_loss_dr_drill`` (a partial with the device),
    ``reset_local_namespace``, ``SCALE_TEST_OVERRIDES``, ``launches`` and
    ``sync``; ``store_dir`` holds each zone's conf file for the admin
    tool.

    A realm of zones a (master) and b, each 1 mon and ``n_osds`` OSD
    daemons (one per CRUSH host, MemStores, the resident shard cache) with
    CRUSH's choose tries at 100 and its gateway; ``rgw_admin zone
    placement add --storage-class COLD --data-pool <zone>.rgw.data
    --ec-profile --ec-k --ec-m --create-pool`` on each zone (8 PGs,
    failure domain osd).  Steps, a "[multisite]" JSON line each (wall
    seconds, bytes, GiB/s, B1/B2 launches):

    1. put-a: ``objects`` concurrent SigV4 PUTs of ``object_bytes`` with
       user metadata and ``x-amz-storage-class: COLD`` into zone a;
    2. sync: until ``realm.lag()["b"]`` is 0 entries and 0 bytes; b's
       lifecycle rule tiers every replicated body into b's COLD pool
       (``lc_process``); every object GET from zone b over HTTP exact
       (sha256, length, user metadata and the sync's two source keys,
       storage class); ``rgw_admin sync status`` from b;
    3. swift + file: zone a's ``SwiftFrontend``: the TempAuth handshake,
       ``swift_objects`` segments PUT into a container, an SLO manifest
       over them, its GET exact; ``RGWFileSystem`` on zone a: mkdir,
       ``files`` files written, readdir, one renamed, each read back; zone
       b caught up, tiered, and all of it (the manifest's body too) read
       back exact there;
    4. degraded: OSD ``victim`` of zone b killed and marked down, every
       object of steps 1 and 3 read from b exact (decodes); revived, PGs
       clean;
    5. dr: the realm stopped; ``run_zone_loss_dr_drill`` at its defaults
       (its own realm of 3 OSDs a zone, replicated pools): the measured
       RPO equal to the ledger, the conflict won by b, convergence.

    The kernels of ``need`` must launch in steps 1, 2 and 4.  Raises on
    any failure; returns each step's record."""
    import asyncio
    import hashlib
    import os

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(seed)
    steps: dict[str, dict] = {}
    loop = asyncio.get_running_loop()

    async def until(cond, what, timeout=RGW_WAIT_S, every=0.1):
        deadline = loop.time() + timeout
        while True:
            got = cond()
            if asyncio.iscoroutine(got):
                got = await got
            if got:
                return got
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {timeout:.0f} s")
            await asyncio.sleep(every)

    def record(step, t0, k0, nbytes=0, launched=(), **kw):
        ns.sync()
        wall = time.perf_counter() - t0
        k1 = ns.launches()
        delta = {k: k1[k] - k0.get(k, 0) for k in k1
                 if k1[k] != k0.get(k, 0)}
        rec = {"step": step, "wall_s": wall, "bytes": nbytes,
               "gib_s": nbytes / wall / 2**30 if nbytes else 0.0,
               "b1_launches": delta.get(B1, 0),
               "b2_launches": delta.get(B2, 0), **kw,
               "kernel_launches": delta}
        steps[step] = rec
        note(f"[multisite] {json.dumps(rec)}")
        missing = [k for k in launched if not delta.get(k)]
        if missing:
            raise AssertionError(f"{step}: {missing} not launched")
        return rec

    async def command(rados, prefix, **kw):
        r = await rados.mon_command(prefix, timeout=RGW_WAIT_S, **kw)
        if r["rc"] != 0:
            raise AssertionError(f"{prefix}: {r}")
        return r

    async def s3(zone, method, path, body=b"", headers=None, ok=(200,)):
        fe, user = zone["fe"], zone["user"]
        st, hdrs, out = await _s3(ns.rgw_http, fe.host, fe.port,
                                  user["access_key"], user["secret_key"],
                                  method, path, body, headers)
        if st not in ok:
            raise AssertionError(f"{method} {path}: HTTP {st} {out[:200]}")
        return hdrs, out

    def user_meta(hdrs):
        return {k[len("x-amz-meta-"):]: v for k, v in hdrs.items()
                if k.startswith("x-amz-meta-")}

    async def lag_b():
        orch = realm.zones["b"]["orch"]
        if orch is None or not orch.agents:
            return None
        return (await realm.lag())["b"]

    async def caught_up():
        return await lag_b() == {"entries": 0, "bytes": 0}

    async def tier_b(buckets, keys):
        """b's lifecycle: a transition rule on each of ``buckets`` (b's
        copies), one ``lc_process`` a day on; exactly ``keys`` (the
        buckets' bodies and directory markers; an SLO manifest stays)
        moved into COLD."""
        gw = realm.zones["b"]["gw"]
        for bucket in buckets:
            await gw.put_lifecycle(bucket, [
                {"id": "tier", "prefix": "", "status": "Enabled",
                 "transition_seconds": 1,
                 "transition_class": MULTISITE_CLASS}])
        t1 = time.perf_counter()
        moved = await gw.lc_process(now=time.time() + 86400)
        got = sorted(f"{bkt}/{m}" for bkt in buckets
                     for m in moved.get(bkt, []))
        if got != sorted(f"{bkt}/{k}->{MULTISITE_CLASS}"
                         for bkt, k in keys):
            raise AssertionError(f"b's transition: {moved}")
        return len(got), time.perf_counter() - t1

    async def read_b(step):
        """Every S3 object and every Swift and file body from zone b over
        HTTP (gateway GETs for the files): exact."""
        b = realm.zones["b"]
        bad, nbytes = [], 0

        async def one(key):
            hdrs, body = await s3(b, "GET", f"/geo/{key}")
            sha, size, meta = want[key]
            got_meta = user_meta(hdrs)
            if hashlib.sha256(body).hexdigest() != sha or \
                    len(body) != size or \
                    hdrs.get("x-amz-storage-class") != MULTISITE_CLASS or \
                    {k: v for k, v in got_meta.items()
                     if k not in MULTISITE_SYNC_KEYS} != meta or \
                    set(got_meta) - set(meta) != MULTISITE_SYNC_KEYS:
                bad.append((key, len(body), got_meta))
            return len(body)

        nbytes += sum(await asyncio.gather(*(one(k) for k in want)))
        for (bucket, key), data in extra.items():
            got = (await b["gw"].get_object(bucket, key))["data"]
            head = await b["gw"].head_object(bucket, key)
            if got != data or head.get("storage_class") != MULTISITE_CLASS:
                bad.append((bucket, key, len(got), head.get("pool")))
            nbytes += len(got)
        if bad:
            raise AssertionError(f"{step}: {len(bad)} objects differ on b, "
                                 f"first {bad[0]}")
        return nbytes

    t_phase = time.perf_counter()
    ns.reset_local_namespace()
    realm = ns.MultisiteRealm(("a", "b"), n_osds=n_osds,
                              overrides={**liveness, **MULTISITE_OVERRIDES})
    swift_fe = None
    try:
        # boot: the realm, choose tries at 100, the EC data pool per zone
        t0, k0 = time.perf_counter(), ns.launches()
        await realm.start()
        b = realm.zones["b"]
        placements = {}
        for name, z in realm.zones.items():
            rados = z["rados"]
            text = ns.compiler.decompile(rados.monc.osdmap.crush)
            tunable = "tunable choose_total_tries 50\n"
            await command(rados, "osd setcrushmap", map=text.replace(
                tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
            conf = os.path.join(store_dir, f"{name}.json")
            z["cluster"].write_conf(conf)
            pool = f"{name}.rgw.data"
            have = await _tool_out(ns.rgw_admin, [
                "--conf", conf, "--pool", "rgw", "zone", "placement", "ls"])
            verb = "modify" if any(
                MULTISITE_CLASS in p.get("storage_classes", {})
                for p in (have.values() if isinstance(have, dict)
                          else have)) else "add"
            rec = await _tool_out(ns.rgw_admin, [
                "--conf", conf, "--pool", "rgw", "zone", "placement", verb,
                "--storage-class", MULTISITE_CLASS, "--data-pool", pool,
                "--ec-profile", f"{name}-ec-{ec_k}-{ec_m}",
                "--ec-k", str(ec_k), "--ec-m", str(ec_m), "--create-pool"])
            got = await z["gw"]._class_placement(MULTISITE_CLASS)
            if got.get("pool") != pool:
                raise AssertionError(f"zone {name}: {MULTISITE_CLASS} "
                                     f"resolves to {got}, not {pool}")
            pool_id = next(pid for pid, p in
                           rados.monc.osdmap.pools.items() if p.name == pool)
            info = rados.monc.osdmap.pools[pool_id]
            z["data_io"] = await rados.open_ioctx(pool)
            z["data_pool"] = (pool_id, info.pg_num)
            placements[name] = {"verb": verb, "pool": pool,
                                "pg_num": info.pg_num,
                                "type": info.pool_type,
                                "classes": sorted(rec.get(
                                    "storage_classes", {}))}
            z["user"] = await z["users"].create("wave")

        def active(z):
            pool_id, pg_num = z["data_pool"]
            return sum(1 for o in z["cluster"].osds.values()
                       for pgid, pg in o.pgs.items()
                       if pgid.pool == pool_id and pg.is_primary
                       and pg.state == "active") == pg_num

        for name, z in realm.zones.items():
            await until(lambda: active(z), f"active data PGs in {name}")
        await s3(realm.zones["a"], "PUT", "/geo")
        record("boot", t0, k0, zones=sorted(realm.zones),
               osds={n: len(z["cluster"].osds)
                     for n, z in realm.zones.items()},
               placements=placements, profile={"k": ec_k, "m": ec_m})

        # 1. put-a
        want: dict[str, tuple] = {}         # key -> (sha, size, meta)
        extra: dict[tuple, bytes] = {}      # (bucket, key) -> body
        a = realm.zones["a"]
        t0, k0 = time.perf_counter(), ns.launches()
        datas = {f"obj-{i:03d}": rng.bytes(object_bytes)
                 for i in range(objects)}
        await asyncio.gather(*(
            s3(a, "PUT", f"/geo/{k}", d,
               {"x-amz-meta-seq": str(i), "x-amz-meta-wave": "j",
                "x-amz-storage-class": MULTISITE_CLASS})
            for i, (k, d) in enumerate(datas.items())))
        for i, (k, d) in enumerate(datas.items()):
            want[k] = (hashlib.sha256(d).hexdigest(), len(d),
                       {"seq": str(i), "wave": "j"})
        n_data = len(await a["data_io"].list_objects())
        record("put-a", t0, k0, objects * object_bytes, launched=need,
               data_rados_objects=n_data)

        # 2. sync
        t0, k0 = time.perf_counter(), ns.launches()
        await until(caught_up, "zone b caught up", timeout=RGW_WAIT_S,
                    every=0.05)
        t_sync = time.perf_counter() - t0
        k_sync = ns.launches()
        sync_launches = {k: k_sync[k] - k0.get(k, 0) for k in k_sync
                         if k_sync[k] != k0.get(k, 0)}
        # the replicated bucket belongs to b's gateway; b's admin grants
        # b's user of the same name READ, as metadata sync would
        await b["gw"].put_bucket_acl("geo", grants=[
            {"grantee": "wave", "perm": "READ"}])
        tiered, t_tier = await tier_b(["geo"], [("geo", k) for k in want])
        nbytes = await read_b("sync")
        status = await _tool_out(ns.rgw_admin, [
            "--conf", os.path.join(store_dir, "b.json"), "--pool", "rgw",
            "sync", "status"])
        agents = list(b["orch"].agents.values())
        record("sync", t0, k0, objects * object_bytes, launched=need,
               replicate_s=t_sync,
               replicate_gib_s=objects * object_bytes / t_sync / 2**30,
               replicate_launches=sync_launches, tiered=tiered,
               tier_s=t_tier, read_bytes=nbytes,
               sync_put_ops=sum(int(ag.perf.value("sync_put_ops"))
                                for ag in agents),
               data_rados_objects_b=len(await b["data_io"].list_objects()),
               sync_status=status)
        if status.get("sync_markers", {}).get("geo") is None:
            raise AssertionError(f"sync status: {status}")

        # 3. swift + file
        t0, k0 = time.perf_counter(), ns.launches()
        swift_fe = ns.swift.SwiftFrontend(a["gw"], users=a["users"])
        host, port = await swift_fe.start()
        st, rh, _ = await _http(host, port, "GET", "/auth/v1.0", {
            "x-auth-user": "wave:swift",
            "x-auth-key": a["user"]["secret_key"]})
        if st != 200:
            raise AssertionError(f"swift auth: HTTP {st}")
        auth = {"x-auth-token": rh["x-auth-token"]}
        acct = rh["x-storage-url"].split("/v1/", 1)[1]
        for container in ("segs", "docs"):
            st, _, _ = await _http(host, port, "PUT",
                                   f"/v1/{acct}/{container}", auth)
            if st not in (201, 202):
                raise AssertionError(f"swift container: HTTP {st}")
        segs = [rng.bytes(object_bytes) for _ in range(swift_objects)]

        async def put_seg(i, seg):
            st, _, body = await _http(host, port, "PUT",
                                      f"/v1/{acct}/segs/part{i:02d}",
                                      auth, seg)
            if st != 201:
                raise AssertionError(f"swift PUT: HTTP {st} {body[:200]}")

        await asyncio.gather(*(put_seg(i, s) for i, s in enumerate(segs)))
        manifest = json.dumps([
            {"path": f"/segs/part{i:02d}", "size_bytes": len(s)}
            for i, s in enumerate(segs)]).encode()
        st, _, body = await _http(
            host, port, "PUT", f"/v1/{acct}/docs/big?multipart-manifest=put",
            auth, manifest)
        if st != 201:
            raise AssertionError(f"SLO manifest: HTTP {st} {body[:200]}")
        whole = b"".join(segs)
        st, _, body = await _http(host, port, "GET",
                                  f"/v1/{acct}/docs/big", auth)
        if st != 200 or body != whole:
            raise AssertionError(f"SLO GET: HTTP {st}, {len(body)} bytes")
        for i, s in enumerate(segs):
            extra[("segs", f"part{i:02d}")] = s
        # b's copy of the manifest is the assembled body, a plain object
        # (the agent replays what a GET of it returns)
        extra[("docs", "big")] = whole
        fs = ns.rgw_file.RGWFileSystem(a["gw"])
        await fs.mkdir("/files")
        await fs.mkdir("/files/dir")
        bodies = {f"/files/dir/f{i}": rng.bytes(object_bytes)
                  for i in range(files)}
        for path, data in bodies.items():
            await fs.write(path, data)
        listed = sorted(await fs.readdir("/files/dir"))
        if listed != sorted(p.rsplit("/", 1)[1] for p in bodies):
            raise AssertionError(f"readdir: {listed}")
        await fs.rename("/files/dir/f0", "/files/dir/renamed")
        bodies["/files/dir/renamed"] = bodies.pop("/files/dir/f0")
        for path, data in bodies.items():
            if await fs.read(path, 0, len(data)) != data:
                raise AssertionError(f"file read {path}")
            extra[("files", path[len("/files/"):])] = data
        t_a = time.perf_counter() - t0
        await until(caught_up, "zone b caught up", timeout=RGW_WAIT_S,
                    every=0.05)
        tiered, t_tier = await tier_b(["segs", "docs", "files"],
                                      [*extra, ("files", "dir/")])
        fs_b = ns.rgw_file.RGWFileSystem(b["gw"])
        if sorted(await fs_b.readdir("/files/dir")) != sorted(
                p.rsplit("/", 1)[1] for p in bodies):
            raise AssertionError("readdir on b")
        nbytes = await read_b("swift+file")
        fs_bytes = (swift_objects + files) * object_bytes
        record("swift+file", t0, k0, fs_bytes, write_s=t_a,
               slo_bytes=len(whole), files=len(bodies), tiered=tiered,
               tier_s=t_tier, read_bytes=nbytes)

        # 4. degraded
        t0, k0 = time.perf_counter(), ns.launches()
        await b["cluster"].kill_osd(victim)
        await command(b["rados"], "osd down", ids=[victim])
        await until(lambda: not b["rados"].monc.osdmap.is_up(victim),
                    f"an epoch with osd.{victim} down in b")
        t1 = time.perf_counter()
        nbytes = await read_b("degraded")
        t_read = time.perf_counter() - t1
        k_read = ns.launches()
        read_launches = {k: k_read[k] - k0.get(k, 0) for k in k_read
                         if k_read[k] != k0.get(k, 0)}
        await b["cluster"].revive_osd(victim)
        await until(lambda: victim in b["cluster"].osds and
                    b["rados"].monc.osdmap.is_up(victim),
                    f"osd.{victim} back up in b")
        await until(lambda: pgs_clean(b["cluster"].osds.values()),
                    "clean PGs in b after the revive")
        record("degraded", t0, k0, nbytes, read_s=t_read,
               read_gib_s=nbytes / t_read / 2**30,
               read_launches=read_launches, victim=victim)
        if not read_launches.get(B1) and B1 in need:
            raise AssertionError("degraded: the reads launched no B1")
    finally:
        if swift_fe is not None:
            await swift_fe.stop()
        await realm.stop()
        ns.reset_local_namespace()

    # 5. dr: the zone-loss drill with the offline mon-store rebuild
    t0, k0 = time.perf_counter(), ns.launches()
    try:
        dr = await ns.zone_loss_dr_drill()
    finally:
        ns.reset_local_namespace()
    slo = dr["slo"]
    record("dr", t0, k0, rto_s=slo["rto_s"], rto_slo_s=slo["rto_slo_s"],
           ledger=dr["ledger"],
           rpo={k: dr["rpo"][k] for k in ("entries", "bytes")},
           lost_keys=len(dr["rpo"]["keys"]),
           conflict_winner=slo["conflict_winner"],
           resync_purged=slo["resync_purged"], converged=slo["converged"],
           dr_rebuild=dr["dr_rebuild"])
    if not (slo["pass"] and slo["converged"] and dr["dr_rebuild"]
            and dr["rpo"]["entries"] == dr["ledger"]["entries"]
            and dr["rpo"]["bytes"] == dr["ledger"]["bytes"]):
        raise AssertionError(f"dr: {dr}")
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def multisite_phase(dev) -> dict:
    """Wave (j) on the port's realm, every zone's OSD daemons on the CUDA
    device ``dev``."""
    import asyncio
    import functools
    import tempfile
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import rgw_admin, vstart
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.placement import compiler
    from ceph_tpu_torch.services import rgw_file, rgw_http, swift
    from ceph_tpu_torch.testing import chaos

    ns = SimpleNamespace(
        MultisiteRealm=functools.partial(vstart.MultisiteRealm, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        rgw_admin=rgw_admin, rgw_http=rgw_http, swift=swift,
        rgw_file=rgw_file,
        zone_loss_dr_drill=functools.partial(chaos.run_zone_loss_dr_drill,
                                             device=dev),
        launches=lambda: dict(ck.LAUNCHES), sync=torch.cuda.synchronize)
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(multisite_wave(ns, d))


# Wave (k): the admin CLIs and block images.  One port mon and twelve port
# OSD daemons on the card over durable stores (so the offline tool can
# read a stopped OSD); the port's ``ceph``/``rados`` CLI makes the 8+4
# pool and moves files through it, and the port's rbd tool drives block
# images on a replicated pool: RBD keeps its headers in omap and calls
# object classes, which an EC pool refuses, so block I/O launches no
# kernel in this design.
BLOCK_BUDGET_S = 120.0
BLOCK_FILES = 16
BLOCK_IMAGE_BYTES = 64 << 20
BLOCK_CLONE_WRITE = 16 << 20
BLOCK_BENCH_BYTES = 64 << 20
BLOCK_BENCH_IO = 4 << 20
BLOCK_MIRROR_BYTES = 16 << 20
BLOCK_PG_NUM = 8
BLOCK_PROFILE = "wave-k"


async def block_wave(ns, store_dir: str, *, n_osds: int = CLUSTER_OSDS,
                     ec_k: int = 8, ec_m: int = 4,
                     files: int = BLOCK_FILES,
                     file_bytes: int = RGW_OBJECT_BYTES,
                     image_bytes: int = BLOCK_IMAGE_BYTES,
                     clone_write: int = BLOCK_CLONE_WRITE,
                     bench_bytes: int = BLOCK_BENCH_BYTES,
                     bench_io: int = BLOCK_BENCH_IO,
                     mirror_bytes: int = BLOCK_MIRROR_BYTES,
                     order: int = 22, victim: int = CLUSTER_VICTIM,
                     need: tuple = (B1,), seed: int = SEED,
                     note=log) -> dict:
    """Wave (k) over one package's ``ns``: ``DevCluster`` (a partial with
    the device), ``cli``, ``rbd_tool``, ``objectstore_tool``,
    ``osdmaptool``, ``dencoder``, ``codec``, ``rbd``, ``rbd_group``,
    ``rbd_mirror``, ``object_to_ps``, ``compiler``,
    ``reset_local_namespace``, ``SCALE_TEST_OVERRIDES``, ``launches`` and
    ``sync``; ``store_dir`` holds the daemons' durable stores, the conf
    file and the files the CLIs read and write.

    1 mon and ``n_osds`` OSD daemons (one per CRUSH host) on durable
    stores, CRUSH's choose tries at 100, ``write_conf``.  Steps, a
    "[block]" JSON line each (wall seconds, bytes, GiB/s, B1/B2
    launches):

    1. ec-cli: ``osd erasure-code-profile set`` (jax_rs, k, m, failure
       domain osd) and ``osd pool create --pool-type erasure`` through the
       CLI's argv parser; ``rados put`` of ``files`` seeded files of
       ``file_bytes``, ``rados get`` of each, every one exact;
    2. degraded-cli: OSD ``victim`` killed, ``osd down`` by the CLI, every
       file got again exact (decodes); revived, PGs clean; the CLI's
       ``status`` and ``osd df``;
    3. block: a replicated pool ``rbd`` and its mirror ``rbd-dr``; the rbd
       tool imports an image of ``image_bytes``, snapshots, protects and
       clones it; ``clone_write`` bytes written into the clone through
       ``RBD``/``Image``; both images exported and held to the expected
       bytes; ``rbd bench`` of ``bench_bytes`` in ``bench_io`` writes; a
       group snapshot of both images (``RBDGroups``); a journaled image
       of ``mirror_bytes`` mirrored into ``rbd-dr`` by ``RBDMirror`` and
       read back exact;
    4. offline: OSD ``victim`` stopped; the objectstore tool's ``--op
       list`` on its store lists exactly the EC shards the map places on
       it; ``osdmaptool --test-map-pgs`` on the mon's current map agrees
       with the map's own placement of every PG, and the dencoder's
       OSDMap round trip gives the same bytes back; the OSD restarted,
       PGs clean.

    The kernels of ``need`` must launch in steps 1 and 2.  Raises on any
    failure; returns each step's record."""
    import asyncio
    import os

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(seed)
    steps: dict[str, dict] = {}
    loop = asyncio.get_running_loop()

    async def until(cond, what, timeout=RGW_WAIT_S, every=0.1):
        deadline = loop.time() + timeout
        while True:
            got = cond()
            if asyncio.iscoroutine(got):
                got = await got
            if got:
                return got
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {timeout:.0f} s")
            await asyncio.sleep(every)

    def record(step, t0, k0, nbytes=0, launched=(), **kw):
        ns.sync()
        wall = time.perf_counter() - t0
        k1 = ns.launches()
        delta = {k: k1[k] - k0.get(k, 0) for k in k1
                 if k1[k] != k0.get(k, 0)}
        rec = {"step": step, "wall_s": wall, "bytes": nbytes,
               "gib_s": nbytes / wall / 2**30 if nbytes else 0.0,
               "b1_launches": delta.get(B1, 0),
               "b2_launches": delta.get(B2, 0), **kw,
               "kernel_launches": delta}
        steps[step] = rec
        note(f"[block] {json.dumps(rec)}")
        missing = [k for k in launched if not delta.get(k)]
        if missing:
            raise AssertionError(f"{step}: {missing} not launched")
        return rec

    def path(name):
        return os.path.join(store_dir, name)

    conf = path("cluster.json")

    async def ceph(*argv):
        return await _tool_text(ns.cli, ["--conf", conf, *argv])

    async def rbd_tool(*argv, pool="rbd"):
        return await _tool_out(ns.rbd_tool,
                               ["--conf", conf, "--pool", pool, *argv])

    def pool_id(name):
        return next(pid for pid, p in rados.monc.osdmap.pools.items()
                    if p.name == name)

    def active(name):
        pid = pool_id(name)
        pg_num = rados.monc.osdmap.pools[pid].pg_num
        return sum(1 for o in cluster.osds.values()
                   for pgid, pg in o.pgs.items()
                   if pgid.pool == pid and pg.is_primary
                   and pg.state == "active") == pg_num

    async def get_all(step):
        bad, nbytes = [], 0
        for name, data in datas.items():
            out = path(f"{name}.out")
            await ceph("rados", "-p", "ecpool", "get", name, out)
            with open(out, "rb") as f:
                got = f.read()
            os.unlink(out)
            if got != data:
                bad.append((name, len(got)))
            nbytes += len(got)
        if bad:
            raise AssertionError(f"{step}: {len(bad)} files differ, first "
                                 f"{bad[0]}")
        return nbytes

    t_phase = time.perf_counter()
    ns.reset_local_namespace()
    cluster = ns.DevCluster(n_mons=1, n_osds=n_osds, osds_per_host=1,
                            store_dir=path("cluster"),
                            overrides={**liveness, **MULTISITE_OVERRIDES})
    rados = None
    try:
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.start()
        rados = await cluster.client()
        r = await rados.mon_command("osd set", flag="noscrub",
                                    timeout=RGW_WAIT_S)
        text = ns.compiler.decompile(rados.monc.osdmap.crush)
        tunable = "tunable choose_total_tries 50\n"
        r = await rados.mon_command("osd setcrushmap", map=text.replace(
            tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"),
            timeout=RGW_WAIT_S)
        if r["rc"] != 0:
            raise AssertionError(f"setcrushmap: {r}")
        cluster.write_conf(conf)
        record("boot", t0, k0, mons=len(cluster.mons),
               osds=len(cluster.osds), stores=sorted(os.listdir(
                   path("cluster"))))

        # 1. ec-cli
        t0, k0 = time.perf_counter(), ns.launches()
        await ceph("osd", "erasure-code-profile", "set", BLOCK_PROFILE,
                   "plugin=jax_rs", f"k={ec_k}", f"m={ec_m}",
                   "crush-failure-domain=osd")
        await ceph("osd", "pool", "create", "ecpool", "--pg-num",
                   str(BLOCK_PG_NUM), "--pool-type", "erasure", "--profile",
                   BLOCK_PROFILE)
        profile = await _tool_out(ns.cli, [
            "--conf", conf, "--format", "json", "osd",
            "erasure-code-profile", "get", BLOCK_PROFILE])
        await until(lambda: "ecpool" in [
            p.name for p in rados.monc.osdmap.pools.values()],
            "the ecpool in the client's map")
        await until(lambda: active("ecpool"), "active EC PGs")
        datas = {f"file-{i:02d}": rng.bytes(file_bytes)
                 for i in range(files)}
        t1 = time.perf_counter()
        for name, data in datas.items():
            with open(path(name), "wb") as f:
                f.write(data)
            await ceph("rados", "-p", "ecpool", "put", name, path(name))
            os.unlink(path(name))
        t_put = time.perf_counter() - t1
        k_put = ns.launches()
        put_launches = {k: k_put[k] - k0.get(k, 0) for k in k_put
                        if k_put[k] != k0.get(k, 0)}
        t1 = time.perf_counter()
        nbytes = await get_all("ec-cli")
        t_get = time.perf_counter() - t1
        listed = (await ceph("rados", "-p", "ecpool", "ls")).split()
        if sorted(listed) != sorted(datas):
            raise AssertionError(f"rados ls: {listed}")
        record("ec-cli", t0, k0, files * file_bytes, launched=need,
               put_s=t_put, put_gib_s=files * file_bytes / t_put / 2**30,
               get_s=t_get, get_gib_s=nbytes / t_get / 2**30,
               put_launches=put_launches,
               profile={k: profile.get(k) for k in ("plugin", "k", "m")})

        # 2. degraded-cli
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.kill_osd(victim)
        await ceph("osd", "down", str(victim))
        await until(lambda: not rados.monc.osdmap.is_up(victim),
                    f"an epoch with osd.{victim} down")
        t1 = time.perf_counter()
        nbytes = await get_all("degraded-cli")
        t_read = time.perf_counter() - t1
        k_read = ns.launches()
        read_launches = {k: k_read[k] - k0.get(k, 0) for k in k_read
                         if k_read[k] != k0.get(k, 0)}
        await cluster.revive_osd(victim)
        await until(lambda: victim in cluster.osds and
                    rados.monc.osdmap.is_up(victim),
                    f"osd.{victim} back up")
        await until(lambda: pgs_clean(cluster.osds.values()),
                    "clean PGs after the revive")
        status = (await ceph("status")).splitlines()
        df = await _tool_out(ns.cli, ["--conf", conf, "--format", "json",
                                      "osd", "df"])
        record("degraded-cli", t0, k0, nbytes, read_s=t_read,
               read_gib_s=nbytes / t_read / 2**30,
               read_launches=read_launches, victim=victim, status=status,
               df={k: df.get(k) for k in ("total_bytes_used",)}
               | {"nodes": len(df.get("nodes", []))})
        if not read_launches.get(B1) and B1 in need:
            raise AssertionError("degraded-cli: the reads launched no B1")

        # 3. block
        t0, k0 = time.perf_counter(), ns.launches()
        for pool in ("rbd", "rbd-dr"):
            await ceph("osd", "pool", "create", pool, "--pg-num",
                       str(BLOCK_PG_NUM))
        await until(lambda: "rbd-dr" in [
            p.name for p in rados.monc.osdmap.pools.values()],
            "the rbd pools in the client's map")
        await until(lambda: active("rbd") and active("rbd-dr"),
                    "active rbd PGs")
        base = rng.bytes(image_bytes)
        with open(path("img.in"), "wb") as f:
            f.write(base)
        t1 = time.perf_counter()
        imported = await rbd_tool("import", "img", path("img.in"),
                                  "--order", str(order))
        t_import = time.perf_counter() - t1
        os.unlink(path("img.in"))
        await rbd_tool("snap", "create", "img@base")
        await rbd_tool("snap", "protect", "img@base")
        await rbd_tool("clone", "img@base", "child")
        io = await rados.open_ioctx("rbd")
        rbd = ns.rbd.RBD(io)
        child = await rbd.open("child")
        patch = rng.bytes(clone_write)
        off = image_bytes // 3 // 4096 * 4096
        await child.write(off, patch)
        await child.close()
        want = {"img": base,
                "child": base[:off] + patch + base[off + clone_write:]}
        exported = {}
        for name, data in want.items():
            out = path(f"{name}.exp")
            exported[name] = (await rbd_tool("export", name, out))[
                "exported"]
            with open(out, "rb") as f:
                got = f.read()
            os.unlink(out)
            if got != data:
                raise AssertionError(f"export {name}: {len(got)} bytes "
                                     f"differ from the expected")
        await rbd_tool("create", "bench", "--size", str(bench_bytes),
                       "--order", str(order))
        bench = await rbd_tool("bench", "bench", "--io-type", "write",
                               "--io-size", str(bench_io), "--io-total",
                               str(bench_bytes))
        groups = ns.rbd_group.RBDGroups(rbd)
        await groups.create("wave")
        for name in want:
            await groups.image_add("wave", name)
        await groups.snap_create("wave", "gsnap")
        gsnaps = [s.get("name") for s in await groups.snap_list("wave")]
        await rbd.create("jimg", mirror_bytes, order=order)
        jimg = await rbd.open("jimg", journaled=True)
        jdata = rng.bytes(mirror_bytes)
        await jimg.write(0, jdata)
        await jimg.close()
        dr = ns.rbd.RBD(await rados.open_ioctx("rbd-dr"))
        mirror = ns.rbd_mirror.RBDMirror(rbd, dr)
        t1 = time.perf_counter()
        shipped = await mirror.mirror_image("jimg")
        t_mirror = time.perf_counter() - t1
        copy = await dr.open("jimg")
        if await copy.read(0, mirror_bytes) != jdata:
            raise AssertionError("the mirrored image differs")
        await copy.close()
        record("block", t0, k0,
               image_bytes + clone_write + bench_bytes + mirror_bytes,
               import_s=t_import,
               import_gib_s=image_bytes / t_import / 2**30,
               imported=imported.get("imported"), exported=exported,
               bench={k: bench.get(k) for k in (
                   "ops", "seconds", "MiB_per_s", "lat_p50_ms",
                   "lat_p99_ms")},
               group_snaps=gsnaps, mirror_shipped=shipped,
               mirror_s=t_mirror)

        # 4. offline
        t0, k0 = time.perf_counter(), ns.launches()
        osdmap = rados.monc.osdmap
        ec_id = pool_id("ecpool")
        pg_num = osdmap.pools[ec_id].pg_num
        expect = set()
        for name in datas:
            ps = ns.object_to_ps(name, pg_num)
            _, _, acting, _ = osdmap.pg_to_up_acting(ec_id, ps)
            for shard, osd in enumerate(acting):
                if osd == victim:
                    expect.add((ps, shard, name))
        await cluster.kill_osd(victim)
        listing = await _tool_out(ns.objectstore_tool, [
            "--data-path", path(f"cluster/osd.{victim}"), "--op", "list"])
        got = set()
        for cid, objs in listing.items():
            pool, _, rest = cid.partition(".")
            if int(pool) != ec_id:
                continue
            ps = int(rest.split("s", 1)[0], 16)
            for o in objs:
                if o["name"] in datas:
                    got.add((ps, o.get("shard"), o["name"]))
        if got != expect or not expect:
            raise AssertionError(f"objectstore list: {sorted(got)} != "
                                 f"{sorted(expect)}")
        mapfile = path("osdmap.bin")
        with open(mapfile, "wb") as f:
            f.write(ns.codec.encode(osdmap.to_dict()))
        mapped = await _tool_out(ns.osdmaptool, [
            mapfile, "--test-map-pgs", "--pool", str(ec_id)])
        rows = mapped["pools"][str(ec_id)]
        for ps in range(pg_num):
            up, _, acting, _ = osdmap.pg_to_up_acting(ec_id, ps)
            if (rows[str(ps)]["up"], rows[str(ps)]["acting"]) != \
                    (up, acting):
                raise AssertionError(f"osdmaptool PG {ps}: {rows[str(ps)]}")
        spec = ns.dencoder._registry()["OSDMap"]
        once = ns.codec.encode(spec["project"](osdmap))
        again = ns.codec.encode(spec["project"](spec["roundtrip"](osdmap)))
        if once != again:
            raise AssertionError("the dencoder's OSDMap round trip differs")
        await cluster.revive_osd(victim)
        await until(lambda: victim in cluster.osds and
                    rados.monc.osdmap.is_up(victim),
                    f"osd.{victim} back up")
        await until(lambda: pgs_clean(cluster.osds.values()),
                    "clean PGs after the restart")
        record("offline", t0, k0, victim=victim, shards_listed=len(got),
               map_epoch=mapped["epoch"], pgs_mapped=len(rows),
               osd_pg_count=mapped.get("osd_pg_count", {}).get(str(victim)),
               dencoder_bytes=len(once))
    finally:
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def block_phase(dev) -> dict:
    """Wave (k) on the port's dev cluster, its OSD daemons on the CUDA
    device ``dev``, its stores in a temporary directory."""
    import asyncio
    import functools
    import tempfile
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import cli, dencoder, objectstore_tool, rbd_tool
    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.msg import codec, reset_local_namespace
    from ceph_tpu_torch.osd.pg import object_to_ps
    from ceph_tpu_torch.placement import compiler
    from ceph_tpu_torch.services import rbd, rbd_group, rbd_mirror
    from ceph_tpu_torch.tools import osdmaptool

    ns = SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        cli=cli, rbd_tool=rbd_tool, objectstore_tool=objectstore_tool,
        osdmaptool=osdmaptool, dencoder=dencoder, codec=codec, rbd=rbd,
        rbd_group=rbd_group, rbd_mirror=rbd_mirror,
        object_to_ps=object_to_ps, launches=lambda: dict(ck.LAUNCHES),
        sync=torch.cuda.synchronize)
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(block_wave(ns, d))


# Wave (l): CephFS.  One port mon and twelve port OSD daemons on the card;
# the filesystem's metadata pool is replicated (dirfrags and the journal
# live in omap, which EC pools refuse) and its data pool is the 8+4 EC pool,
# so every block flush, every write-through overwrite (the EC backend's
# read-modify-write) and every degraded read of file data runs B1 on the
# card.  Upstream Ceph adds an EC pool as a second data pool with
# allow_ec_overwrites and a directory layout; the reference has neither,
# so the wave makes the EC pool the filesystem's data pool.  The EC pools
# refuse snap contexts, so this filesystem takes no snapshot here.
CEPHFS_BUDGET_S = 120.0
CEPHFS_DIRS = 4
CEPHFS_FILES = 16
CEPHFS_FILE_BYTES = 16 << 20
CEPHFS_OVERWRITES = 8
CEPHFS_OVERWRITE_BYTES = 64 << 10
CEPHFS_VOLUME_FILES = 4
CEPHFS_VOLUME_BYTES = 4 << 20
CEPHFS_PG_NUM = 8
CEPHFS_PROFILE = "wave-l"
CEPHFS_OVERRIDES = {
    "mon_osd_down_out_interval": 300.0,
    "osd_ec_resident": True,
    "mds_beacon_interval": 0.2,
    "mds_beacon_grace": 2.0,
}


async def cephfs_wave(ns, store_dir: str, *, n_osds: int = CLUSTER_OSDS,
                      ec_k: int = 8, ec_m: int = 4,
                      files: int = CEPHFS_FILES,
                      file_bytes: int = CEPHFS_FILE_BYTES,
                      overwrites: int = CEPHFS_OVERWRITES,
                      overwrite_bytes: int = CEPHFS_OVERWRITE_BYTES,
                      volume_files: int = CEPHFS_VOLUME_FILES,
                      volume_bytes: int = CEPHFS_VOLUME_BYTES,
                      block_size: int = 1 << 22,
                      victim: int = CLUSTER_VICTIM, need: tuple = (B1,),
                      note=log) -> dict:
    """Wave (l) over one package's ``ns``: ``DevCluster`` (a partial with
    the device), ``fs`` (the CephFS client module), ``mds`` (the MDS
    module), ``cli``, ``cephfs_journal_tool``, ``cephfs_data_scan``,
    ``compiler``, ``reset_local_namespace``, ``SCALE_TEST_OVERRIDES``,
    ``launches`` and ``sync``; ``store_dir`` holds the conf file the tools
    read.

    1 mon and ``n_osds`` OSD daemons (one per CRUSH host, MemStores, the
    resident shard cache, scrub held by ``noscrub``), CRUSH's choose tries
    at 100; a replicated metadata pool ``cephfs_meta`` and an erasure-coded
    data pool ``cephfs_data`` (jax_rs ``ec_k`` + ``ec_m``), 8 PGs each;
    MDS ``a`` active and ``b`` standby of ``block_size`` data blocks.
    Steps, a "[cephfs]" JSON line each (wall seconds, bytes, GiB/s, B1/B2
    launches):

    1. boot: the pools, ``fs new``, both MDSs (``mds stat``: ``a`` active,
       ``b`` standby), a client ``CephFS.connect`` and ``mount``;
    2. write: a small tree, then ``files`` seeded files of ``file_bytes``
       over ``CEPHFS_DIRS`` directories, written concurrently and closed
       (each flushes its blocks under its write cap, a ``write_full`` per
       block); every file read back exact (sha256, length), ``readdir``
       and ``stat`` sizes;
    3. overwrite: ``overwrites`` writes of ``overwrite_bytes`` at odd
       offsets (never on a stripe boundary) through handles opened for
       reading, which hold no write cap, so each goes straight to the data
       pool at its offset: the EC backend's read-modify-write; every file
       read back exact;
    4. degraded: OSD ``victim`` killed and marked down (it holds a shard
       of every PG), every file read back exact (decodes); revived, PGs
       clean;
    5. failover: MDS ``a`` shut down, ``b`` takes rank 0 (the seconds to
       it recorded); a new mount (the client finds rank 0 in the FSMap,
       as the reference's failover test does), ``readdir`` and every file
       exact, one more file of ``file_bytes`` written and read back;
    6. volumes: through the CLI's argv parser ``fs subvolume create`` (its
       size a quota) and ``fs quota set`` on it (room for
       ``volume_files`` files of ``volume_bytes``); those files written
       into it and read back exact, one more refused with EDQUOT, ``fs
       subvolume ls`` and ``fs quota get``;
    7. recover: every MDS stopped; ``cephfs-journal-tool journal
       inspect`` of rank 0 (OK); one directory's dentries removed from its
       dirfrag; ``cephfs-data-scan scan`` (the sizes and backtraces it
       reads from the EC pool) and ``inject`` (each lost file linked back
       at its backtraced name); an MDS started, and the directory's files
       are back under their names, every one exact.

    The kernels of ``need`` must launch in steps 2-5.  Raises on any
    failure; returns each step's record."""
    import asyncio
    import hashlib
    import os

    import numpy as np

    liveness = {key: ns.SCALE_TEST_OVERRIDES[key] for key in CLUSTER_LIVENESS}
    rng = np.random.default_rng(SEED)
    steps: dict[str, dict] = {}
    loop = asyncio.get_running_loop()
    conf = os.path.join(store_dir, "cluster.json")

    async def until(cond, what, timeout=RGW_WAIT_S, every=0.1):
        deadline = loop.time() + timeout
        while True:
            got = cond()
            if asyncio.iscoroutine(got):
                got = await got
            if got:
                return got
            if loop.time() > deadline:
                raise AssertionError(f"no {what} in {timeout:.0f} s")
            await asyncio.sleep(every)

    def record(step, t0, k0, nbytes=0, launched=(), **kw):
        ns.sync()
        wall = time.perf_counter() - t0
        k1 = ns.launches()
        delta = {k: k1[k] - k0.get(k, 0) for k in k1
                 if k1[k] != k0.get(k, 0)}
        rec = {"step": step, "wall_s": wall, "bytes": nbytes,
               "gib_s": nbytes / wall / 2**30 if nbytes else 0.0,
               "b1_launches": delta.get(B1, 0),
               "b2_launches": delta.get(B2, 0), **kw,
               "kernel_launches": delta}
        steps[step] = rec
        note(f"[cephfs] {json.dumps(rec)}")
        missing = [k for k in launched if not delta.get(k)]
        if missing:
            raise AssertionError(f"{step}: {missing} not launched")
        return rec

    async def command(prefix, **kw):
        r = await rados.mon_command(prefix, timeout=RGW_WAIT_S, **kw)
        if r["rc"] != 0:
            raise AssertionError(f"{prefix}: {r}")
        return r

    def active(name):
        pid = next(pid for pid, p in rados.monc.osdmap.pools.items()
                   if p.name == name)
        pg_num = rados.monc.osdmap.pools[pid].pg_num
        return sum(1 for o in cluster.osds.values()
                   for pgid, pg in o.pgs.items()
                   if pgid.pool == pid and pg.is_primary
                   and pg.state == "active") == pg_num

    async def fs_summary(want):
        """The filesystem's ``mds stat`` entry once ``want`` holds of it,
        else None (for ``until``)."""
        r = await command("mds stat")
        s = r["data"]["filesystems"].get("cephfs", {})
        return s if want(s) else None

    def rank0(s):
        return (s.get("active") or {}).get("name")

    async def mount():
        client = await ns.fs.CephFS.connect(rados)
        await client.mount()
        return client

    def digest(data):
        return len(data), hashlib.sha256(data).hexdigest()

    async def read_all(client, step, paths=None):
        """Every file of ``want`` (or of ``paths``) read back: raises
        unless each is exact; returns the bytes read."""
        bad, nbytes = [], 0
        for p in (paths or want):
            got = await client.read_file(p)
            if digest(got) != digest(want[p]):
                bad.append((p, len(got)))
            nbytes += len(got)
        if bad:
            raise AssertionError(f"{step}: {len(bad)} files differ, first "
                                 f"{bad[0]}")
        return nbytes

    async def listing(client):
        """Each directory's names and the sizes its dentries and ``stat``
        give, held to ``want``."""
        for d in dir_names:
            got = await client.readdir(d)
            names = {f"{d}/{n}": int(e.get("size", 0))
                     for n, e in got.items()}
            expect = {p: len(v) for p, v in want.items()
                      if p.rsplit("/", 1)[0] == d}
            if names != expect:
                raise AssertionError(f"readdir {d}: {sorted(names)} != "
                                     f"{sorted(expect)}")
        for p, data in want.items():
            if int((await client.stat(p))["size"]) != len(data):
                raise AssertionError(f"stat {p}")

    t_phase = time.perf_counter()
    ns.reset_local_namespace()
    cluster = ns.DevCluster(n_mons=1, n_osds=n_osds, osds_per_host=1,
                            overrides={**liveness, **CEPHFS_OVERRIDES})
    rados = fs = None
    dir_names = [f"/wave/d{i}" for i in range(CEPHFS_DIRS)]
    want: dict[str, bytes] = {}
    try:
        # 1. boot
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.start()
        rados = await cluster.client()
        await command("osd set", flag="noscrub")
        text = ns.compiler.decompile(rados.monc.osdmap.crush)
        tunable = "tunable choose_total_tries 50\n"
        await command("osd setcrushmap", map=text.replace(
            tunable, f"tunable choose_total_tries {MAP_CHOOSE_TRIES}\n"))
        await command("osd erasure-code-profile set", name=CEPHFS_PROFILE,
                      profile={"plugin": "jax_rs", "k": str(ec_k),
                               "m": str(ec_m),
                               "crush-failure-domain": "osd"})
        await rados.pool_create("cephfs_meta", pg_num=CEPHFS_PG_NUM)
        await rados.pool_create("cephfs_data", pool_type="erasure",
                                erasure_code_profile=CEPHFS_PROFILE,
                                pg_num=CEPHFS_PG_NUM)
        await until(lambda: active("cephfs_meta") and active("cephfs_data"),
                    "active CephFS PGs")
        await cluster.start_mds("a", block_size=block_size)
        await cluster.start_mds("b", block_size=block_size)
        summary = await until(lambda: fs_summary(
            lambda s: rank0(s) == "a" and s.get("standby") == ["b"]),
            "mds.a active with mds.b standby")
        fs = await mount()
        cluster.write_conf(conf)
        record("boot", t0, k0, mons=len(cluster.mons),
               osds=len(cluster.osds),
               active=summary["active"]["name"],
               standby=summary["standby"], block_size=fs.block_size,
               data_pool=fs.data.pool_name)
        if fs.block_size != block_size:
            raise AssertionError(f"block size {fs.block_size}")

        # 2. write
        t0, k0 = time.perf_counter(), ns.launches()
        await fs.mkdirs("/wave/tree/x/y")
        for d in dir_names:
            await fs.mkdirs(d)
        for i in range(files):
            want[f"{dir_names[i % CEPHFS_DIRS]}/f{i:02d}"] = \
                rng.bytes(file_bytes)
        t1 = time.perf_counter()
        await asyncio.gather(*(fs.write_file(p, data)
                               for p, data in want.items()))
        t_write = time.perf_counter() - t1
        k_write = ns.launches()
        write_launches = {k: k_write[k] - k0.get(k, 0) for k in k_write
                          if k_write[k] != k0.get(k, 0)}
        t1 = time.perf_counter()
        nbytes = await read_all(fs, "write")
        t_read = time.perf_counter() - t1
        await listing(fs)
        tree = sorted(await fs.readdir("/wave"))
        blocks = len([o for o in await fs.data.list_objects()
                      if not o.endswith(".bt")])
        record("write", t0, k0, nbytes, launched=need, write_s=t_write,
               write_gib_s=nbytes / t_write / 2**30,
               write_launches=write_launches, read_s=t_read,
               read_gib_s=nbytes / t_read / 2**30, files=len(want),
               tree=tree, data_objects=blocks)
        if blocks != files * -(-file_bytes // block_size):
            raise AssertionError(f"{blocks} data objects")

        # 3. overwrite
        t0, k0 = time.perf_counter(), ns.launches()
        targets = list(want)[:overwrites]
        offsets = [int(x) | 1 for x in rng.integers(
            0, file_bytes - overwrite_bytes, len(targets))]
        t1 = time.perf_counter()
        for p, off in zip(targets, offsets):
            patch = rng.bytes(overwrite_bytes)
            fh = await fs.open(p, "r")
            if fh._cap:
                raise AssertionError(f"{p}: a read handle holds the cap")
            await fh.write(patch, off)
            await fh.close()
            data = bytearray(want[p])
            data[off:off + overwrite_bytes] = patch
            want[p] = bytes(data)
        t_write = time.perf_counter() - t1
        k_write = ns.launches()
        write_launches = {k: k_write[k] - k0.get(k, 0) for k in k_write
                          if k_write[k] != k0.get(k, 0)}
        nbytes = await read_all(fs, "overwrite")
        await listing(fs)
        record("overwrite", t0, k0, overwrites * overwrite_bytes,
               launched=need, write_s=t_write,
               write_launches=write_launches, offsets=offsets,
               read_back=nbytes)
        if not write_launches.get(B1) and B1 in need:
            raise AssertionError("overwrite: the writes launched no B1")

        # 4. degraded
        t0, k0 = time.perf_counter(), ns.launches()
        await cluster.kill_osd(victim)
        await command("osd down", ids=[victim])
        await until(lambda: not rados.monc.osdmap.is_up(victim),
                    f"an epoch with osd.{victim} down")
        t1 = time.perf_counter()
        nbytes = await read_all(fs, "degraded")
        t_read = time.perf_counter() - t1
        k_read = ns.launches()
        read_launches = {k: k_read[k] - k0.get(k, 0) for k in k_read
                         if k_read[k] != k0.get(k, 0)}
        await cluster.revive_osd(victim)
        await until(lambda: victim in cluster.osds and
                    rados.monc.osdmap.is_up(victim),
                    f"osd.{victim} back up")
        await until(lambda: pgs_clean(cluster.osds.values()),
                    "clean PGs after the revive")
        record("degraded", t0, k0, nbytes, read_s=t_read,
               read_gib_s=nbytes / t_read / 2**30,
               read_launches=read_launches, victim=victim)
        if not read_launches.get(B1) and B1 in need:
            raise AssertionError("degraded: the reads launched no B1")

        # 5. failover
        t0, k0 = time.perf_counter(), ns.launches()
        await fs.unmount()
        fs = None
        await cluster.mdss.pop("a").shutdown()
        t1 = time.perf_counter()
        summary = await until(lambda: fs_summary(
            lambda s: rank0(s) == "b"), "mds.b active")
        takeover = time.perf_counter() - t1
        fs = await mount()
        await listing(fs)
        nbytes = await read_all(fs, "failover")
        late = f"{dir_names[1]}/late"
        want[late] = rng.bytes(file_bytes)
        await fs.write_file(late, want[late])
        nbytes += await read_all(fs, "failover", [late])
        record("failover", t0, k0, nbytes, launched=need,
               takeover_s=takeover, active=summary["active"]["name"],
               down=summary.get("down"))

        # 6. volumes
        t0, k0 = time.perf_counter(), ns.launches()
        quota = volume_files * volume_bytes + 4096
        created = await _tool_out(ns.cli, [
            "--conf", conf, "--format", "json", "fs", "subvolume",
            "create", "vol", "--size", str(2 * quota)])
        vpath = created["path"]
        await _tool_text(ns.cli, ["--conf", conf, "fs", "quota", "set",
                                  vpath, "--max-bytes", str(quota)])
        vol = {f"{vpath}/v{i}": rng.bytes(volume_bytes)
               for i in range(volume_files)}
        for p, data in vol.items():
            await fs.write_file(p, data)
        for p, data in vol.items():
            if digest(await fs.read_file(p)) != digest(data):
                raise AssertionError(f"volumes: {p} differs")
        try:
            await fs.write_file(f"{vpath}/over", rng.bytes(volume_bytes))
        except ns.fs.FSError as e:
            refused = e.rc
        else:
            refused = None
        if refused != ns.mds.EDQUOT:
            raise AssertionError(f"a write past the quota gave {refused}")
        listed = await _tool_out(ns.cli, [
            "--conf", conf, "--format", "json", "fs", "subvolume", "ls"])
        got_quota = await _tool_out(ns.cli, [
            "--conf", conf, "--format", "json", "fs", "quota", "get",
            vpath])
        record("volumes", t0, k0, volume_files * volume_bytes, path=vpath,
               subvolumes=listed, refused=refused,
               quota={"max_bytes": got_quota["quota"]["max_bytes"],
                      "usage_bytes": got_quota["usage"]["bytes"]})
        if listed != ["vol"] or got_quota["quota"]["max_bytes"] != quota:
            raise AssertionError(f"volumes: {listed} {got_quota}")

        # 7. recover
        t0, k0 = time.perf_counter(), ns.launches()
        lost_dir = dir_names[1]
        lost_ino = int((await fs.stat(lost_dir))["ino"])
        await fs.unmount()
        fs = None
        for name in list(cluster.mdss):
            await cluster.mdss.pop(name).shutdown()
        inspected = await _tool_out(ns.cephfs_journal_tool, [
            "--conf", conf, "journal", "inspect", "--rank", "0"])
        if inspected.get("overall") != "OK":
            raise AssertionError(f"journal inspect: {inspected}")
        meta = await rados.open_ioctx("cephfs_meta")
        frag = ns.mds.dirfrag_oid(lost_ino)
        lost = sorted(await meta.get_omap(frag))
        await meta.rm_omap_keys(frag, lost)
        scanned = await _tool_out(ns.cephfs_data_scan, [
            "--conf", conf, "--block-size", str(block_size), "scan"])
        injected = await _tool_out(ns.cephfs_data_scan, [
            "--conf", conf, "--block-size", str(block_size), "inject"])
        relinked = sorted(r["name"] for r in injected["linked"]
                          if r["parent"] == lost_ino)
        await cluster.start_mds("c", block_size=block_size)
        await until(lambda: fs_summary(lambda s: rank0(s) == "c"),
                    "mds.c active")
        fs = await mount()
        back = sorted(await fs.readdir(lost_dir))
        paths = [p for p in want if p.rsplit("/", 1)[0] == lost_dir]
        nbytes = await read_all(fs, "recover", paths)
        record("recover", t0, k0, nbytes, journal={
                   k: inspected.get(k) for k in ("overall", "events")},
               lost=lost, scanned=len(scanned), relinked=relinked,
               lost_found=injected["lost_found"], back=back)
        if relinked != lost or back != lost or injected["lost_found"]:
            raise AssertionError(f"recover: lost {lost}, relinked "
                                 f"{relinked}, back {back}")
    finally:
        if fs is not None:
            await fs.unmount()
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        ns.reset_local_namespace()
    return {"steps": steps, "seconds": time.perf_counter() - t_phase}


def cephfs_phase(dev) -> dict:
    """Wave (l) on the port's dev cluster, its OSD daemons on the CUDA
    device ``dev``; the tools' conf file in a temporary directory."""
    import asyncio
    import functools
    import tempfile
    from types import SimpleNamespace

    import torch

    from ceph_tpu_torch import cephfs_data_scan, cephfs_journal_tool, cli
    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.client import fs
    from ceph_tpu_torch.ec import cuda_kernels as ck
    from ceph_tpu_torch.mds import daemon as mds
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.placement import compiler

    ns = SimpleNamespace(
        DevCluster=functools.partial(vstart.DevCluster, device=dev),
        SCALE_TEST_OVERRIDES=vstart.SCALE_TEST_OVERRIDES,
        reset_local_namespace=reset_local_namespace, compiler=compiler,
        cli=cli, fs=fs, mds=mds, cephfs_journal_tool=cephfs_journal_tool,
        cephfs_data_scan=cephfs_data_scan,
        launches=lambda: dict(ck.LAUNCHES), sync=torch.cuda.synchronize)
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(cephfs_wave(ns, d))


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
        from ceph_tpu_torch.testing import crc_builds, perf_lab, sass
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
    # The OSD path's device CRC (ec.checksum.CrcPlan): B2's step over
    # segments of 16 lanes, the segment fold and the lane fold, at the
    # write path's 12 streams of L = 64 KiB and the scrub group's 768,
    # against the plain version (the whole (32, 8L) map as one bit-plane
    # contraction) and the host crc32c.
    from ceph_tpu_torch.common.crc32c import crc32c as host_crc32c

    for nstreams in (12, 768):
        data = rand_u8((nstreams, checksum.CRC_DEVICE_MAX_LEN))
        got8 = checksum.crc_bits_device(data)
        ref8 = checksum.crc_bits_plain(data)
        torch.cuda.synchronize()
        ok = torch.equal(got8, ref8)
        rows = data[:4].cpu().numpy()
        ok = ok and checksum.finalize_crcs(
            got8[:4].cpu().numpy(), [checksum.CRC_SEED] * 4,
            data.shape[1]) == [host_crc32c(checksum.CRC_SEED, r.tobytes())
                               for r in rows]
        plan = checksum.crc_constants(data.shape[1])
        log(f"[exact] device CRC ({plan.launches} B2 launches: step "
            f"{plan.step1.kin} x 16 lanes, folds "
            f"{[f for f, _ in plan.seg_folds]} / "
            f"{[f for f, _ in plan.lane_folds]}) over {nstreams} streams of "
            f"{data.shape[1]} B -> equal={ok}")
        if not ok:
            raise AssertionError(f"the device CRC != its plain version on "
                                 f"{nstreams} streams")
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

    # The OSD path's device CRC (ec.checksum.CrcPlan, its B2 launches as
    # the OSD issues them) at the write path's 12 streams of 64 KiB and the
    # scrub group's 64 x 12, beside its plain version, PR 9's form (one B2
    # launch of the (4 x L) contraction over the (L, B) transpose) and, as
    # the library yardstick, the JAX package's own form (bit expansion, a
    # bf16 matmul with float32 accumulation, & 1, repack); then the scrub
    # verdict (parity compare, CRC, both copied to the host) at the scrub
    # group's shape.  Bound: the streams read and the registers written
    # once, or the bit-plane contraction's int8 operations.
    crc_rows = []
    for nrows in (12, 768):
        streams = rand_u8((nrows, checksum.CRC_DEVICE_MAX_LEN))
        L = streams.shape[1]
        plan = checksum.crc_constants(L)
        old = ck.GF2Constants(checksum.crc_bitmatrix(L))
        c_s = time_it(lambda: checksum.crc_bits_device(streams))
        host_s = enqueue_s(lambda: checksum.crc_bits_device(streams), 50)
        p_s = time_it(lambda: checksum.crc_bits_plain(streams),
                      iterations=3, runs=3)
        old_s = time_it(lambda: ck.gf2_apply_u8(old, streams.t().contiguous()),
                        iterations=2, runs=3)
        mm_bits = crc_builds.crc_bits_matmul(streams)
        if not torch.equal(mm_bits, checksum.crc_bits_plain(streams)):
            raise AssertionError("the JAX form of the CRC differs")
        lib_s = time_it(lambda: crc_builds.crc_bits_matmul(streams),
                        iterations=5)
        c_bound, c_by = bound(nrows * L + 4 * nrows, 2 * 32 * 8 * L * nrows)
        row = {"crc": "crc_bits_device", "shape": [nrows, L],
               "launches": plan.launches, "ms": c_s * 1e3,
               "host_ms": host_s * 1e3, "plain_ms": p_s * 1e3,
               "old_form_ms": old_s * 1e3, "library_ms": lib_s * 1e3,
               "bound_ms": c_bound * 1e3,
               "bound_by": c_by}
        crc_rows.append(row)
        log(f"[crc] {json.dumps(row)}")
        log(f"[time] crc_bits_device ({nrows}, {L}): {c_s * 1e6:.2f} us "
            f"({plan.launches} launches, enqueue {host_s * 1e6:.2f} us), "
            f"bound {c_bound * 1e6:.2f} us ({c_by}) = "
            f"{100 * c_bound / c_s:.2f}% of bound; PR 9's form "
            f"{old_s * 1e6:.2f} us ({old_s / c_s:.1f}x); JAX form (bf16 "
            f"mm, float32 out) {lib_s * 1e6:.2f} us")
    stored = streams.reshape(64, 12, L)
    recomputed = stored.clone()
    v_s = time_it(lambda: checksum.verify_batch(recomputed, stored))
    v_bound, v_by = bound(2 * stored.numel() + 5 * 64 * 12,
                          2 * 32 * 8 * L * 768)
    log(f"[time] verify_batch (64, 12, {L}): {v_s * 1e6:.2f} us (parity "
        f"compare + device CRC + copies to the host), bound "
        f"{v_bound * 1e6:.2f} us ({v_by}) = {100 * v_bound / v_s:.2f}% of "
        f"bound")
    del streams, stored, recomputed, mm_bits

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
    # ECBackend over 12 MemStore shards, then 12 WalStores: the coalesced
    # launcher, the resident write-back cache, hinfo by the device CRC,
    # batched scrub and repair, a remount and a backfill (osd_phase).  B1
    # carries every encode and decode, B2 the CRC.
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

    # -- 7. the cluster, counted ---------------------------------------------
    # Wave (f): twelve OSD daemons under three monitors serve the 8+4 pool
    # (cluster_wave).  B1 carries the primaries' encodes, the degraded
    # reads and the batched repair, B2 the resident pool's hinfo CRC.  The
    # kernels were built in phase 1, so no daemon's loop waits on nvcc.
    ck.reset_launch_counts()
    cluster = cluster_phase(dev)
    cluster_launches = counts()
    log(f"[main path: cluster] launches {cluster_launches}; "
        f"{len(cluster['steps'])} steps in {cluster['seconds']:.2f} s "
        f"(budget {CLUSTER_BUDGET_S:.0f} s)")
    for name in ("gf2_apply_words", "gf2_apply_u8"):
        if cluster_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"cluster main path")
        main_launches[name] += cluster_launches[name]
    if cluster["seconds"] > CLUSTER_BUDGET_S:
        raise AssertionError(f"the cluster phase took "
                             f"{cluster['seconds']:.1f} s")

    # -- 8. the mesh planes, counted -----------------------------------------
    # Wave (g): 8 slots over the card, each with its own stream (mesh_phase).
    # B1 carries every slot's encode and decode, B3 the sharded CLAY repair.
    # It runs after (f), so that (a)-(f) are measured as before.
    from ceph_tpu_torch.parallel import mesh as mesh_mod

    ck.reset_launch_counts()
    with mesh_mod.forced_device_count(MESH_SLOTS, dev):
        mesh_mod.reset_traffic()
        mesh = mesh_phase(dev, seconds=lambda fn: time_it(fn, 3, 3))
    mesh_launches = counts()
    log(f"[main path: mesh] launches {mesh_launches}; {len(mesh['steps'])} "
        f"steps in {mesh['seconds']:.2f} s (budget {MESH_BUDGET_S:.0f} s)")
    for name in ("gf2_apply_words", "gf2_apply_grouped"):
        if mesh_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"mesh main path")
    for name in ck.LAUNCHES:
        main_launches[name] += mesh_launches[name]
    if mesh["seconds"] > MESH_BUDGET_S:
        raise AssertionError(f"the mesh phase took {mesh['seconds']:.1f} s")

    # -- 9. the manager, counted ---------------------------------------------
    # Wave (h): a port mgr watches, judges and defends the 8+4 pool that
    # twelve OSD daemons serve (mgr_phase).  B1 carries the primaries'
    # encodes and the scrub's re-encode, B2 the scrub's CRC.
    ck.reset_launch_counts()
    mgr_run = mgr_phase(dev)
    mgr_launches = counts()
    log(f"[main path: mgr] launches {mgr_launches}; "
        f"{len(mgr_run['steps'])} steps in {mgr_run['seconds']:.2f} s "
        f"(budget {MGR_BUDGET_S:.0f} s)")
    for name in ("gf2_apply_words", "gf2_apply_u8"):
        if mgr_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"mgr main path")
    for name in ck.LAUNCHES:
        main_launches[name] += mgr_launches[name]
    if mgr_run["seconds"] > MGR_BUDGET_S:
        raise AssertionError(f"the mgr phase took {mgr_run['seconds']:.1f} s")

    # -- 10. the gateway, counted ---------------------------------------------
    # Wave (i): S3 traffic through the port's gateway, tiered into the 8+4
    # cold pool that twelve OSD daemons serve (rgw_phase).  B1 carries the
    # cold PUTs' and the transitions' encodes, the degraded GETs' decodes
    # and the scrub's re-encode; the wave fails unless B1 launched in its
    # put-cold, transition and degraded steps.
    ck.reset_launch_counts()
    rgw_run = rgw_phase(dev)
    rgw_launches = counts()
    log(f"[main path: rgw] launches {rgw_launches}; "
        f"{len(rgw_run['steps'])} steps in {rgw_run['seconds']:.2f} s "
        f"(budget {RGW_BUDGET_S:.0f} s)")
    if rgw_launches[B1] == 0:
        raise AssertionError(f"kernel {B1} was not launched on the "
                             f"gateway main path")
    for name in ck.LAUNCHES:
        main_launches[name] += rgw_launches[name]
    if rgw_run["seconds"] > RGW_BUDGET_S:
        raise AssertionError(f"the gateway phase took "
                             f"{rgw_run['seconds']:.1f} s")

    # -- 11. multisite, counted ----------------------------------------------
    # Wave (j): S3, Swift and file traffic replicated from zone a to zone
    # b of a port realm, each zone's bodies in its own 8+4 pool
    # (multisite_phase).  B1 carries zone a's COLD PUTs, zone b's tiering
    # of the replicas and b's degraded GETs; the wave fails unless B1
    # launched in its put-a, sync and degraded steps.
    ck.reset_launch_counts()
    multisite_run = multisite_phase(dev)
    multisite_launches = counts()
    log(f"[main path: multisite] launches {multisite_launches}; "
        f"{len(multisite_run['steps'])} steps in "
        f"{multisite_run['seconds']:.2f} s (budget "
        f"{MULTISITE_BUDGET_S:.0f} s)")
    if multisite_launches[B1] == 0:
        raise AssertionError(f"kernel {B1} was not launched on the "
                             f"multisite main path")
    for name in ck.LAUNCHES:
        main_launches[name] += multisite_launches[name]
    if multisite_run["seconds"] > MULTISITE_BUDGET_S:
        raise AssertionError(f"the multisite phase took "
                             f"{multisite_run['seconds']:.1f} s")

    # -- 12. the admin CLIs and block images, counted -------------------------
    # Wave (k): the CLI's EC pool on twelve OSD daemons over durable
    # stores, block images on a replicated pool, the offline tools
    # (block_phase).  B1 carries the CLI's puts and its degraded gets; RBD
    # launches nothing (its pools are replicated).
    ck.reset_launch_counts()
    block_run = block_phase(dev)
    block_launches = counts()
    log(f"[main path: block] launches {block_launches}; "
        f"{len(block_run['steps'])} steps in {block_run['seconds']:.2f} s "
        f"(budget {BLOCK_BUDGET_S:.0f} s)")
    if block_launches[B1] == 0:
        raise AssertionError(f"kernel {B1} was not launched on the "
                             f"block/CLI main path")
    for name in ck.LAUNCHES:
        main_launches[name] += block_launches[name]
    if block_run["seconds"] > BLOCK_BUDGET_S:
        raise AssertionError(f"the block phase took "
                             f"{block_run['seconds']:.1f} s")

    # -- 13. CephFS, counted --------------------------------------------------
    # Wave (l): a filesystem whose data pool is the 8+4 pool on twelve OSD
    # daemons (cephfs_phase).  B1 carries the block flushes, the
    # write-through overwrites' read-modify-write, the degraded reads and
    # the writes after the MDS failover; the wave fails unless B1 launched
    # in each of those steps.
    ck.reset_launch_counts()
    cephfs_run = cephfs_phase(dev)
    cephfs_launches = counts()
    log(f"[main path: cephfs] launches {cephfs_launches}; "
        f"{len(cephfs_run['steps'])} steps in {cephfs_run['seconds']:.2f} s "
        f"(budget {CEPHFS_BUDGET_S:.0f} s)")
    if cephfs_launches[B1] == 0:
        raise AssertionError(f"kernel {B1} was not launched on the "
                             f"CephFS main path")
    for name in ck.LAUNCHES:
        main_launches[name] += cephfs_launches[name]
    if cephfs_run["seconds"] > CEPHFS_BUDGET_S:
        raise AssertionError(f"the CephFS phase took "
                             f"{cephfs_run['seconds']:.1f} s")

    # -- 14. result lines -----------------------------------------------------
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
