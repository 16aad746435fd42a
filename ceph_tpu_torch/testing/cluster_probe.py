"""The EC coalescer behind the OSD daemons, one configuration at a time.

    python -m ceph_tpu_torch.testing.cluster_probe [--profile]
        [--objects N] [--object-bytes B] [--device cpu]

Boots the dev cluster of ``chip_smoke.py``'s wave (f) (3 mons, 12 OSD
daemons, one per CRUSH host, the Ceph docs' 8+4 profile, the scale
profile's liveness timers) once per configuration below, writes
``--objects`` concurrent objects of ``--object-bytes`` (64 x 4 MiB) to a
pool of one PG through a ``Rados`` client, reads them back bit-identical,
and prints one JSON line per configuration: write and read seconds, the
daemons' coalesced ops and launches and their summed encode-launch
seconds.  The configurations: WalStores (the dev cluster's durable tier)
or MemStores, and the coalescer's ``osd_ec_coalesce_max_stripes`` and
``osd_ec_coalesce_window_us`` at their defaults or raised.  With
``--profile`` the first configuration's writes run under ``cProfile``
(the event loop's thread only) and the top functions by own time follow
its line.  Build the kernels first on the card (``common.cuda_build``);
this module does, so that no daemon's op waits on nvcc.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import json
import pstats
import tempfile
import time

import numpy as np

LIVENESS = ("mon_lease", "mon_lease_interval", "mon_election_timeout",
            "mon_tick_interval", "mon_accept_timeout",
            "paxos_propose_interval", "osd_heartbeat_interval",
            "osd_heartbeat_grace")
PROFILE = {"plugin": "jax_rs", "technique": "reed_sol_van", "k": "8",
           "m": "4", "crush-failure-domain": "host"}
RAISED = {"osd_ec_coalesce_max_stripes": 65536}
CONFIGS = (
    ("wal-default", True, {}),
    ("mem-default", False, {}),
    ("mem-max-stripes-65536", False, RAISED),
    ("mem-max-stripes-65536-window-20ms", False,
     {**RAISED, "osd_ec_coalesce_window_us": 20000.0}),
    ("wal-max-stripes-65536-window-20ms", True,
     {**RAISED, "osd_ec_coalesce_window_us": 20000.0}),
)
COUNTERS = ("ec_coalesce_ops", "ec_coalesce_launches", "ec_encode_launch_us")


async def probe(label: str, store_dir: str | None, extra: dict, device,
                objects: int, object_bytes: int, profile: bool) -> dict:
    from ceph_tpu_torch.msg import reset_local_namespace
    from ceph_tpu_torch.vstart import SCALE_TEST_OVERRIDES, DevCluster

    reset_local_namespace()
    overrides = {key: SCALE_TEST_OVERRIDES[key] for key in LIVENESS}
    cluster = DevCluster(n_mons=3, n_osds=12, store_dir=store_dir,
                         device=device, overrides={**overrides, **extra})
    await cluster.start()
    rados = None
    try:
        rados = await cluster.client()
        r = await rados.mon_command("osd erasure-code-profile set",
                                    name="ec84", profile=dict(PROFILE))
        if r["rc"] != 0:
            raise RuntimeError(f"profile set: {r}")
        await rados.pool_create("coal", pool_type="erasure",
                                erasure_code_profile="ec84", pg_num=1)
        ioctx = await rados.open_ioctx("coal")
        rng = np.random.default_rng(0)
        datas = {f"c{i}": rng.bytes(object_bytes) for i in range(objects)}
        await ioctx.write_full("warm", bytes(object_bytes))

        def summed():
            return {key: sum(o.perf.value(key)
                             for o in cluster.osds.values())
                    for key in COUNTERS}

        c0 = summed()
        prof = cProfile.Profile() if profile else None
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        await asyncio.gather(*(ioctx.write_full(o, d)
                               for o, d in datas.items()))
        if prof is not None:
            prof.disable()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = await asyncio.gather(*(ioctx.read(o) for o in datas))
        read_s = time.perf_counter() - t0
        if any(g != datas[o] for o, g in zip(datas, got)):
            raise AssertionError(f"{label}: read-back differs")
        c1 = summed()
        rec = {"config": label, "store": "wal" if store_dir else "mem",
               **extra, "write_s": write_s, "read_s": read_s,
               "ops": c1["ec_coalesce_ops"] - c0["ec_coalesce_ops"],
               "launches": (c1["ec_coalesce_launches"]
                            - c0["ec_coalesce_launches"]),
               "encode_launch_s": (c1["ec_encode_launch_us"]
                                   - c0["ec_encode_launch_us"]) / 1e6}
        if prof is not None:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime") \
                .print_stats(25)
            rec["profile"] = out.getvalue()
        return rec
    finally:
        if rados is not None:
            await rados.shutdown()
        await cluster.stop()
        reset_local_namespace()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objects", type=int, default=64)
    ap.add_argument("--object-bytes", type=int, default=4 << 20)
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    from ceph_tpu_torch.ec.engine import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        from ceph_tpu_torch.common import cuda_build

        cuda_build.build(cuda_build.SOURCES)
    for i, (label, durable, extra) in enumerate(CONFIGS):
        with tempfile.TemporaryDirectory() as tmp:
            rec = asyncio.run(probe(
                label, f"{tmp}/osds" if durable else None, extra, device,
                args.objects, args.object_bytes, args.profile and i == 0))
        text = rec.pop("profile", None)
        print(json.dumps(rec), flush=True)
        if text is not None:
            print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
