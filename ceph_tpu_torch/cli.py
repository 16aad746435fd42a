"""The ``ceph``/``rados`` CLI surface.

Counterpart of ceph_tpu/cli.py: the same module over the
port's imports.  Its one departure: ``_TOOLS``, the ``tool`` passthrough's
table of module names, names the port's offline tools.  The ``fs`` and
``volume`` commands reach ``client.fs`` and ``services.volumes``, which
the port has not yet (ROADMAP A12.4).

The reference ships ``ceph`` (src/ceph.in, a JSON command-protocol client
of mon/mgr, command table src/mon/MonCommands.h) and ``rados`` (object
IO). One entry point covers both here::

    python -m ceph_tpu_torch.cli --conf cluster.json status
    python -m ceph_tpu_torch.cli osd tree
    python -m ceph_tpu_torch.cli osd pool create mypool --pg-num 16
    python -m ceph_tpu_torch.cli osd erasure-code-profile set p1 k=4 m=2
    python -m ceph_tpu_torch.cli osd pool create ecpool --pool-type erasure \\
        --profile p1
    python -m ceph_tpu_torch.cli config set osd_recovery_max_active 4
    python -m ceph_tpu_torch.cli rados -p mypool put objname ./file
    python -m ceph_tpu_torch.cli rados -p mypool ls

``--conf`` points at the cluster file DevCluster.write_conf emits
(default ``./cluster.json``); ``--format json`` switches the human output
to raw JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.client.rados import Rados, RadosError
from ceph_tpu_torch.common.config import ConfigProxy


def _load_conf(path: str) -> tuple[dict, ConfigProxy]:
    with open(path) as f:
        doc = json.load(f)
    return doc["monmap"], ConfigProxy(overrides=doc.get("overrides", {}))


def _print(result, as_json: bool) -> None:
    if as_json:
        print(json.dumps(result, indent=2, default=str))
        return
    if isinstance(result, str):
        print(result)
    else:
        print(json.dumps(result, indent=2, default=str))


def _render_tree(tree: dict) -> str:
    lines = ["ID   WEIGHT  TYPE NAME           STATUS  REWEIGHT"]

    def walk(node: dict, depth: int) -> None:
        indent = "    " * depth
        if node.get("type") == "osd":
            lines.append(
                f"{node['id']:>3}          osd  {indent}{node['name']:<14} "
                f"{node['status']:<7} {node['reweight']:.5f}"
            )
        else:
            lines.append(
                f"{node['id']:>3}          {node['type']:<4} "
                f"{indent}{node['name']}"
            )
            for child in node.get("children", ()):
                walk(child, depth + 1)

    for root in tree.get("nodes", ()):
        walk(root, 0)
    return "\n".join(lines)


def _render_status(st: dict) -> str:
    om = st["osdmap"]
    return "\n".join([
        "  cluster:",
        f"    health: {st['health']['status']}",
        *(f"      {name}: {c['message']}"
          for name, c in st["health"]["checks"].items()),
        "  services:",
        f"    mon: quorum {','.join(st['mon']['quorum'])}"
        f" (leader {st['mon']['leader']})",
        f"    osd: {om['num_osds']} osds: {om['num_up_osds']} up,"
        f" {om['num_in_osds']} in",
        "  data:",
        f"    pools: {om['num_pools']}",
        f"    osdmap epoch: {om['epoch']}",
        *_render_pgmap(st.get("pgmap")),
    ])


def _render_pgmap(pgmap: dict | None) -> list[str]:
    if not pgmap or not pgmap.get("num_pgs"):
        return []
    states = ", ".join(
        f"{n} {s}" for s, n in sorted(pgmap["pgs_by_state"].items())
    )
    lines = [
        f"    pgs: {pgmap['num_pgs']} ({states})",
        f"    objects: {pgmap['num_objects']}"
        f" ({pgmap['num_bytes']} bytes)",
    ]
    if pgmap.get("degraded_objects"):
        lines.append(f"    degraded: {pgmap['degraded_objects']} objects")
    return lines


async def _run(args) -> int:
    monmap, conf = _load_conf(args.conf)
    rados = Rados(monmap, conf, name="client.cli")
    try:
        await rados.connect(timeout=args.timeout)
        return await _dispatch(args, rados)
    finally:
        await rados.shutdown()


async def _mon(rados: Rados, prefix: str, as_json: bool,
               render=None, **kw) -> int:
    r = await rados.mon_command(prefix, **kw)
    if r["rc"] != 0:
        print(f"Error: {r['outs']} (rc={r['rc']})", file=sys.stderr)
        return 1
    out = r["data"] if r["data"] is not None else r["outs"]
    if render is not None and not as_json and r["data"] is not None:
        out = render(r["data"])
    _print(out, as_json)
    return 0


async def _fs_volumes(rados: Rados, args, as_json: bool) -> int:
    """``ceph fs subvolume`` / ``fs subvolumegroup`` verbs (reference
    mgr volumes module surface), driven over a mounted CephFS."""
    from ceph_tpu_torch.client.fs import CephFS, FSError
    from ceph_tpu_torch.services.volumes import VolumeManager

    fs = await CephFS.connect(rados, args.fs_name)
    await fs.mount()
    try:
        vm = VolumeManager(fs)
        group = getattr(args, "group", None)
        try:
            if args.action == "subvolumegroup":
                if args.verb == "create":
                    await vm.group_create(args.name)
                    out = None
                elif args.verb == "rm":
                    await vm.group_rm(args.name)
                    out = None
                else:
                    out = await vm.group_ls()
            elif args.verb == "create":
                out = {"path": await vm.create(
                    args.name, group, size=args.size)}
            elif args.verb == "rm":
                await vm.rm(args.name, group, force=args.force)
                out = None
            elif args.verb == "resize":
                out = await vm.resize(args.name, args.size, group,
                                      no_shrink=args.no_shrink)
            elif args.verb == "getpath":
                out = await vm.getpath(args.name, group)
            elif args.verb == "info":
                out = await vm.info(args.name, group)
            elif args.verb == "snapshot":
                if args.snap_verb == "create":
                    out = {"snapid": await vm.snapshot_create(
                        args.name, args.snap, group)}
                elif args.snap_verb == "rm":
                    await vm.snapshot_rm(args.name, args.snap, group)
                    out = None
                elif args.snap_verb == "clone":
                    out = {"path": await vm.snapshot_clone(
                        args.name, args.snap, args.target, group)}
                else:
                    out = await vm.snapshot_ls(args.name, group)
            else:
                out = await vm.ls(group)
        except FSError as e:
            print(f"Error: {e} (rc={e.rc})", file=sys.stderr)
            return 1
        if out is not None:
            _print(out, as_json)
        return 0
    finally:
        await fs.unmount()


async def _dispatch(args, rados: Rados) -> int:
    j = args.format == "json"
    cmd = args.cmd
    if cmd == "status":
        return await _mon(rados, "status", j, render=_render_status)
    if cmd == "health":
        detail = getattr(args, "detail", False)

        def render(d):
            lines = [d["status"]]
            for k, c in d["checks"].items():
                lines.append(f"  {k}: {c['message']}")
                if detail:
                    lines.extend(f"    {item}"
                                 for item in c.get("detail", ()))
            for k in d.get("muted", ()):
                lines.append(f"  (muted) {k}")
            return "\n".join(lines)

        return await _mon(rados, "health detail" if detail else "health",
                          j, render=render)
    if cmd == "log":
        if args.action == "last":
            return await _mon(
                rados, "log last", j, num=args.num,
                render=lambda es: "\n".join(
                    f"{e['seq']} {e['who']} [{e['level']}] {e['message']}"
                    for e in es),
            )
        return await _mon(rados, "log", j, message=args.message)
    if cmd == "df":
        return await _mon(rados, "df", j)
    if cmd == "balancer":
        return await _mon(rados, "balancer status", j)
    if cmd == "progress":
        return await _mon(rados, "progress", j)
    if cmd == "crash":
        if args.action == "ls":
            return await _mon(rados, "crash ls", j)
        if args.action == "info":
            return await _mon(rados, "crash info", j, id=args.id)
        if args.action == "archive":
            return await _mon(rados, "crash archive", j, id=args.id)
        if args.action == "rm":
            return await _mon(rados, "crash rm", j, id=args.id)
        return await _mon(rados, "crash post", j,
                          report=json.loads(args.report))
    if cmd == "config-key":
        if args.action == "set":
            return await _mon(rados, "config-key set", j,
                              key=args.key, value=args.value)
        if args.action == "get":
            return await _mon(rados, "config-key get", j, key=args.key)
        if args.action == "rm":
            return await _mon(rados, "config-key rm", j, key=args.key)
        return await _mon(rados, "config-key ls", j)
    if cmd == "insights":
        return await _mon(rados, "insights", j)
    if cmd == "fs":
        if args.action == "new":
            return await _mon(rados, "fs new", j, fs_name=args.fs_name,
                              metadata=args.metadata, data=args.data)
        if args.action == "rm":
            return await _mon(rados, "fs rm", j, fs_name=args.fs_name,
                              force=args.force)
        if args.action == "set_max_mds":
            return await _mon(rados, "fs set_max_mds", j,
                              fs_name=args.fs_name,
                              max_mds=args.max_mds)
        if args.action == "status":
            def render(d):
                lines = []
                for fsn, info in sorted(d.items()):
                    lines.append(f"{fsn} - max_mds {info['max_mds']}")
                    for rk in info["ranks"]:
                        lines.append(
                            f"  rank {rk['rank']}  {rk['name']:<12}"
                            f" {rk['state']:<12}"
                            f" load {rk['load']:g}")
                    if info["standbys"]:
                        lines.append("  standbys: "
                                     + ", ".join(info["standbys"]))
                    if info.get("down"):
                        lines.append("  DOWN: "
                                     + ", ".join(info["down"]))
                    lines.append(f"  pools: {info['meta_pool']} "
                                 f"(meta) / {info['data_pool']} "
                                 f"(data)")
                return "\n".join(lines)

            return await _mon(rados, "fs status", j, render=render)
        if args.action in ("subvolume", "subvolumegroup"):
            return await _fs_volumes(rados, args, j)
        if args.action == "quota":
            from ceph_tpu_torch.client.fs import CephFS, FSError

            fsc = await CephFS.connect(rados, args.fs_name)
            await fsc.mount()
            try:
                if args.verb == "set":
                    out = await fsc.setquota(
                        args.path, max_bytes=args.max_bytes,
                        max_files=args.max_files)
                else:
                    out = await fsc.getquota(args.path)
            except FSError as e:
                print(f"Error: {e} (rc={e.rc})", file=sys.stderr)
                return 1
            finally:
                await fsc.unmount()
            _print(out, j)
            return 0
        if args.action == "snap-schedule":
            if args.verb == "add":
                if args.period <= 0:
                    print("Error: --period must be positive",
                          file=sys.stderr)
                    return 1
                return await _mon(
                    rados, "config-key set", j,
                    key=f"snap_sched/{args.path.lstrip('/')}",
                    value=json.dumps({
                        "period": args.period, "retain": args.retain,
                        "fs": args.fs_name}))
            if args.verb == "rm":
                return await _mon(
                    rados, "config-key rm", j,
                    key=f"snap_sched/{args.path.lstrip('/')}")
            if args.verb == "status":
                return await _mon(rados, "snap-schedule status", j)
            r = await rados.mon_command("config-key ls")
            if r["rc"] != 0:
                print(f"Error: {r['outs']} (rc={r['rc']})",
                      file=sys.stderr)
                return 1
            _print(sorted("/" + k[len("snap_sched/"):]
                          for k in r["data"]
                          if k.startswith("snap_sched/")), j)
            return 0
        return await _mon(rados, "fs ls", j)
    if cmd == "mds":
        return await _mon(rados, "mds stat", j)
    if cmd == "device":
        return await _mon(rados, "device ls", j)
    if cmd == "orch":
        if args.action == "ls":
            return await _mon(rados, "orch ls", j)
        if args.action == "ps":
            return await _mon(rados, "orch ps", j)
        if args.action == "host":
            return await _mon(rados, "orch host ls", j)
        if args.action == "status":
            return await _mon(rados, "orch status", j)
        if args.action == "apply":
            return await _mon(rados, "orch apply", j,
                              service_type=args.service_type,
                              count=args.count,
                              unmanaged=args.unmanaged)
        if args.action == "rm":
            return await _mon(rados, "orch rm", j,
                              service_type=args.service_type)
        if args.action == "daemon":
            return await _mon(rados, "orch daemon rm", j,
                              name=args.name)
    if cmd == "telemetry":
        return await _mon(rados, "telemetry show", j)
    if cmd == "quorum_status":
        return await _mon(rados, "quorum_status", j)
    if cmd == "mon":                      # mon dump
        return await _mon(rados, "mon dump", j)
    if cmd == "config":
        if args.action == "set":
            return await _mon(rados, "config set", j,
                              name=args.name, value=args.value)
        if args.action == "get":
            return await _mon(rados, "config get", j, name=args.name)
        if args.action == "rm":
            return await _mon(rados, "config rm", j, name=args.name)
        return await _mon(rados, "config dump", j)
    if cmd == "osd":
        return await _dispatch_osd(args, rados, j)
    if cmd == "rados":
        return await _dispatch_rados(args, rados, j)
    if cmd == "pg":
        if args.action == "stat":
            return await _mon(rados, "pg stat", j)
        # `ceph pg scrub|repair <pool>/<ps>`
        pool_name, _, ps_str = str(args.pgid).partition("/")
        m = rados.monc.osdmap
        pool = next((p for p in m.pools.values()
                     if p.name == pool_name), None)
        if pool is None:
            print(f"no pool {pool_name!r}", file=sys.stderr)
            return 2
        try:
            ps = int(ps_str)
        except ValueError:
            print(f"bad pgid {args.pgid!r} (want pool/ps)",
                  file=sys.stderr)
            return 2
        try:
            report = await rados.pg_scrub(
                pool.pool_id, ps, repair=args.action == "repair"
            )
        except RadosError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if "error" in report:
            print(f"Error: {report['error']}", file=sys.stderr)
            return 1
        _print(report, True)
        return 0 if not report.get("errors") else 1
    if cmd == "top":
        return await _run_top(args, rados, j)
    if cmd == "trace":
        # `ceph trace collect <trace_id>`: fan dump_traces across the
        # mon and every up OSD, dedupe by span id, and print ONE
        # reassembled parent-linked tree — the cluster-wide view of a
        # sampled op (the zipkin-collector role, served by the CLI)
        from ceph_tpu_torch.common.tracing import assemble_tree
        spans: list[dict] = []
        try:
            r = await rados.mon_command("dump_traces",
                                        trace_id=args.trace_id)
            if r.get("rc") == 0:
                spans.extend((r.get("data") or {}).get("spans", []))
        except (RadosError, ConnectionError, asyncio.TimeoutError):
            pass
        m = rados.monc.osdmap
        for osd, info in sorted((m.osds if m is not None else {})
                                .items()):
            if not info.up:
                continue
            try:
                reply = await rados.osd_daemon_command(
                    osd, "dump_traces", trace_id=args.trace_id)
            except (RadosError, asyncio.TimeoutError):
                continue
            spans.extend(reply.get("spans", []))
        seen: dict = {}
        for s in spans:
            seen.setdefault(str(s.get("span_id")), s)
        tree = assemble_tree(list(seen.values()))
        _print({"trace_id": args.trace_id, "num_spans": len(seen),
                "spans": tree}, True)
        return 0 if tree else 1
    if cmd == "daemon":
        if "/" in str(args.target):
            # `ceph daemon <path/to.asok> <cmd>`: direct unix socket
            from ceph_tpu_torch.common.admin_socket import admin_command
            cmd_map = {"perf": "perf dump"}
            # bare tokens extend the command ("scrub start" typed
            # unquoted); key=value tokens become arguments
            words = [args.daemon_cmd]
            kw = {}
            for tok in args.kv:
                if "=" in tok:
                    k, _, v = tok.partition("=")
                    kw[k] = v
                else:
                    words.append(tok)
            prefix = " ".join(words)
            try:
                out = await admin_command(
                    args.target, cmd_map.get(prefix, prefix), **kw
                )
            except ValueError as e:
                print(f"bad daemon arguments: {e}", file=sys.stderr)
                return 2
            _print(out, True)
            return 0 if not (isinstance(out, dict)
                             and "error" in out) else 1
        # `ceph daemon osd.N <cmd>`: the same surface over the messenger
        kind, _, rest = str(args.target).partition(".")
        try:
            osd_id = int(rest)
        except ValueError:
            osd_id = -1
        if kind != "osd" or osd_id < 0:
            print(f"bad daemon target {args.target!r} (want osd.N)",
                  file=sys.stderr)
            return 2
        if args.kv:
            print("daemon arguments are only supported for .asok "
                  "targets", file=sys.stderr)
            return 2
        if args.daemon_cmd not in ("perf", "dump_ops_in_flight",
                                   "dump_historic_ops",
                                   "dump_historic_slow_ops"):
            print(f"unsupported daemon command {args.daemon_cmd!r} "
                  "over the messenger (use an .asok path for the full "
                  "surface)", file=sys.stderr)
            return 2
        msg_type = ("perf_dump" if args.daemon_cmd == "perf"
                    else "dump_ops")
        try:
            reply = await rados.osd_daemon_command(osd_id, msg_type)
        except RadosError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if args.daemon_cmd == "perf":
            out = reply["counters"]
        elif args.daemon_cmd == "dump_historic_ops":
            out = reply["historic"]
        elif args.daemon_cmd == "dump_historic_slow_ops":
            out = reply["historic_slow"]
        else:
            out = reply["in_flight"]
        _print(out, True)
        return 0
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


async def _dispatch_osd(args, rados: Rados, j: bool) -> int:
    a = args.action
    if a == "tree":
        return await _mon(rados, "osd tree", j, render=_render_tree)
    if a == "dump":
        return await _mon(rados, "osd dump", j)
    if a == "stat":
        return await _mon(rados, "osd stat", j)
    if a == "df":
        def render(d):
            lines = ["ID  STATE IN  WEIGHT   USED"]
            for r in d["nodes"]:
                lines.append(
                    f"{r['id']:<3} {'up' if r['up'] else 'down':<5} "
                    f"{'in' if r['in'] else 'out':<3} "
                    f"{r['weight']:<8g} {r['bytes_used']}")
            lines.append(f"TOTAL used {d['total_bytes_used']}")
            return "\n".join(lines)

        return await _mon(rados, "osd df", j, render=render)
    if a in ("out", "in", "down"):
        return await _mon(rados, f"osd {a}", j, ids=args.ids)
    if a in ("set", "unset"):
        return await _mon(rados, f"osd {a}", j, flag=args.flag)
    if a == "blocklist":
        if args.bl_action == "ls":
            def render(d):
                rows = [f"{k}  expires {v:.0f}"
                        for k, v in sorted(d["blocklist"].items())]
                return "\n".join(rows) or "(empty)"
            return await _mon(rados, "osd blocklist ls", j,
                              render=render)
        return await _mon(rados, "osd blocklist", j,
                          action=args.bl_action, entity=args.entity,
                          expire=args.expire)
    if a == "getcrushmap":
        return await _mon(rados, "osd getcrushmap", j,
                          render=lambda text: text)
    if a == "setcrushmap":
        text = (sys.stdin.read() if args.file == "-"
                else open(args.file).read())
        return await _mon(rados, "osd setcrushmap", j, map=text)
    if a == "tier":
        sub = args.sub
        if sub == "add":
            return await _mon(rados, "osd tier add", j,
                              pool=args.pool, tierpool=args.tierpool)
        if sub == "remove":
            return await _mon(rados, "osd tier remove", j,
                              pool=args.pool, tierpool=args.tierpool)
        if sub == "cache-mode":
            return await _mon(rados, "osd tier cache-mode", j,
                              pool=args.pool, mode=args.mode)
        if sub == "set-overlay":
            return await _mon(rados, "osd tier set-overlay", j,
                              pool=args.pool,
                              overlaypool=args.tierpool)
        return await _mon(rados, "osd tier remove-overlay", j,
                          pool=args.pool)
    if a == "pool":
        sub = args.sub
        if sub == "create":
            kw = {"pool": args.pool, "pg_num": args.pg_num}
            if args.pool_type:
                kw["pool_type"] = args.pool_type
            if args.profile:
                kw["erasure_code_profile"] = args.profile
            if args.size:
                kw["size"] = args.size
            return await _mon(rados, "osd pool create", j, **kw)
        if sub == "ls":
            return await _mon(rados, "osd pool ls", j,
                              render=lambda d: "\n".join(d))
        if sub == "delete":
            return await _mon(rados, "osd pool delete", j, pool=args.pool)
        if sub == "set-quota":
            return await _mon(rados, "osd pool set-quota", j,
                              pool=args.pool, field=args.field,
                              value=args.value)
        if sub == "get-quota":
            def render(d):
                return (f"quotas for pool '{d['pool']}':\n"
                        f"  max bytes  : {d['quota_max_bytes'] or 'N/A'}\n"
                        f"  max objects: {d['quota_max_objects'] or 'N/A'}"
                        + ("\n  FULL (writes blocked)" if d["full"]
                           else ""))
            return await _mon(rados, "osd pool get-quota", j,
                              pool=args.pool, render=render)
        if sub == "autoscale-status":
            def render(d):
                if not d:
                    return "all pools within autoscale targets"
                lines = [f"{'POOL':<20}{'PG_NUM':>8}{'IDEAL':>8}"
                         f"{'STATE':>8}"]
                for name, r in sorted(d.items()):
                    lines.append(f"{name:<20}{r['pg_num']:>8}"
                                 f"{r['ideal']:>8}{r['kind']:>8}")
                return "\n".join(lines)

            return await _mon(rados, "osd pool autoscale-status", j,
                              render=render)
        if sub == "get":
            return await _mon(rados, "osd pool get", j, pool=args.pool)
        if sub == "set":
            return await _mon(rados, "osd pool set", j, pool=args.pool,
                              var=args.var, val=args.val)
    if a == "erasure-code-profile":
        sub = args.sub
        if sub == "set":
            profile = dict(kv.split("=", 1) for kv in args.kv)
            return await _mon(rados, "osd erasure-code-profile set", j,
                              name=args.name, profile=profile)
        if sub == "get":
            return await _mon(rados, "osd erasure-code-profile get", j,
                              name=args.name)
        if sub == "ls":
            return await _mon(rados, "osd erasure-code-profile ls", j,
                              render=lambda d: "\n".join(d))
        if sub == "rm":
            return await _mon(rados, "osd erasure-code-profile rm", j,
                              name=args.name)
    print(f"unknown osd action {a!r}", file=sys.stderr)
    return 2


async def _rados_export(io, path: str) -> int:
    """`rados export`: archive every object's data + xattrs + omap as
    one framed stream (reference src/tools/rados PoolDump).  Wire
    format: 4-byte LE length + encoded {oid, data, xattrs, omap} per
    object, so import replays in one pass without loading the pool
    into memory."""
    import struct as _struct
    from ceph_tpu_torch.msg.codec import encode as _enc
    out = sys.stdout.buffer if path == "-" else open(path, "wb")
    n = 0
    try:
        for oid in sorted(await io.list_objects()):
            data = await io.read(oid)
            xattrs = await io.get_xattrs(oid)
            omap = await io.get_omap(oid)
            rec = _enc({"oid": oid, "data": data,
                        "xattrs": dict(xattrs), "omap": dict(omap)})
            out.write(_struct.pack("<I", len(rec)) + rec)
            n += 1
    finally:
        if path != "-":
            out.close()
    return n


async def _rados_import(io, path: str) -> int:
    """`rados import`: replay an export archive.  Existing objects
    are overwritten whole (data, xattrs and omap all become the
    archived state) — the reference's default as well."""
    import struct as _struct
    from ceph_tpu_torch.client.rados import ObjectOperation, RadosError
    from ceph_tpu_torch.msg.codec import decode as _dec
    src = sys.stdin.buffer if path == "-" else open(path, "rb")
    n = 0
    try:
        while True:
            hdr = src.read(4)
            if not hdr:
                break
            if len(hdr) < 4:
                raise ValueError("truncated archive header")
            (ln,) = _struct.unpack("<I", hdr)
            raw = src.read(ln)
            if len(raw) < ln:
                raise ValueError("truncated archive record")
            rec = _dec(raw)
            try:
                # drop first: surviving extra omap keys / xattrs on
                # an existing object would make "restore" a merge
                await io.remove(str(rec["oid"]))
            except RadosError as e:
                if e.rc != -2:
                    raise
            op = ObjectOperation().create() \
                .write_full(rec.get("data") or b"")
            for k, v in (rec.get("xattrs") or {}).items():
                op = op.set_xattr(k, v)
            omap = rec.get("omap") or {}
            if omap:
                op = op.omap_set(omap)
            await io.operate(str(rec["oid"]), op)
            n += 1
    finally:
        if path != "-":
            src.close()
    return n


async def _rados_bench(io, args) -> dict:
    """`rados bench` (reference src/common/obj_bencher.cc): timed
    write or sequential-read workload with concurrency, reporting
    throughput, IOPS, and latency percentiles."""
    import time as _time

    import math
    import secrets as _secrets

    payload = b"\xa5" * args.block_size
    seconds = args.seconds
    concurrency = args.concurrency
    lat: list[float] = []
    done = 0
    total_bytes = 0
    # run-scoped prefix: cleanup must only touch THIS run's objects,
    # never a prior --no-cleanup run's seq dataset
    run_prefix = f"bench_{_secrets.token_hex(4)}_"
    stop_at = _time.monotonic() + seconds

    if args.mode == "seq":
        names = sorted(o for o in await io.list_objects()
                       if o.startswith("bench_"))
        if not names:
            raise RadosError(-2, "no bench_ objects; run write "
                                 "with --no-cleanup first")

    async def worker(wid: int):
        nonlocal done, total_bytes
        i = 0
        while _time.monotonic() < stop_at:
            t0 = _time.monotonic()
            if args.mode == "write":
                await io.write_full(f"{run_prefix}{wid}_{i}", payload)
                nbytes = len(payload)
            else:
                nbytes = len(await io.read(
                    names[(wid + i) % len(names)]
                ))
            lat.append(_time.monotonic() - t0)
            done += 1
            total_bytes += nbytes
            i += 1

    t0 = _time.monotonic()
    await asyncio.gather(*(worker(w) for w in range(concurrency)))
    elapsed = _time.monotonic() - t0
    if args.mode == "write" and not args.no_cleanup:
        for o in await io.list_objects():
            if o.startswith(run_prefix):
                await io.remove(o)
    lat.sort()

    def pct(p: float) -> float:
        """Nearest-rank percentile (ceil(p*n)-1)."""
        if not lat:
            return 0.0
        return lat[max(0, math.ceil(p * len(lat)) - 1)]

    return {
        "mode": args.mode,
        "seconds": round(elapsed, 3),
        "ops": done,
        "block_size": args.block_size,
        "concurrency": concurrency,
        "iops": round(done / elapsed, 2) if elapsed else 0.0,
        "MBps": round(total_bytes / elapsed / 2**20, 3)
        if elapsed else 0.0,
        "lat_ms": {
            "avg": round(sum(lat) / len(lat) * 1e3, 3) if lat else 0,
            "p50": round(pct(0.50) * 1e3, 3),
            "p95": round(pct(0.95) * 1e3, 3),
            "p99": round(pct(0.99) * 1e3, 3),
            "max": round((lat[-1] if lat else 0) * 1e3, 3),
        },
    }


async def _dispatch_rados(args, rados: Rados, j: bool) -> int:
    try:
        io = await rados.open_ioctx(args.pool)
        a = args.action
        if a == "bench":
            report = await _rados_bench(io, args)
            _print(report, True)
            return 0
        if a == "export":
            n = await _rados_export(io, args.file)
            print(f"exported {n} objects", file=sys.stderr)
            return 0
        if a == "import":
            n = await _rados_import(io, args.file)
            print(f"imported {n} objects", file=sys.stderr)
            return 0
        if a == "put":
            data = (sys.stdin.buffer.read() if args.file == "-"
                    else open(args.file, "rb").read())
            await io.write_full(args.obj, data)
            print(f"wrote {len(data)} bytes to {args.obj}")
        elif a == "get":
            data = await io.read(args.obj)
            if args.file == "-":
                sys.stdout.buffer.write(data)
            else:
                with open(args.file, "wb") as f:
                    f.write(data)
        elif a == "ls":
            for name in await io.list_objects():
                print(name)
        elif a == "rm":
            await io.remove(args.obj)
        elif a == "stat":
            _print(await io.stat(args.obj), j)
        elif a == "listomapkeys":
            for k in sorted(await io.get_omap(args.obj)):
                print(k)
        elif a == "getomapval":
            kv = await io.get_omap(args.obj, [args.key])
            if args.key not in kv:
                print(f"no key {args.key!r}", file=sys.stderr)
                return 1
            sys.stdout.buffer.write(kv[args.key])
        elif a == "setomapval":
            await io.set_omap(args.obj,
                              {args.key: args.value.encode()})
        elif a == "rmomapkey":
            await io.rm_omap_keys(args.obj, [args.key])
        elif a == "listxattr":
            for k in sorted(await io.get_xattrs(args.obj)):
                print(k)
        elif a == "getxattr":
            sys.stdout.buffer.write(
                await io.get_xattr(args.obj, args.key))
        elif a == "setxattr":
            await io.set_xattr(args.obj, args.key,
                               args.value.encode())
        else:
            print(f"unknown rados action {a!r}", file=sys.stderr)
            return 2
        return 0
    except RadosError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ceph-tpu")
    p.add_argument("--conf", default="cluster.json",
                   help="cluster conf file (DevCluster.write_conf)")
    p.add_argument("--format", choices=["plain", "json"], default="plain")
    p.add_argument("--timeout", type=float, default=15.0)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    health = sub.add_parser("health")
    health.add_argument("--detail", action="store_true")
    sub.add_parser("quorum_status")
    sub.add_parser("mon")
    sub.add_parser("df")
    sub.add_parser("balancer")
    sub.add_parser("progress")
    crash = sub.add_parser("crash")
    crash_sub = crash.add_subparsers(dest="action", required=True)
    crash_sub.add_parser("ls")
    for name in ("info", "archive", "rm"):
        c = crash_sub.add_parser(name)
        c.add_argument("id")
    cp = crash_sub.add_parser("post")
    cp.add_argument("report", help="crash report JSON")
    ck = sub.add_parser("config-key")
    ck_sub = ck.add_subparsers(dest="action", required=True)
    cks = ck_sub.add_parser("set")
    cks.add_argument("key")
    cks.add_argument("value")
    for name in ("get", "rm"):
        c = ck_sub.add_parser(name)
        c.add_argument("key")
    ck_sub.add_parser("ls")
    fs = sub.add_parser("fs")
    fs_sub = fs.add_subparsers(dest="action", required=True)
    fs_sub.add_parser("ls")
    fs_sub.add_parser("status")
    fn = fs_sub.add_parser("new")
    fn.add_argument("fs_name")
    fn.add_argument("metadata")
    fn.add_argument("data")
    fr = fs_sub.add_parser("rm")
    fr.add_argument("fs_name")
    fr.add_argument("--force", action="store_true")
    fm = fs_sub.add_parser("set_max_mds")
    fm.add_argument("fs_name")
    fm.add_argument("max_mds", type=int)
    sv = fs_sub.add_parser("subvolume")
    sv_sub = sv.add_subparsers(dest="verb", required=True)
    svc = sv_sub.add_parser("create")
    svc.add_argument("name")
    svc.add_argument("--size", type=int, default=0)
    svr = sv_sub.add_parser("rm")
    svr.add_argument("name")
    svr.add_argument("--force", action="store_true")
    svz = sv_sub.add_parser("resize")
    svz.add_argument("name")
    svz.add_argument("size", type=int)
    svz.add_argument("--no-shrink", action="store_true")
    sv_sub.add_parser("ls")
    for vname in ("getpath", "info"):
        x = sv_sub.add_parser(vname)
        x.add_argument("name")
    svs = sv_sub.add_parser("snapshot")
    svs.add_argument("snap_verb",
                     choices=["create", "rm", "ls", "clone"])
    svs.add_argument("name")
    svs.add_argument("snap", nargs="?", default="")
    svs.add_argument("target", nargs="?", default="")
    for sp_ in (svc, svr, svz, *[sv_sub.choices[v]
                            for v in ("ls", "getpath", "info")], svs):
        sp_.add_argument("--group", default=None)
        sp_.add_argument("--fs-name", dest="fs_name",
                         default="cephfs")
    svg = fs_sub.add_parser("subvolumegroup")
    svg.add_argument("verb", choices=["create", "rm", "ls"])
    svg.add_argument("name", nargs="?", default="")
    svg.add_argument("--fs-name", dest="fs_name", default="cephfs")
    fq = fs_sub.add_parser("quota")
    fq_sub = fq.add_subparsers(dest="verb", required=True)
    fqs = fq_sub.add_parser("set")
    fqs.add_argument("path")
    fqs.add_argument("--max-bytes", type=int, default=0)
    fqs.add_argument("--max-files", type=int, default=0)
    fqg = fq_sub.add_parser("get")
    fqg.add_argument("path")
    for sp_ in (fqs, fqg):
        sp_.add_argument("--fs-name", dest="fs_name",
                         default="cephfs")
    ssch = fs_sub.add_parser("snap-schedule")
    ssch_sub = ssch.add_subparsers(dest="verb", required=True)
    ssa = ssch_sub.add_parser("add")
    ssa.add_argument("path")
    ssa.add_argument("--period", type=float, required=True)
    ssa.add_argument("--retain", type=int, default=0)
    ssa.add_argument("--fs-name", dest="fs_name", default="cephfs")
    ssr = ssch_sub.add_parser("rm")
    ssr.add_argument("path")
    ssch_sub.add_parser("ls")
    ssch_sub.add_parser("status")

    ins = sub.add_parser("insights")
    ins.add_argument("action", nargs="?", default="report")
    mds = sub.add_parser("mds")
    mds.add_argument("action", choices=["stat"])
    dev = sub.add_parser("device")
    dev.add_argument("action", choices=["ls"])
    orch = sub.add_parser("orch")
    orch_sub = orch.add_subparsers(dest="action", required=True)
    orch_sub.add_parser("ls")
    orch_sub.add_parser("ps")
    orch_sub.add_parser("status")
    oh = orch_sub.add_parser("host")
    oh.add_argument("host_action", choices=["ls"])
    oa = orch_sub.add_parser("apply")
    oa.add_argument("service_type", choices=["osd", "mds", "rgw"])
    oa.add_argument("count", type=int)
    oa.add_argument("--unmanaged", action="store_true")
    orm = orch_sub.add_parser("rm")
    orm.add_argument("service_type")
    od = orch_sub.add_parser("daemon")
    od.add_argument("daemon_action", choices=["rm"])
    od.add_argument("name")
    tel = sub.add_parser("telemetry")
    tel.add_argument("action", choices=["show"])
    logp = sub.add_parser("log")
    log_sub = logp.add_subparsers(dest="action", required=True)
    ll = log_sub.add_parser("last")
    ll.add_argument("num", type=int, nargs="?", default=20)
    li = log_sub.add_parser("add")
    li.add_argument("message")

    conf = sub.add_parser("config")
    conf_sub = conf.add_subparsers(dest="action", required=True)
    cs = conf_sub.add_parser("set")
    cs.add_argument("name")
    cs.add_argument("value")
    for name in ("get", "rm"):
        c = conf_sub.add_parser(name)
        c.add_argument("name")
    conf_sub.add_parser("dump")

    pg = sub.add_parser("pg")
    pg.add_argument("action", choices=["scrub", "repair", "stat"])
    pg.add_argument("pgid", nargs="?", help="<pool>/<ps>")

    trace = sub.add_parser("trace")
    trace.add_argument("action", choices=["collect"])
    trace.add_argument("trace_id", help="trace id from a span dump "
                       "or a slow-op record")

    top = sub.add_parser("top")
    top.add_argument("--kernels", action="store_true",
                     help="show the per-signature device kernel table")
    top.add_argument("--once", action="store_true",
                     help="render one frame and exit (headless/CI)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="refresh interval seconds (default 2)")
    top.add_argument("--iterations", type=int, default=0,
                     help="stop after N frames (0 = until ^C)")

    forn = sub.add_parser("forensics")
    forn_sub = forn.add_subparsers(dest="action", required=True)
    fls = forn_sub.add_parser("ls")
    fls.add_argument("--dir", default="",
                     help="bundle dir (default <tmp>/ceph_tpu_forensics)")
    fsh = forn_sub.add_parser("show")
    fsh.add_argument("bundle_id")
    fsh.add_argument("--dir", default="",
                     help="bundle dir (default <tmp>/ceph_tpu_forensics)")
    fsh.add_argument("--limit", type=int, default=None,
                     help="render only the last N timeline events")

    daemon = sub.add_parser("daemon")
    daemon.add_argument("target", help="osd.N, or a path to an .asok")
    daemon.add_argument(
        "daemon_cmd",
        help="dump_ops_in_flight | dump_historic_ops | "
             "dump_historic_slow_ops | perf | "
             "(any registered admin-socket command for .asok targets)",
    )
    daemon.add_argument("kv", nargs="*", metavar="key=value",
                        help="command arguments (.asok targets)")

    osd = sub.add_parser("osd")
    osd_sub = osd.add_subparsers(dest="action", required=True)
    for name in ("tree", "dump", "stat", "df"):
        osd_sub.add_parser(name)
    for name in ("out", "in", "down"):
        o = osd_sub.add_parser(name)
        o.add_argument("ids", type=int, nargs="+")
    for name in ("set", "unset"):
        o = osd_sub.add_parser(name)
        o.add_argument("flag")
    bl = osd_sub.add_parser("blocklist")
    bl.add_argument("bl_action", choices=["add", "rm", "ls"])
    bl.add_argument("entity", nargs="?", default="",
                    help="client instance 'entity:nonce' or bare entity")
    bl.add_argument("--expire", type=float, default=3600.0,
                    help="seconds until the entry lapses (add)")
    osd_sub.add_parser("getcrushmap")
    scm = osd_sub.add_parser("setcrushmap")
    scm.add_argument("file", nargs="?", default="-",
                     help="compiled map text ('-' = stdin)")
    tier = osd_sub.add_parser("tier")
    tier_sub = tier.add_subparsers(dest="sub", required=True)
    for name in ("add", "remove"):
        t = tier_sub.add_parser(name)
        t.add_argument("pool")
        t.add_argument("tierpool")
    tcm = tier_sub.add_parser("cache-mode")
    tcm.add_argument("pool")
    tcm.add_argument("mode", choices=["none", "writeback", "readonly"])
    tso = tier_sub.add_parser("set-overlay")
    tso.add_argument("pool")
    tso.add_argument("tierpool")
    tro = tier_sub.add_parser("remove-overlay")
    tro.add_argument("pool")
    pool = osd_sub.add_parser("pool")
    pool_sub = pool.add_subparsers(dest="sub", required=True)
    pc = pool_sub.add_parser("create")
    pc.add_argument("pool")
    pc.add_argument("--pg-num", type=int, default=32, dest="pg_num")
    pc.add_argument("--pool-type", default="", dest="pool_type")
    pc.add_argument("--profile", default="")
    pc.add_argument("--size", type=int, default=0)
    pool_sub.add_parser("ls")
    pool_sub.add_parser("autoscale-status")
    for name in ("delete", "get"):
        pp = pool_sub.add_parser(name)
        pp.add_argument("pool")
    ps = pool_sub.add_parser("set")
    ps.add_argument("pool")
    ps.add_argument("var")
    ps.add_argument("val")
    pq = pool_sub.add_parser("set-quota")
    pq.add_argument("pool")
    pq.add_argument("field", choices=["max_bytes", "max_objects"])
    pq.add_argument("value", type=int)
    gq = pool_sub.add_parser("get-quota")
    gq.add_argument("pool")
    prof = osd_sub.add_parser("erasure-code-profile")
    prof_sub = prof.add_subparsers(dest="sub", required=True)
    pfs = prof_sub.add_parser("set")
    pfs.add_argument("name")
    pfs.add_argument("kv", nargs="*", help="k=v pairs")
    for name in ("get", "rm"):
        pf = prof_sub.add_parser(name)
        pf.add_argument("name")
    prof_sub.add_parser("ls")

    rados_p = sub.add_parser("rados")
    rados_p.add_argument("-p", "--pool", required=True)
    rados_sub = rados_p.add_subparsers(dest="action", required=True)
    for name in ("put", "get"):
        r = rados_sub.add_parser(name)
        r.add_argument("obj")
        r.add_argument("file")
    rados_sub.add_parser("ls")
    for name in ("listomapkeys", "listxattr"):
        r = rados_sub.add_parser(name)
        r.add_argument("obj")
    for name in ("getomapval", "getxattr", "rmomapkey"):
        r = rados_sub.add_parser(name)
        r.add_argument("obj")
        r.add_argument("key")
    for name in ("setomapval", "setxattr"):
        r = rados_sub.add_parser(name)
        r.add_argument("obj")
        r.add_argument("key")
        r.add_argument("value")
    for name in ("export", "import"):
        r = rados_sub.add_parser(name)
        r.add_argument("file", help="archive path ('-' = stdout/in)")
    bench = rados_sub.add_parser("bench")
    bench.add_argument("seconds", type=int)
    bench.add_argument("mode", choices=["write", "seq"])
    bench.add_argument("-b", "--block-size", type=int,
                       default=4 << 20)
    bench.add_argument("-t", "--concurrency", type=int, default=16)
    bench.add_argument("--no-cleanup", action="store_true")
    rm = rados_sub.add_parser("rm")
    rm.add_argument("obj")
    st = rados_sub.add_parser("stat")
    st.add_argument("obj")
    return p


def _note_time_base(lines: list[str], recs) -> None:
    """Say which clock the GiB/s and roofline shares above read: the
    card's (CUDA events, ``time_base`` "device") or the host's around
    each launch."""
    bases = sorted({rec.get("time_base", "host") for rec in recs})
    if bases:
        lines.append(f"    time base: {', '.join(bases)}")


def _render_top(d: dict, kernels: bool) -> str:
    """One `ceph-tpu top` frame from the ``ts status`` rollup: SLO
    verdicts, tenant-class burn pairs, utilization rates, defense
    plane, collect accounting, tracer health, and (``--kernels``) the
    per-signature device kernel table."""
    lines: list[str] = []
    slo = d.get("slo") or {}
    util = d.get("utilization") or {}
    qos = d.get("qos") or {}
    ts = d.get("tsdb") or {}
    checks = d.get("health_checks") or {}
    viol = checks.get("SLO_VIOLATION")
    lines.append("ceph-tpu top — "
                 + (f"SLO_VIOLATION: {viol.get('message', '')}"
                    if viol else "cluster within SLO"))
    objectives = slo.get("objectives") or []
    if objectives:
        lines.append("  objectives:")
        for rec in objectives:
            val = rec.get("value")
            val_s = "n/a" if val is None \
                else f"{val:.4g}{rec.get('unit', '')}"
            mark = " VIOLATING" if rec.get("violating") else ""
            lines.append(
                f"    {rec.get('objective'):<22} {val_s:>12}  "
                f"target {rec.get('target'):g}{rec.get('unit', '')}  "
                f"burn {rec.get('burn_rate', 0.0):.2f}x{mark}")
    classes = slo.get("classes") or {}
    if classes:
        lines.append("  tenant classes (5m/1h burn):")
        for cls, rec in sorted(classes.items()):
            mark = " VIOLATING" if rec.get("violating") else ""
            lines.append(
                f"    {cls:<22} fast {rec.get('fast_burn', 0.0):6.2f}x"
                f"  slow {rec.get('slow_burn', 0.0):6.2f}x{mark}")
    if util:
        lines.append(
            "  device: "
            f"{util.get('device_gibps', 0.0):g} GiB/s "
            f"({util.get('roofline_pct', 0.0):g}% of roofline)  "
            f"occupancy {util.get('coalesce_occupancy', 0.0):g}  "
            f"resident hit {util.get('resident_hit_rate', 0.0):g}")
        _note_time_base(lines, [util])
        lines.append(
            "  rebuild: "
            f"{util.get('rebuild_gibps', 0.0):g} GiB/s   client p99 "
            f"{util.get('client_p99_ms', 0.0):g} ms  p999 "
            f"{util.get('client_p999_ms', 0.0):g} ms")
    if qos:
        lines.append(
            f"  qos: {'BURNING' if qos.get('burning') else 'idle'} "
            f"(burn {qos.get('burn', 0.0):g}x)")
    coll = ts.get("collect") or {}
    if coll:
        lines.append(
            "  collect: "
            f"{'delta' if coll.get('delta') else 'full'} mode, "
            f"{coll.get('last_payload_bytes', 0)} B last cycle, "
            f"{coll.get('resyncs', 0)} resyncs over "
            f"{coll.get('cycles', 0)} cycles")
    tracer = ts.get("tracer") or {}
    if tracer:
        rate = float(tracer.get("eviction_rate", 0.0))
        line = (f"  tracer: {tracer.get('ring_evictions', 0)} ring "
                f"evictions ({rate:g}/s), "
                f"{tracer.get('orphan_spans', 0)} orphan spans")
        if rate > 0:
            line += ("   WARNING: span rings are evicting — traces "
                     "are being lost; raise tracer_ring_size")
        lines.append(line)
    st = ts.get("stats") or {}
    if st:
        lines.append(
            f"  tsdb: {st.get('series', 0)} series, "
            f"{st.get('points', 0)} points, "
            f"{st.get('evictions', 0)} evictions")
    if kernels:
        ktab = ts.get("kernels") or {}
        lines.append("  kernels (per codec signature):")
        if not ktab:
            lines.append("    (no device launches recorded)")
        _note_time_base(lines, ktab.values())
        for sig, rec in sorted(ktab.items()):
            lines.append(
                f"    {sig:<28} {rec.get('launches', 0):>7} launches  "
                f"{rec.get('stripes', 0):>8} stripes  "
                f"{rec.get('wall_us', 0.0) / 1e3:>9.1f} ms  "
                f"{rec.get('hbm_bytes', 0) / (1 << 20):>9.1f} MiB  "
                f"{rec.get('gibps', 0.0):>7.2f} GiB/s  "
                f"{rec.get('roofline_pct', 0.0):>5.1f}%")
    return "\n".join(lines)


async def _run_top(args, rados: Rados, as_json: bool) -> int:
    """`ceph-tpu top`: the live observability rollup, refreshed from
    the mon-persisted digest (works headless; --once for CI)."""
    frames = 0
    while True:
        r = await rados.mon_command("ts status")
        if r["rc"] != 0:
            print(f"Error: {r['outs']} (rc={r['rc']})",
                  file=sys.stderr)
            return 1
        data = r["data"] or {}
        if as_json:
            _print(data, True)
        else:
            print(_render_top(data, args.kernels), flush=True)
        frames += 1
        if args.once or (args.iterations and frames >= args.iterations):
            return 0
        await asyncio.sleep(max(0.1, args.interval))
        if not as_json:
            print()


def _run_forensics(args) -> int:
    """`ceph-tpu forensics ls|show`: offline flight-recorder reader.

    Bundles are plain JSON files the mgr persisted at capture time, so
    the forensic record stays readable after the cluster (or the whole
    process) is gone — no rados connection is attempted.
    """
    import os
    import tempfile

    from ceph_tpu_torch.common.events import render_timeline

    j = args.format == "json"
    d = args.dir or os.path.join(tempfile.gettempdir(),
                                 "ceph_tpu_forensics")
    if args.action == "ls":
        rows = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for fn in names:
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, fn)) as f:
                    b = json.load(f)
            except (OSError, ValueError):
                continue
            rows.append({"id": b.get("id", fn[:-5]),
                         "reason": b.get("reason", ""),
                         "captured_at": b.get("captured_at", 0),
                         "worst_daemon": b.get("worst_daemon", ""),
                         "events": len(b.get("timeline", [])),
                         "daemons": sorted(b.get("daemons", {}))})
        if j:
            _print({"bundles": rows}, True)
            return 0
        if not rows:
            print(f"(no forensic bundles under {d})")
            return 0
        for r in rows:
            print(f"{r['id']:<30} {r['reason']:<16} "
                  f"worst={r['worst_daemon'] or '-':<10} "
                  f"events={r['events']:<5} "
                  f"daemons={','.join(r['daemons'])}")
        return 0
    # show <bundle_id>
    path = os.path.join(d, f"{args.bundle_id}.json")
    try:
        with open(path) as f:
            b = json.load(f)
    except (OSError, ValueError):
        print(f"Error: no bundle {args.bundle_id!r} under {d}",
              file=sys.stderr)
        return 1
    if j:
        _print(b, True)
        return 0
    print(f"bundle {b.get('id')}  reason={b.get('reason')}  "
          f"worst_daemon={b.get('worst_daemon') or '-'}  "
          f"daemons={','.join(sorted(b.get('daemons', {})))}")
    print(render_timeline(b.get("timeline", []), limit=args.limit))
    # tsdb lead-up: the retention module attaches the last ten
    # minutes of burn rates / rebuild GiB/s / class histograms at
    # capture time — the trajectory INTO the violation
    tsc = (b.get("modules") or {}).get("ts") or {}
    series = tsc.get("series") or {}
    if series:
        print(f"lead-up ({tsc.get('window_s', 0):g}s of tsdb series "
              "before capture):")
        for name in sorted(series):
            pts = series[name].get("points") or []
            if not pts:
                continue
            vals = [p[1] for p in pts]
            print(f"  {name:<36} n={len(pts):<4} "
                  f"last={vals[-1]:<12g} min={min(vals):<12g} "
                  f"max={max(vals):g}")
    return 0


# offline tool passthrough: `ceph-tpu tool <name> ...` hands argv to
# the DR tool suite's own entry points.  These operate on STOPPED
# daemons' store directories, so no cluster connection is attempted —
# they must work precisely when the cluster is gone.
_TOOLS = {
    "monstore": "ceph_tpu_torch.tools.monstore_tool",
    "osdmap": "ceph_tpu_torch.tools.osdmaptool",
    "monmap": "ceph_tpu_torch.tools.monmaptool",
    "objectstore": "ceph_tpu_torch.objectstore_tool",
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["tool"]:
        if len(argv) < 2 or argv[1] not in _TOOLS:
            names = "|".join(sorted(_TOOLS))
            print(f"usage: ceph-tpu tool {{{names}}} ...",
                  file=sys.stderr)
            return 2
        import importlib

        return importlib.import_module(_TOOLS[argv[1]]).main(argv[2:])
    args = build_parser().parse_args(argv)
    if args.cmd == "forensics":
        return _run_forensics(args)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
