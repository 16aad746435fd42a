"""A cell cut to a size the CPU runs in seconds: 4 PGs a pool, 4
clients, small objects.  Same harness, same traffic modules."""

from __future__ import annotations

import copy

from portbench import run as bench


def small_spec(name: str) -> dict:
    spec = copy.deepcopy(bench.load_cell(name))
    for pool in spec["config"]["pools"]:
        pool["pg_num"] = 4
    p = spec["workload"]["params"]
    p["clients"] = 4
    if p.get("object_bytes", 0) > 1 << 20:
        p["object_bytes"] = 128 << 10
    if "names" in p:
        p["names"] = 32
    if p.get("preload_objects"):
        p["preload_objects"] = p["names"] = 12
    if "preload_objects" in spec["config"]:
        spec["config"]["preload_objects"] = 8
    for key in ("check_objects", "check_gets", "check_puts",
                "check_deleted", "check_reads"):
        if key in p:
            p[key] = min(p[key], 8)
    return spec


def run_small(name: str, seed: int = 2**31 + 7, seconds: float = 2.0,
              trace: bool = False):
    return bench.run_cell(small_spec(name), seed, seconds, trace,
                          device="cpu")
