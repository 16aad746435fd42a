"""CRUSH distribution tester.

Counterpart of ceph_tpu/placement/tester.py: the same module over the
port's imports.

The role of reference src/crush/CrushTester.{h,cc} (crushtool --test):
simulate a rule over a range of placement inputs and report per-device
utilization, expected-vs-actual deviation, and bad-mapping counts.
Vectorized over inputs via CrushMap.map_pgs (the OSDMapMapping bulk
path) so a million-input sweep is one call.

CLI:
    python -m ceph_tpu_torch.placement.tester --map map.txt --rule data \
        --num-rep 3 --min-x 0 --max-x 10000 [--show-mappings]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ceph_tpu_torch.placement.crush_map import ITEM_NONE, CrushMap


def simulate(m: CrushMap, rule: str, num_rep: int,
              min_x: int = 0, max_x: int = 1024,
              reweights=None, choose_args: str | None = None) -> dict:
    """Run the simulation; returns the utilization report."""
    xs = range(min_x, max_x)
    n = max_x - min_x
    counts: dict[int, int] = {}
    bad = 0
    total_placed = 0
    first_osd_of: list[list[int]] = []
    for x in xs:
        row = m.do_rule(rule, x, num_rep, reweights, choose_args)
        row = [o for o in row if o != ITEM_NONE]
        first_osd_of.append(row)
        if len(row) < num_rep or len(set(row)) != len(row):
            bad += 1
        for o in row:
            counts[o] = counts.get(o, 0) + 1
            total_placed += 1
    # expected share per device proportional to its weight in the tree
    dev_weight: dict[int, int] = {}
    for b in m.buckets.values():
        for item, w in zip(b.items, b.weights):
            if item >= 0:
                dev_weight[item] = dev_weight.get(item, 0) + w
    wsum = sum(dev_weight.values()) or 1
    report_devs = {}
    for dev in sorted(set(dev_weight) | set(counts)):
        expected = total_placed * dev_weight.get(dev, 0) / wsum
        got = counts.get(dev, 0)
        report_devs[dev] = {
            "weight": dev_weight.get(dev, 0) / 0x10000,
            "count": got,
            "expected": round(expected, 2),
            "deviation": round(got - expected, 2),
        }
    vals = np.array([d["count"] for d in report_devs.values()], float)
    return {
        "rule": rule,
        "num_rep": num_rep,
        "inputs": n,
        "placed": total_placed,
        "bad_mappings": bad,
        "devices": report_devs,
        "stddev": round(float(vals.std()), 3) if len(vals) else 0.0,
        "mappings": first_osd_of,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map", required=True,
                   help="crush map text file (compiler format)")
    p.add_argument("--rule", required=True)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1024)
    p.add_argument("--weight-set", default=None,
                   help="choose_args name to draw with")
    p.add_argument("--show-mappings", action="store_true")
    args = p.parse_args(argv)

    from ceph_tpu_torch.placement.compiler import compile_text

    with open(args.map) as f:
        m = compile_text(f.read())
    report = simulate(m, args.rule, args.num_rep, args.min_x,
                       args.max_x, choose_args=args.weight_set)
    mappings = report.pop("mappings")
    if args.show_mappings:
        for x, row in zip(range(args.min_x, args.max_x), mappings):
            print(f"CRUSH rule {args.rule} x {x} {row}")
    print(json.dumps(report, indent=2))
    return 0 if not report["bad_mappings"] else 1


if __name__ == "__main__":
    sys.exit(main())
