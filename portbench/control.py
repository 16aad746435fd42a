"""Run a cell with the control or a fault planted under its timed path
and print, per seed, every number compared beside its limit: the upper
readings the limits are set from.  The benchmark's own runs never run
this.

    python -m portbench.control --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--plant xor_parity|<fault>]
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import faults, run as bench


def main(argv=None) -> int:
    bench.cache_env()
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--plant", default="xor_parity",
                    choices=["none", "xor_parity", *faults.FAULTS])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_cell(args.workload)
    plant = {"none": None, "xor_parity": faults.xor_parity,
             **faults.FAULTS}[args.plant]
    for seed in (int(s) for s in args.seeds.split(",")):
        if plant is None:
            result, _ = bench.run_cell(spec, seed, args.seconds, False)
        else:
            with plant():
                result, _ = bench.run_cell(spec, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": result["correct"],
                          "metrics": result["metrics"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
