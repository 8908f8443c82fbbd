"""The lower-precision control of the benchmark's check, at a cell's size.

    python3 ccbench/control.py --workload <config>.<traffic> --seeds 1 2 3

For each seed: the runs and the parameter point a run of the benchmark
would check (the seed's first sweep), computed by the plain reference in
float32 and again in bfloat16 (the nearest precision below the float32
the configuration states), put in the program's place and held to the
same comparison.  Each line of output is one seed's compared numbers; the
control has to read above a limit on every seed.  The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(name: str, seed: int, *, device="cpu",
                     overrides=None) -> dict:
    import torch
    from ccbench.harness import cell as cell_mod
    from ccbench.harness import check
    cell = cell_mod.load(name, seed, overrides)
    runs = check.pick_runs(cell, cell.mix["check"]["runs"], cell.seed)
    scale = cell.scale(0)
    want = check.reference_result(cell, runs, scale, device=device)
    got = check.reference_result(cell, runs, scale, dtype=torch.bfloat16,
                                 device=device)
    return check.compare(check.reference_view(got, runs, cell),
                         check.reference_view(want, runs, cell))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from ccbench.harness import check
    for seed in args.seeds:
        t = time.perf_counter()
        got = control_readings(args.workload, seed, device="cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": check.LIMITS,
                          "fails": not check.verdict(got),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
