"""The control of a cell's correctness check: the plain reference computed
in bfloat16, the precision below the configurations' float32, put in the
program's place, and judged by the cell's own check and limits. A sound
limit makes every control run come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--units N]

It runs on the first CUDA device; the benchmark's own runs never run it.
Prints one JSON line per seed: the numbers, their limits and whether the
control passed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from core import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=6, help="buckets or passes to read")
    args = ap.parse_args(argv)
    bench = harness.load_bench()
    spec = harness.cell_spec(bench, args.workload)
    for seed in args.seeds:
        run = harness.Run(cell=args.workload, config=spec["config"], traffic=spec["traffic"],
                          chips=1, seed=seed, seconds=0.0, trace=False, device="cuda:0",
                          t0=time.perf_counter())
        t = time.perf_counter()
        checks = harness.driver(spec["traffic"]["driver"]).control(run, args.units)
        ok, judged = harness.judge(checks, spec["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "passed": ok,
                          "seconds": time.perf_counter() - t, "checks": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
