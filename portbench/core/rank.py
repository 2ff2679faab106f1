"""A worker rank of a cell on several devices, started by rank 0's driver:

    python portbench/core/rank.py '<json of the Run's fields>'

It runs the same driver with its own rank and prints nothing on standard
output (rank 0 prints the result). Like rank 0, it exits with an error,
naming them on standard error, where modules of the JAX stack were loaded
in its process; rank 0 then fails the run."""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from core import harness  # noqa: E402

if __name__ == "__main__":
    fields = json.loads(sys.argv[1])
    run = harness.Run(**fields, t0=T0)
    harness.driver(run.traffic["driver"]).run(run)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: rank {run.rank}: modules of the JAX stack were loaded: {bad}",
              file=sys.stderr)
        sys.exit(3)
