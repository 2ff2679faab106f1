"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; ``core/harness.py`` finds
the files that belong to each name. The run needs as many CUDA devices as
the cell asks for and exits with code 2, printing no result, without
them. Build and kernel caches stay in ``.portbench_cache/`` and the
port's own ``_build/`` inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    from core import harness

    bench = harness.load_bench(ROOT)
    spec = harness.cell_spec(bench, args.workload, ROOT)
    chips = int(spec["workload"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(cell=args.workload, config=spec["config"], traffic=spec["traffic"],
                      chips=chips, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda:0", t0=T0, world=chips)
    result = harness.execute(spec, run, bench)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: modules of the JAX stack were loaded: {bad}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
