"""One run of one cell: finds the cell's configuration, traffic mix,
driver, limits and per-layer metric readers by the names in
``BENCHMARK.json``, runs the driver, decides ``correct`` from the numbers
it compared against the cell's limits, and prints the result.

Everything that belongs to one configuration, mix or metric lives in a
file of its own: ``configs/<config>.json`` (which names its scene kind),
``scenes/<kind>.py``, ``traffic/<traffic>.json`` (which names its driver
kind), ``drivers/<kind>.py``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package (compared whole: the port's name starts with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyraytracing_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What a driver needs to run one cell once."""

    cell: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    rank: int = 0
    world: int = 1
    port: int = 0

    def elapsed(self) -> float:
        """Seconds since the process started the run."""
        return time.perf_counter() - self.t0


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The workload entry of ``name`` with its configuration, traffic mix
    and limits read from their files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    read = lambda p: json.loads((root / p).read_text())
    return dict(workload=w, config=read(conf["file"]),
                traffic=read(f"portbench/traffic/{w['traffic']}.json"),
                limits=read(f"portbench/limits/{name}.json"))


def metrics_for(bench: dict, section: str, cell: str) -> list[dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def driver(kind: str):
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def read_layer_metric(name: str, obs: dict):
    mod = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
    return mod.read(obs)


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit: every number
    present, finite and at most its limit; a number without a limit, or a
    limit without a number, fails."""
    out, ok = {}, set(checks) == set(limits)
    for k in sorted(set(checks) | set(limits)):
        v, lim = checks.get(k), limits.get(k)
        out[k] = {"value": v, "limit": lim}
        ok = ok and v is not None and lim is not None and math.isfinite(v) and v <= lim
    return ok, out


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(spec: dict, run: Run, bench: dict) -> dict:
    """Run the driver (rank 0's, where the cell has several devices) and
    assemble the result line."""
    out = driver(spec["traffic"]["driver"]).run(run)
    ok, checks = judge(out["checks"], spec["limits"])
    section = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, section, run.cell):
        value = (read_layer_metric(m["name"], out["obs"]) if run.trace
                 else out["e2e"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok and out.get("failed", 0) == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if run.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
