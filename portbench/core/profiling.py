"""The traced sub-window: ``torch.profiler`` around one bounded stretch of
the timed path, reduced in memory to the device's kernels, and the
arithmetic on them that the per-layer metrics and the result's
``device``/``breakdown`` share. Nothing is written to disk.

A render driver's traced unit (``obs["render_sub"]``: one bucket or one
pass) is read by ``iter_ms`` and ``kernels_roofline_pct``. The latter is
the share of the hand-written trace and scatter kernels' device time
(``csrc/trace.cu``, ``csrc/scatter_add.cu``; names in the device trace)
that the least time for their work would take on an H100 (3.35 TB/s of
HBM; the operations bound is far below). The work is counted from what
the harness sees at the entry point, the same whatever implements the
kernels, each byte once:

- each traced ray (closest hit and shadow, the program's count for the
  unit): its origin and direction read once (24 B) and a 4-byte result
  written once;
- each trace launch: the scene's triangle corners read once (36 B a
  triangle);
- the image scatter, where the unit has one: each finished path's value
  (12 B) and pixel id (4 B) read once, and each of the unit's pixels read
  and written once (24 B).

Being a lower bound on the time, the share cannot pass 100%.
"""

from __future__ import annotations

import time


def _kineto_kernels(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device event of a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def profile_window(fn, sync) -> dict:
    """Run ``fn()`` under the profiler (device activity only; host activity
    where there is no card, which records no kernel) between two
    synchronisations; returns {"wall_s", "kernels", "result"}."""
    import torch

    act = torch.profiler.ProfilerActivity
    sync()
    with torch.profiler.profile(activities=[act.CUDA if torch.cuda.is_available()
                                            else act.CPU]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall = time.perf_counter() - t0
    return {"wall_s": wall, "kernels": _kineto_kernels(prof), "result": result}


def union(kernels) -> list[tuple[float, float, str]]:
    """Busy intervals (start, end, name of the kernel that ends them) of
    possibly overlapping kernel intervals, in time order."""
    spans = []
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        if spans and s <= spans[-1][1]:
            if e > spans[-1][1]:
                spans[-1] = (spans[-1][0], e, name)
        else:
            spans.append((s, e, name))
    return spans


def busy_s(kernels) -> float:
    return sum(e - s for s, e, _ in union(kernels))


def idle_pct(kernels, wall_s: float) -> float | None:
    """100 minus the device's busy share of a traced window of ``wall_s``."""
    if not kernels or wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(kernels) / wall_s)


def short(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "._-" else "_" for ch in name)[:64]


def breakdown(kernels, n: int = 10) -> dict:
    """The device ops that took most time, by name, and the longest idle
    gaps, named by the kernel before them."""
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[short(name)] = by_name.get(short(name), 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    spans = union(kernels)
    gaps = [("after_" + short(a[2])[:58], b[0] - a[1]) for a, b in zip(spans, spans[1:])]
    gaps = sorted(gaps, key=lambda g: -g[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


HBM_BYTES_PER_S = 3.35e12
RAY_BYTES, TRIANGLE_BYTES = 28, 36
PATH_BYTES, PIXEL_BYTES = 16, 24
TRACE_SCATTER = ("trace_kernel", "scatter_kernel", "sums_kernel")
CLOSEST = "trace_kernel<false"      # one closest-hit launch a loop iteration


def least_bytes(rays, launches, triangles, paths, pixels, scatter):
    n = rays * RAY_BYTES + launches * triangles * TRIANGLE_BYTES
    return n + (paths * PATH_BYTES + pixels * PIXEL_BYTES if scatter else 0)


def kernels_roofline_pct(sub):
    """The traced unit's trace and scatter kernels' share of their least
    time; nothing where the unit ran none."""
    if not sub:
        return None
    kernels = sub["kernels"]
    device_s = sum(e - s for n, s, e in kernels if any(k in n for k in TRACE_SCATTER))
    launches = sum(1 for n, _, _ in kernels if "trace_kernel" in n)
    if device_s <= 0 or not launches:
        return None
    need = least_bytes(sub["rays"], launches, sub["triangles"], sub["paths"],
                       sub["pixels"], sub["scatter"])
    return 100.0 * need / HBM_BYTES_PER_S / device_s


def iter_ms(sub):
    """Milliseconds a loop iteration: the traced unit's wall time (between
    two synchronisations) over its closest-hit trace launches."""
    if not sub:
        return None
    n = sum(1 for name, _, _ in sub["kernels"] if CLOSEST in name)
    return 1e3 * sub["wall_s"] / n if n else None


def unit_idle_pct(sub):
    """``idle_pct`` of a traced unit; nothing where there is none."""
    return idle_pct(sub["kernels"], sub["wall_s"]) if sub else None
