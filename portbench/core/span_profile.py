"""Device time by the program's spans: ``torch.profiler`` (device activity)
and the program's span recording (``utils/spans.py``) around one stretch
of the timed path, reduced in memory. A kernel belongs to the innermost
span open when the host launched it: the profiler pairs each kernel with
its launch call by correlation id, and both carry the Unix clock the
spans are stamped with. Nothing is written to disk."""

from __future__ import annotations

import bisect
import time


def _events(prof):
    """(kernels [(name, start s, end s, launch s or None)], ...) of a
    finished profile: the device's events, each with the host time of the
    call that launched it where the profile holds that call."""
    launch, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            device.append(e)
        elif e.correlation_id():
            launch[e.correlation_id()] = e.start_ns() * 1e-9
    out = []
    for e in device:
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9,
                    launch.get(e.correlation_id()) if e.correlation_id() else None))
    return out


def profile_spans(fn, sync, recording) -> dict:
    """Run ``fn()`` under the profiler and the program's ``recording()``,
    between two synchronisations: {"wall_s", "kernels" [(name, start,
    end)], "launched" [launch s or None, one a kernel], "spans", "counts",
    "result"}."""
    import torch

    act = torch.profiler.ProfilerActivity
    sync()
    with recording() as rec:
        with torch.profiler.profile(activities=[act.CUDA if torch.cuda.is_available()
                                                else act.CPU]) as prof:
            t0 = time.perf_counter()
            result = fn()
            sync()
            wall = time.perf_counter() - t0
    events = _events(prof)
    return {"wall_s": wall, "kernels": [k[:3] for k in events],
            "launched": [k[3] for k in events], "spans": rec.spans,
            "counts": rec.counts, "result": result}


def device_s_by_span(kernels, launched, spans, names) -> dict:
    """Device seconds of the kernels whose innermost open span at launch
    (of any thread: the latest started of those open) is each of
    ``names``; a name no kernel fell in reads 0. Kernels whose launch the
    profile lacks are left out."""
    marks = sorted((s * 1e-9, e * 1e-9, n) for n, s, e, _, _ in filter(None, spans))
    starts = [m[0] for m in marks]
    out = {n: 0.0 for n in names}
    for (_, start, end), at in zip(kernels, launched):
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and marks[i][1] < at:       # back to the latest-started open one
            i -= 1
        if i >= 0 and marks[i][2] in out:
            out[marks[i][2]] += end - start
    return out
