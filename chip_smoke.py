"""GPU smoke test of tinyraytracing_tpu_torch: builds the hand-written CUDA
kernels, holds each against its plain PyTorch version on the card (the
trace kernels in both walk orders), renders through the CLI with the queue
renderer (the 100K-triangle scene), with the scan renderer (the
100K-triangle scene through the packet-BVH kernel, cornell through the
slot kernel) and with the persistent renderer (cornell), renders the
100K-triangle scene under the near-first walk through ``render_image``,
renders small scenes on the card and on the CPU to compare,
interrupts and resumes a checkpointed queue render, and runs the fast
differentiable path (``diff.fast.render_loss_fast``: the trace kernels
forward, path replay backward) forward and backward on cornell and on
the 100K-triangle scene, with a few Adam steps and its gradients held to
the CPU's, and the scan renderer's ``render_loss`` through the
packet-BVH kernel (phase 6). Phase 7 runs the edge-sampled boundary terms
(``diff/edge.py``): the finite-difference scenes of the CPU tests
(``tests/torch_edge_scenes.py``) through the slot kernel, held to finite
differences and to the same check on the CPU, then cornell at 512x512
with 8,192 and 65,536 edge samples through the packet-BVH kernel, beside
the same call without them. Phase 8 runs the regeneration oracles
(``integrator/regen.py``): ``render_regen`` on the 100K-triangle scene
(packet-BVH kernel) and ``render_persistent`` on cornell (slot kernel),
each held to the scan render statistically and to itself on the CPU.
Phases 7 and 8 also hold kernels 4 and 5 bitwise to their plain versions
on dispatches copied from their own main-path calls (8,192, 131,072 and
262,144 rays). Phase 9 runs the multi-rank renderers (``parallel/``):
four gloo ranks, processes started with spawn on the one card, render
phase 3c's and phase 3's calls through ``render_fused_sharded`` (bitwise
phase 3c's image) and ``render_queue_sharded_chunked`` (phase 3's ray
count within float32 rounding) at 1, 2 and 4 ranks, preempt and resume
the sharded queue, run phase 6's loss through ``render_loss_fast_sharded``
and grid:100000 through ``render_sharded`` (the packet-BVH kernel); then
one NCCL rank matches its single-process calls bitwise (the queue at 4
spp, the loss's gradients). Renders and gradients repeat bitwise: phases
3, 3c, 3d and 8 hold each main-path render's rerun with the same key, and
phase 6 each loss's gradients, to the first run's bits, and phase 5 the
resumed queue render to the one-shot one. Phase 6b holds the two
fixed-order scatter kernels (``csrc/scatter_add.cu``, no TPU counterpart:
they replace ``index_add_``'s atomics) bitwise to their plain versions on
calls copied from phases 3, 6 and 8 and on the edge cases of the CPU
tests, timed against ``index_add_`` and ``index_put_``, with each call's
device ops and a run under the sync debug mode; phase 2c holds the two
threefry kernels (``csrc/rng.cu``, no TPU counterpart: XLA fuses the
chain they replace) bitwise to the int64 chain at the main paths' shapes,
timed beside it and their bound, and counts one launch of each a loop
iteration in one unit of each one-card render cell of the benchmark's
registry (a grid100k bucket, a cornell pass4 pass); phase 10 runs the two inverse-rendering examples
(``tinyraytracing_tpu_torch/examples/``) at 32x32. The CLI's tree must come
from the native builder (``native/``, built with g++ in phase 1). The
slot kernel is also checked on grid6000 and on the tie scene of the CPU
tests (``tests/torch_slot_emulate.py``). Run from the repository root:

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero on any failure (and without
a result when there is no CUDA device). The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels,
each with its device time per launch (torch.profiler), its
host-inclusive time (CUDA events around back-to-back calls), its
launches on its main paths (the oracles' and the sharded phase's ranks'
included) and on the differentiable paths (forward, the backward's recompute, the scan
``render_loss``, the edge terms at full size and on the FD scenes). Each
timed
set runs after ~50 ms of back-to-back launches that raise the card's
clock from idle, and the log gives the SM clock nvidia-smi read right
after it, marking readings below 1,500 MHz. Each profiler reading of
phases 2 and 2b is logged beside a second one, CUDA events around calls
queued behind a spin kernel, and summarized after phase 2b.

Before and after a kernel's redesign, on one card in one call:

    git archive <parent> | tar -x -C tmp_out/parent    # here, not on the card
    python3 chip_smoke.py --compare tmp_out/parent --out tmp_out/compare.json

times the redesigned kernels of the parent's package and of this tree in
turns (parent, this, this, parent) and checks their outputs bitwise equal:
the trace kernels through ``ops.trace.fused_trace_planes`` (closest hit
and occlusion, preorder and near-first), the packet sums, the packet-BVH
kernel and the slot kernel, and the two scatter kernels on phase 6b's
shapes (the queue's and ``render_regen``'s image calls, the longest
cotangent call, every cotangent call of a cornell forward + backward);
and times phase 6's scan ``render_loss`` forward + backward (its
gradients are not compared bitwise).

    python3 chip_smoke.py --compare-rng tmp_out/parent --out tmp_out/rng.json

does the same for the threefry calls of phase 2c (through
``ops.rng.bounce_uniforms`` and ``path_keys``, whatever the tree runs
behind them) and for one unit of each of its render cells, whose images
must be bitwise the parent's. ``--sass TREE`` counts the SASS instructions
per slot test of the slot kernel of TREE's package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

T_RTOL, T_ATOL = 1e-5, 1e-6      # _check_fused tolerance for t
A_TOL = 1e-4                     # ... and for shading normal / texcoord
CSRC = "tinyraytracing_tpu_torch/csrc/"
SOURCES = {"trace_closest": CSRC + "trace.cu",
           "trace_occlusion": CSRC + "trace.cu",
           "trace_near": CSRC + "trace.cu",
           "packet_dirs": CSRC + "trace.cu",
           "bvh_intersect": CSRC + "bvh_intersect.cu",
           "slot_intersect": CSRC + "slot_intersect.cu",
           "scatter_rows": CSRC + "scatter_add.cu",
           "scatter_fixed": CSRC + "scatter_add.cu",
           "threefry_draws": CSRC + "rng.cu",
           "threefry_path_keys": CSRC + "rng.cu"}
REPLACES = {
    "trace_closest": "tinyraytracing_tpu/ops/pallas_trace.py:962",
    "trace_occlusion": "tinyraytracing_tpu/ops/pallas_trace.py:206",
    "trace_near": "tinyraytracing_tpu/ops/pallas_trace.py:382",
    "packet_dirs": "tinyraytracing_tpu/ops/pallas_trace.py:376",
    "bvh_intersect": "tinyraytracing_tpu/ops/pallas_bvh.py:188",
    "slot_intersect": "tinyraytracing_tpu/ops/pallas_intersect.py:168",
    # no TPU counterpart: the JAX package's scatter-adds are XLA's, in a
    # fixed order; the port's took index_add_'s atomics until these
    "scatter_rows": "none (no TPU counterpart: replaces index_add_ at "
                    "tinyraytracing_tpu_torch/integrator/fused_queue.py and "
                    "integrator/regen.py)",
    "scatter_fixed": "none (no TPU counterpart: replaces index_add_ in the "
                     "backward of tinyraytracing_tpu_torch/ops/lookup.py "
                     "gather_rows)",
    # no TPU counterpart: XLA fuses the JAX package's threefry chain
    "threefry_draws": "none (no TPU counterpart: replaces the int64 chain of "
                      "tinyraytracing_tpu_torch/ops/rng.py bounce_uniforms)",
    "threefry_path_keys": "none (no TPU counterpart: replaces the int64 chain "
                          "of tinyraytracing_tpu_torch/ops/rng.py path_keys)",
}
# H100 SXM datasheet peaks: float32 outside the tensor
# cores, and HBM bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# lane-instructions the card issues per second: 132 SMs x 4 schedulers x
# 32 lanes at 1,980 MHz (an FMA counts once; the kernels issue none)
INSTR_RATE = 132 * 4 * 32 * 1.98e9
SCAN_CHUNK = 65536               # RenderConfig.ray_chunk: one scan dispatch
WARM_S = 0.05                    # warm-up load before each timed set
LOW_MHZ = 1500                   # a reading below this SM clock is marked


def log(*a):
    print(*a, flush=True)


def _events_ms(fn, runs):
    """Median milliseconds of ``fn()`` over ``runs`` timed runs (CUDA
    events), after one warm-up run. For the plain versions, whose many
    launches the host paces."""
    fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _host_ms(fn, n=20):
    """Host-inclusive milliseconds per call: CUDA events around ``n``
    back-to-back calls of ``fn()`` (the wrapper's checks, allocations and
    launch included wherever they outlast the kernel), divided by n."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _device_ms(fn, names=None, n=20):
    """Device milliseconds per launch: the mean duration of the CUDA
    kernels of ``n`` calls of ``fn()`` under torch.profiler (CUDA activity
    only) whose name holds one of ``names`` (every kernel if None; then
    ``fn`` must launch one kernel). The profiler may drop some kernel
    records of a profiling window, so the mean is over the launches it
    recorded, and the log says when that was fewer than n. Where it
    recorded fewer than half, or no device time, CUDA events around
    10 * n back-to-back calls stand in, and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and (names is None or any(k in e.name for k in names))]
    if len(us) < n / 2 or sum(us) <= 0:
        log(f"    (the profiler recorded {len(us)} of {n} launches of {names}: "
            f"CUDA events over {10 * n} launches instead)")
        return _host_ms(fn, 10 * n)
    if len(us) != n:
        log(f"    (the profiler recorded {len(us)} of {n} launches of {names}: "
            f"the mean is over those)")
    return sum(us) / 1e3 / len(us)


def _warm(fn=None):
    """About WARM_S seconds of back-to-back calls of ``fn`` (by default an
    in-place add over 16 MiB, which allocates nothing: a matrix product
    would leave cuBLAS's workspace allocated and in every later peak) on
    the card: an idle card runs at a low clock, and a short timed set
    alone does not raise it."""
    if fn is None:
        x = torch.zeros(1 << 22, device="cuda")
        fn = lambda: x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        for _ in range(8):
            fn()
        torch.cuda.synchronize()


def _sm_clock():
    """The card's SM clock in MHz, as nvidia-smi reads it now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return int(out.split()[0])


def _mhz(clock):
    """The clock beside a reading, marked where it was low."""
    return f"{clock} MHz" + (f" (below {LOW_MHZ:,} MHz)" if clock < LOW_MHZ else "")


# (kernel names, torch.profiler's device ms a launch, the spin-queued
# events' device ms a call) of every _times set, for phase 2's summary
SECOND_READINGS = []


def _times(fn, names, n=20):
    """(device ms per launch, host-inclusive ms per call, SM clock MHz right
    after) of ``fn``, after a warm-up load of ``fn`` itself. The profiler's
    device time gets a second reading, logged beside it: CUDA events around
    ``n`` calls queued behind a spin kernel (``_device_total_ms``: every
    device op of a call, no record dropped)."""
    _warm(fn)
    dev, host = _device_ms(fn, names, n), _host_ms(fn, n)
    mhz = _sm_clock()
    spin, _ = _device_total_ms(fn, n)
    SECOND_READINGS.append((names, dev, spin))
    log(f"    (device time of {names or 'every kernel'}: torch.profiler "
        f"{dev:.5f} ms a launch, CUDA events behind a spin {spin:.5f} ms a "
        f"call)")
    return dev, host, mhz


def _second_readings_summary():
    """One line on phases 2 and 2b's device times: the spin-queued events'
    reading over the profiler's, per set."""
    ratios = sorted(spin / dev for _, dev, spin in SECOND_READINGS if dev > 0)
    if not ratios:
        return
    low = sum(r > 1.1 for r in ratios)
    log(f"  second readings of {len(ratios)} device-time sets (CUDA events "
        f"behind a spin over torch.profiler): min {ratios[0]:.3f}, median "
        f"{statistics.median(ratios):.3f}, max {ratios[-1]:.3f}; {low} sets "
        f"where the profiler read more than 10% below the events")


def _bound(ops, nbytes):
    """(ms, "operations" | "bytes"): the least time for ``ops`` float32
    operations and ``nbytes`` of device memory traffic at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _timed_ms(fn):
    """(result, milliseconds) of one run of ``fn()`` (CUDA events)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _tests_module(name):
    """A helper module of ``tests/``, loaded from its file: the card's
    machine may have another package named tests."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod        # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


TRACE_KERNELS = ("trace_closest", "trace_occlusion", "trace_near", "packet_dirs")
KERNELS = (*TRACE_KERNELS, "bvh_intersect", "slot_intersect", "scatter_rows",
           "scatter_fixed")


def _launches(rec, kernels=KERNELS):
    """Each kernel's launches in a finished ``spans.recording()`` (the
    wrappers' ``launches.<kernel>`` counters), 0 where it had none."""
    return {k: rec.counts.get("launches." + k, 0) for k in kernels}


def _counted(fn):
    """(``fn()``, every kernel's launches in it)."""
    from tinyraytracing_tpu_torch.utils import spans

    with spans.recording() as rec:
        out = fn()
    return out, _launches(rec)


def _top_ops(events, k=3):
    """The ``k`` device ops with the most device time: (name, ms) pairs."""
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:k]


def _ulps(a, b):
    """Largest distance in float32 ulps between two finite planes."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _probe_rays(scene, cam, n_cam, gen, cfg):
    """n_cam jittered camera rays plus one cosine-diffuse bounce ray from
    each camera ray's first hit (misses park: origin 1e30, bound 0), and
    one shadow ray from each camera hit and each bounce hit toward a
    random point of light 0 (bound = light distance, target = light
    material; a third parked): 2 * n_cam of each kind, the main path's
    two dispatches at n_cam = lanes / 2. Hits come from the plain walk."""
    from tinyraytracing_tpu_torch.integrator.fused import sample_lobe_planar
    from tinyraytracing_tpu_torch.models.camera import camera_basis
    from tinyraytracing_tpu_torch.ops import vec
    from tinyraytracing_tpu_torch.ops.trace import trace_plain

    dev = scene.device
    eye, hor, ver, llc = (v.to(dev) for v in camera_basis(cam))
    x, y = torch.rand(2, n_cam, generator=gen).to(dev)
    d = llc + x[:, None] * hor + y[:, None] * ver - eye
    d = d / d.norm(dim=1, keepdim=True)
    o = eye.expand(n_cam, 3)
    full = lambda v, n=n_cam: torch.full((n,), v, device=dev)
    cam_rays = torch.cat([o.T, d.T, full(3.0e38)[None], full(-2.0)[None]]).contiguous()
    hit = trace_plain(scene.bvh.packed, cam_rays, cfg)
    t, pn, mtl = hit[0], hit[1:4], hit[6]
    ok = mtl >= 0
    point = o + d * t[:, None]
    pnn = vec.normalize(tuple(pn))
    u = torch.rand(2, n_cam, generator=gen).to(dev)
    bd = sample_lobe_planar(pnn, u[0], u[1], torch.ones_like(ok), full(1.0))
    far = full(1.0e30)
    bo = [torch.where(ok, point[:, k], far) for k in range(3)]
    bounce = torch.stack([*bo, *bd, torch.where(ok, full(3.0e38), full(0.0)),
                          full(-2.0)]).contiguous()
    hit2 = trace_plain(scene.bvh.packed, bounce, cfg, attrs=False)
    ok2 = ok & (hit2[6] >= 0)
    point2 = torch.stack(bo, 1) + torch.stack(bd, 1) * hit2[0][:, None]
    # shadow rays from both hit sets
    n = 2 * n_cam
    ok_all = torch.cat([ok, ok2])
    p_all = torch.cat([point, point2])
    b = torch.rand(3, n, generator=gen).to(dev)
    b = b / b.sum(0)
    lp = (b[0, :, None] * scene.lt_v0[0, 0] + b[1, :, None] * scene.lt_v1[0, 0]
          + b[2, :, None] * scene.lt_v2[0, 0])
    to = lp - p_all
    dist = to.norm(dim=1)
    live = ok_all & (torch.rand(n, generator=gen).to(dev) > 1.0 / 3.0)
    sd = to / dist[:, None]
    so = [torch.where(live, p_all[:, k], full(1.0e30, n)) for k in range(3)]
    shadow = torch.stack([*so, *sd.T, torch.where(live, dist, full(0.0, n)),
                          torch.where(live, scene.light_mtl[0].float(),
                                      full(-2.0, n))])
    rays = torch.cat([cam_rays, bounce], dim=1).contiguous()
    return rays, shadow.contiguous()


def _compare(name, k, p, attrs, occl, report):
    """Discrete planes equal, floats within the _check_fused tolerances."""
    if occl:
        vis_k = (k[1] > 0.5) & (k[0] >= 0)
        vis_p = (p[1] > 0.5) & (p[0] >= 0)
        disc = {"killed": int(((k[0] < 0) != (p[0] < 0)).sum()),
                "visible": int((vis_k != vis_p).sum())}
        floats = {"t": (k[0], p[0])}
    else:
        disc = {"hit": int(((k[6] >= 0) != (p[6] >= 0)).sum()),
                "mtl": int((k[6] != p[6]).sum()),
                "em": int((k[7] != p[7]).sum()),
                "slot/tri": int((k[8] != p[8]).sum()),
                "kill": int(((k[6] == -3) != (p[6] == -3)).sum())}
        floats = {"t": (k[0], p[0])}
        if attrs:
            floats.update(pn=(k[1:4], p[1:4]), tc=(k[4:6], p[4:6]))
    bad_float = 0
    max_err = 0.0
    for f, (a, b) in floats.items():
        fin = torch.isfinite(a) & torch.isfinite(b)
        rtol, atol = (T_RTOL, T_ATOL) if f == "t" else (A_TOL, A_TOL)
        bad_float += int((~torch.isclose(a, b, rtol=rtol, atol=atol)).sum())
        if fin.any():
            max_err = max(max_err, float((a[fin] - b[fin]).abs().max()))
    ulp = _ulps(k[0], p[0])
    log(f"  {name}: discrete mismatches {disc}, floats outside tolerance "
        f"{bad_float}, max |t| ulp distance {ulp}, max abs err {max_err:.3g}")
    report["max_abs_err"] = max(report["max_abs_err"], max_err)
    return sum(disc.values()) == 0 and bad_float == 0


def _phase2_scenes():
    """(label, scene, camera): grid100k at leaf 8 (the tree the CLI
    builds for the main path), at leaf 32 (the JAX package's width for big
    scenes, --leaf-size 32: 32-slot leaf blocks), and cornell (a light
    coplanar with the ceiling: the tie band)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    grid, cam = quad_grid(100_000, 1024, 1024, device="cpu")  # leaf 8
    yield "grid100k leaf 8", grid, cam
    yield "grid100k leaf 32", attach_bvh(grid, RenderConfig(leaf_size=32)), cam
    scene, cam = cornell_box(1024, 1024, device="cpu")
    yield "cornell leaf 8", attach_bvh(scene, RenderConfig(leaf_size=8)), cam


def _walk_bound(stats, R, in_planes, out_planes):
    """Bound of one walk launch from what its plain version counted on the
    same rays: the slab and slot tests (and the near-first walk's keys and
    19-compare sorts), and the bytes of the tree and payload it reads
    (each counted once), plus the ray planes in and out."""
    from tinyraytracing_tpu_torch.ops.bvh_intersect import SLAB_FLOPS
    from tinyraytracing_tpu_torch.ops.slot_test import SLOT_FLOPS
    from tinyraytracing_tpu_torch.ops.trace import KEY_FLOPS, SORT8

    ops = (stats.get("node_visits", 0) * SLAB_FLOPS
           + stats["slot_tests"] * SLOT_FLOPS
           + stats.get("near_keys", 0) * KEY_FLOPS
           + stats.get("near_sorts", 0) * len(SORT8))
    nbytes = 4 * R * (in_planes + out_planes) + stats["scene_bytes"]
    return _bound(ops, nbytes), nbytes


def phase_kernels(dev):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import trace

    cfg = RenderConfig()
    reports = {k: {"max_abs_err": 0.0} for k in REPLACES}
    ok = ok2b = True
    gen = torch.Generator().manual_seed(2024)
    t0 = time.perf_counter()
    for name, scene, cam in _phase2_scenes():
        scene = scene.to(dev)
        pk = scene.bvh.packed
        rays, shadow = _probe_rays(scene, cam, 131072, gen, cfg)
        log(f"phase 2 [{name}]: {scene.num_triangles} triangles, "
            f"{scene.bvh.n_nodes} binary / {pk.n_wide} wide nodes "
            f"(depth {pk.wide_depth}), {rays.shape[1]} camera+bounce rays, "
            f"{shadow.shape[1]} shadow rays ({int((shadow[6] > 0).sum())} "
            f"live); setup {time.perf_counter() - t0:.1f}s")
        cases = [("closest attrs", rays, True, False, "trace_closest"),
                 ("closest no-attrs", rays, False, False, "trace_closest"),
                 ("shadow closest t_bound+target", shadow, False, False,
                  "trace_closest"),
                 ("shadow occlusion", shadow, False, True, "trace_occlusion")]
        pre = {}
        rec = scene.trace_records
        for label, r, attrs, occl, kname in cases:
            k = trace.trace_kernel(rec, r, cfg, attrs=attrs, occl=occl)
            pre[label] = k
            stats = {}
            p, pms = _timed_ms(lambda: trace.trace_plain(
                pk, r, cfg, attrs=attrs, occl=occl, stats=stats))
            ok &= _compare(label, k, p, attrs, occl, reports[kname])
            kms, hms, mhz = _times(lambda: trace.trace_kernel(
                rec, r, cfg, attrs=attrs, occl=occl), ("trace_kernel",))
            (bms, by), nbytes = _walk_bound(stats, r.shape[1], 8,
                                            2 if occl else 9)
            log(f"    time at {r.shape[1]} rays: kernel {kms:.4f} ms device "
                f"({hms:.4f} ms host-inclusive) at {_mhz(mhz)}, plain "
                f"{pms:.1f} ms (one run, CUDA events); {stats['node_visits']} "
                f"slab tests, {stats['slot_tests']} slot tests, {nbytes} bytes "
                f"read or written: bound {bms:.4f} ms ({by})")
            reports[kname].setdefault("cases", {})[f"{name}, {label}"] = dict(
                device_ms=kms, host_ms=hms, sm_mhz=mhz, bound_ms=bms,
                bound_by=by)
            # the main path's dispatches: bounce and shadow rays on its tree
            if name == "grid100k leaf 8" and label in (
                    "closest attrs", "shadow occlusion"):
                reports[kname].update(ms=kms, device_ms=kms, host_ms=hms,
                                      sm_mhz=mhz, plain_ms=pms, bound_ms=bms,
                                      bound_by=by)
        # kernel 3: the near-first walk on the wide tree (grid100k walks
        # wide anyway; cornell is asked to)
        ok &= phase_near_cases(name, scene, rays, shadow, cases, pre, reports)
        # return_tri: the slot -> triangle map through tid, kernel path
        planes = lambda x: tuple(x[i] for i in range(8))
        kt = trace.fused_trace_planes(scene, *planes(rays)[:6], cfg,
                                      t_bound=rays[6], return_tri=True)
        slot = trace.trace_plain(pk, rays, cfg)[8]
        want = torch.where(slot >= 0, pk.tid[slot.clamp_min(0).long()].float(),
                           torch.full_like(slot, -1.0))
        bad = int((kt[8] != want).sum())
        log(f"  return_tri: triangle mismatches {bad}")
        ok &= bad == 0
        # shadow compaction on / off through the kernel, two segments
        vis = {}
        for mode in ("on", "off"):
            vis[mode] = trace.occlusion_trace_segmented(
                scene, *planes(shadow)[:6], shadow[6], shadow[7],
                cfg.replace(shadow_compact=mode), 2)
        bad = int((vis["on"] != vis["off"]).sum())
        log(f"  occlusion_trace_segmented compact on vs off: {bad} lanes differ, "
            f"{int(vis['on'].sum())} visible")
        ok &= bad == 0
        # phase 2b: the scan path's kernels on the same trees
        kinds = ("bvh", "slot") if name.startswith("cornell") else ("bvh",)
        ok2b &= phase_intersect_kernels(name, scene, cam, kinds, gen, reports)
        t0 = time.perf_counter()
    from tinyraytracing_tpu_torch.models.procedural import quad_grid

    grid6k, cam = quad_grid(6000, device=dev)
    ok2b &= phase_intersect_kernels("grid6000 leaf 8", grid6k, cam, ("slot",),
                                    gen, reports)
    # the tie scene of the slot kernel's CPU tests
    emulate = _tests_module("torch_slot_emulate")
    ties, cam = emulate.tie_scene(device=dev)
    rays = _scan_probe_rays(ties, cam, gen)
    # its surfaces lie in the lights' planes: shadow rays from them never
    # hit, so these come from below, aimed at the light's tied triangles
    rays["shadow"] = emulate.tie_shadow_rays(ties, SCAN_CHUNK, 2024, dev)
    ok2b &= phase_intersect_kernels("ties", ties, cam, ("slot",), gen, reports,
                                    rays)
    return ok, ok2b, reports


def phase_near_cases(name, scene, rays, shadow, cases, pre, reports):
    """Kernel 3 on the cases of phase 2 (without the closest-hit case
    without attributes): the near kernel bitwise equal to the near plain
    version on the same packet directions, the packet directions' kernel
    bitwise equal to its plain version, and the lanes where near differs
    from the preorder kernel counted (each must lie in the tie band)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import trace

    cfg = RenderConfig(walk_order="near", bvh_walk="wide")
    pk, rec = scene.bvh.packed, scene.trace_records
    ok = True
    for label, r, attrs, occl, _ in cases:
        if label == "closest no-attrs":
            continue
        tile = trace.near_tile(pk, cfg, occl)
        md = trace.packet_dirs_kernel(r, tile)
        md_plain = trace.packet_dirs_plain(r, tile)
        k = trace.trace_kernel(rec, r, cfg, attrs=attrs, occl=occl, tile=tile,
                               md=md)
        stats = {}
        p, pms = _timed_ms(lambda: trace.trace_plain(
            pk, r, cfg, attrs=attrs, occl=occl, tile=tile, md=md, stats=stats))
        same = torch.equal(k, p) and torch.equal(md, md_plain)
        _compare(f"near {label}", k, p, attrs, occl, reports["trace_near"])
        # lanes where the order decided: any plane differs from preorder
        diff = (k != pre[label]).any(dim=0)
        ta, tb = k[0][diff], pre[label][0][diff]
        band = (ta - tb).abs() <= cfg.tie_eps * torch.maximum(ta.abs(),
                                                              tb.abs())
        kms, hms, mhz = _times(lambda: trace.trace_kernel(
            rec, r, cfg, attrs=attrs, occl=occl, tile=tile, md=md),
            ("trace_kernel",))
        (bms, by), nbytes = _walk_bound(stats, r.shape[1], 8,
                                        2 if occl else 9)
        log(f"    near [{name}] {label}, packets of {tile}: kernel and plain "
            f"{'bitwise equal' if same else 'DIFFER'}; {int(diff.sum())} lanes "
            f"differ from preorder ({int((~band).sum())} outside the tie band)"
            f"; kernel {kms:.4f} ms device ({hms:.4f} ms host-inclusive) at "
            f"{_mhz(mhz)}, plain {pms:.1f} ms; {stats['node_visits']}"
            f" slab tests, {stats['slot_tests']} slot tests, "
            f"{stats['near_sorts']} sorts, {nbytes} bytes: bound {bms:.4f} ms "
            f"({by})")
        ok &= same and bool(band.all())
        reports["trace_near"].setdefault("cases", {})[f"{name}, {label}"] = dict(
            device_ms=kms, host_ms=hms, sm_mhz=mhz, bound_ms=bms, bound_by=by)
        if name == "grid100k leaf 8" and label == "closest attrs":
            reports["trace_near"].update(ms=kms, device_ms=kms, host_ms=hms,
                                         sm_mhz=mhz, plain_ms=pms,
                                         bound_ms=bms, bound_by=by)
            ok &= _packet_sums(r, tile, md, md_plain, reports["packet_dirs"])
    return ok


def _packet_sums(r, tile, md, md_plain, rep):
    """The packet sums at the main path's packets: device and
    host-inclusive times beside torch.sum over the same packets (which
    adds in its own order) and the bound; then the tall packets of
    ``ray_tile`` 8192 and 16384 (2 and 4 bands of rows), bitwise against
    the plain version on the same rays."""
    from tinyraytracing_tpu_torch.ops import trace

    R, n = r.shape[1], md.shape[0]
    dms, hms, mhz = _times(lambda: trace.packet_dirs_kernel(r, tile),
                           ("packet_dirs",))
    dpms = _events_ms(lambda: trace.packet_dirs_plain(r, tile), 2)
    lib = lib_h = lib_mhz = None
    if R == n * tile:
        lib, lib_h, lib_mhz = _times(
            lambda: r[3:6].reshape(3, n, tile).sum(dim=2), None)
    (dbms, dby) = _bound(3 * R, 4 * 3 * (R + n))
    rep.update(ms=dms, device_ms=dms, host_ms=hms, sm_mhz=mhz, plain_ms=dpms,
               bound_ms=dbms, bound_by=dby, library_ms=lib,
               max_abs_err=float((md - md_plain).abs().max()))
    log(f"    packet_dirs at {R} rays, {n} packets of {tile}: kernel {dms:.5f} "
        f"ms device ({hms:.5f} ms host-inclusive) at {_mhz(mhz)}, plain "
        f"{dpms:.1f} ms, torch.sum {lib} ms device ({lib_h} ms "
        f"host-inclusive) at {lib_mhz and _mhz(lib_mhz)}; bound "
        f"{dbms:.5f} ms ({dby}), the kernel at {100 * dbms / dms:.0f}% of it")
    ok = True
    for tall in (8192, 16384):
        k = trace.packet_dirs_kernel(r, tall)
        p = trace.packet_dirs_plain(r, tall)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        tms, _, mhz = _times(lambda: trace.packet_dirs_kernel(r, tall),
                             ("packet_dirs",))
        log(f"    packet_dirs, packets of {tall}: kernel and plain "
            f"{'bitwise equal' if same else 'DIFFER'}; {tms:.5f} ms device "
            f"at {_mhz(mhz)}")
        ok &= same
    return ok


# ---------------------------------------------------------------------------
# phase 2b: the scan path's kernels against their plain versions
# ---------------------------------------------------------------------------

def _scan_probe_rays(scene, cam, gen):
    """The scan path's three dispatches at SCAN_CHUNK rays, as (6, R)
    planes: jittered camera rays; one cosine-diffuse bounce ray from each
    camera hit; one shadow ray from each camera hit toward a random point
    of light 0. Misses park at 1e30 as the scan renderer parks dead rays
    (bounce direction (0, 0, 1); the shadow direction its NEE computes).
    Hits come from the packet-BVH kernel, or the slot kernel on a scene
    without a BVH."""
    import dataclasses

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.camera import generate_rays
    from tinyraytracing_tpu_torch.ops.intersect import intersect
    from tinyraytracing_tpu_torch.ops.linalg import dot, normalize
    from tinyraytracing_tpu_torch.ops.sampling import sample_lobe

    dev = scene.device
    side = int(SCAN_CHUNK ** 0.5)
    o, d = generate_rays(dataclasses.replace(cam, width=side, height=side),
                         (0, 2024), dev)
    n = o.shape[0]
    hit = intersect(scene, o, d, RenderConfig(
        intersector="pallas" if scene.bvh is None else "bvh_pallas"))
    ok = hit.hit[:, None]
    point = torch.where(ok, o + hit.t[:, None] * d,
                        torch.tensor(1.0e30, device=dev))
    gn = scene.gn[hit.idx]
    nrm = torch.where((dot(gn, d) > 0.0)[:, None], -gn, gn)
    u = torch.rand(2, n, generator=gen).to(dev)
    ones = torch.ones(n, device=dev)
    bd = sample_lobe(nrm, u[0], u[1], ones > 0, ones)
    bd = torch.where(ok, bd, torch.tensor([0.0, 0.0, 1.0], device=dev))
    b = torch.rand(n, 3, generator=gen).to(dev)
    b = b / b.sum(1, keepdim=True)
    lp = (b[:, :1] * scene.lt_v0[0, 0] + b[:, 1:2] * scene.lt_v1[0, 0]
          + b[:, 2:] * scene.lt_v2[0, 0])
    sd = normalize(lp - point)
    planes = lambda a, c: torch.cat([a.T, c.T]).contiguous()
    return {"camera": planes(o, d), "bounce": planes(point, bd),
            "shadow": planes(point, sd)}


def phase_intersect_kernels(name, scene, cam, kinds, gen, reports, rays=None,
                            cfg=None, phase="phase 2b"):
    """Kernels 4 ("bvh") and 5 ("slot") against their plain versions on the
    scan path's three kinds of rays (``rays``, else ``_scan_probe_rays``)
    under ``cfg`` (default RenderConfig()): every output plane bitwise
    equal. The slot kernel's cases also time an empty kernel on its grid
    (the floor under its device time)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import bvh_intersect as bi
    from tinyraytracing_tpu_torch.ops import slot_intersect as si

    cfg = cfg or RenderConfig()
    t0 = time.perf_counter()
    rays = rays or _scan_probe_rays(scene, cam, gen)
    pk = scene.bvh.packed if scene.bvh is not None else None
    P, n_chunks = scene.slot_payload
    T = scene.num_triangles
    n_rays = sorted({r.shape[1] for r in rays.values()})
    log(f"{phase} [{name}]: {T} triangles, {n_chunks} slot chunks, "
        f"{'/'.join(map(str, n_rays))} rays of each kind; setup "
        f"{time.perf_counter() - t0:.1f}s")
    ok = True
    for kind in kinds:
        kname = "bvh_intersect" if kind == "bvh" else "slot_intersect"
        for label, r in rays.items():
            R = r.shape[1]
            stats = {}
            if kind == "bvh":
                kern = lambda: bi.bvh_intersect_kernel(scene.bvh_records, r, cfg)
                k = kern()
                p, pms = _timed_ms(lambda: bi.bvh_intersect_plain(pk, r, cfg, stats))
                work = (f"{stats['node_visits']} slab tests, "
                        f"{stats['slot_tests']} slot tests")
            else:
                kern = lambda: si.slot_intersect_kernel(P, T, r, cfg)
                k = kern()
                p, pms = _timed_ms(lambda: si.slot_intersect_plain(P, T, r, cfg, stats))
                work = f"{stats['slot_tests']} slot tests"
            torch.cuda.synchronize()
            bad = [f for f, a, b in zip(("t", "tri/idx", "u", "v"), k, p)
                   if not torch.equal(a, b)]
            hit = k[0] < 3.0e38
            err = float((k[0][hit] - p[0][hit]).abs().max()) if hit.any() else 0.0
            kms, hms, mhz = _times(kern, (kname,))
            (bms, by), nbytes = _walk_bound(stats, R, 6, 4)
            log(f"  {kname} {label}: planes not bitwise equal {bad or 'none'}, "
                f"{int(hit.sum())} hits; kernel {kms:.4f} ms device ({hms:.4f} "
                f"ms host-inclusive) at {_mhz(mhz)}, plain {pms:.1f} ms (CUDA "
                f"events); {work}, "
                f"{nbytes} bytes read or written: bound {bms:.4f} ms ({by}), "
                f"the kernel at {100 * bms / kms:.2f}% of it")
            ok &= not bad
            rep = reports[kname]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            case = dict(device_ms=kms, host_ms=hms, sm_mhz=mhz, bound_ms=bms)
            if kind == "slot":
                case["floor_ms"], _, _ = _times(lambda: _empty_launch(R),
                                                ("empty_kernel",))
                log(f"    an empty kernel on its grid: {case['floor_ms']:.4f} "
                    f"ms device")
            rep.setdefault("cases", {})[f"{name}, {label}"] = case
            # the main path's dispatch: bounce rays on the tree the CLI
            # builds (kernel 4), on cornell (kernel 5)
            if label == "bounce" and (name, kind) in (("grid100k leaf 8", "bvh"),
                                                      ("cornell leaf 8", "slot")):
                rep.update(ms=kms, device_ms=kms, host_ms=hms, sm_mhz=mhz,
                           plain_ms=pms, bound_ms=bms, bound_by=by)
    return ok


@contextlib.contextmanager
def _captured_rays(kind, picks):
    """While the block runs, copies of the rays the wrapper of kernel 4
    (``kind`` "bvh") or 5 ("slot") is given on its calls numbered
    ``picks`` (from 0): {"dispatch i": (6, R) planes}. The wrapper
    launches as before; the copies let ``phase_intersect_kernels`` hold the
    kernel to its plain version at a main path's own shapes and rays."""
    from tinyraytracing_tpu_torch.ops import bvh_intersect, slot_intersect

    mod, fn = ((bvh_intersect, "bvh_intersect_planes") if kind == "bvh"
               else (slot_intersect, "slot_intersect_planes"))
    real, seen, calls = getattr(mod, fn), {}, [0]

    def copying(scene, rays, config):
        if calls[0] in picks:
            seen[f"dispatch {calls[0]}"] = rays.clone()
        calls[0] += 1
        return real(scene, rays, config)

    setattr(mod, fn, copying)
    try:
        yield seen
    finally:
        setattr(mod, fn, real)


# the queue's and render_regen's image scatter copied at this iteration
SCATTER_PICK = 20


@contextlib.contextmanager
def _captured_scatter(mod, fn, picks=None):
    """While the block runs, CPU copies of the arguments that ``mod.fn`` (a
    scatter wrapper, as the caller's module imported it) is given on its
    calls numbered ``picks`` (from 0; every call if None), in a list, the
    destination's copy taken before the add. The wrapper runs as before;
    the copies (on the CPU, out of the device's peak) let phase 6b hold
    the kernels to their plain versions at a main path's own shapes."""
    real, kept, calls = getattr(mod, fn), [], [0]

    def copying(*args, **kw):
        if picks is None or calls[0] in picks:
            kept.append(tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                              for a in args) + tuple(kw.values()))
        calls[0] += 1
        return real(*args, **kw)

    setattr(mod, fn, copying)
    try:
        yield kept
    finally:
        setattr(mod, fn, real)


def _main_path_rays_ok(name, scene, kind, seen, picks, cfg, reports, phase):
    """The captured dispatches ``seen`` through ``phase_intersect_kernels``:
    every one of ``picks`` captured, and each bitwise its plain version."""
    if len(seen) != len(picks):
        log(f"{phase} [{name}]: captured {sorted(seen)}, wanted the dispatches "
            f"{sorted(picks)}")
        return False
    return phase_intersect_kernels(name, scene, None, (kind,), None, reports,
                                   seen, cfg, phase)


EMPTY_CU = r"""
__global__ void empty_kernel() {}

extern "C" int trt_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
SLOT_BLOCK = 512                 # csrc/slot_intersect.cu: threads a block


@functools.lru_cache(maxsize=None)
def _empty_lib():
    """EMPTY_CU built with the package's flags into its build directory."""
    import ctypes

    from tinyraytracing_tpu_torch.ops import kernels

    src = kernels.BUILD_DIR / "empty_kernel.cu"
    if not src.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(EMPTY_CU)
    lib = kernels.library(str(src))
    lib.trt_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _empty_launch(R):
    """An empty kernel on the grid the slot kernel launches for R rays (the
    floor under its device time)."""
    err = _empty_lib().trt_empty_launch(-(-R // SLOT_BLOCK), SLOT_BLOCK,
                                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# phase 3: the CLI at full size
# ---------------------------------------------------------------------------

def phase_cli(dev, out_dir, refs):
    """Phase 3: grid:100000 through the CLI with "auto" (the queue, through
    the chunked driver). Only the render call is timed; kernel and busy time
    come from torch.profiler of the same render run again (_render_report).
    Keeps (image, traced rays, seconds) in ``refs["queue"]`` for phase 9,
    and the arguments of the image scatter of iteration SCATTER_PICK in
    ``refs["scatter rows"]`` for phase 6b."""
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.integrator import fused_queue
    from tinyraytracing_tpu_torch.ops import bvh
    from tinyraytracing_tpu_torch.utils import spans

    seen, built = {}, []
    real = render_mod.render_fused_queue_chunked
    real_attach = bvh.attach_bvh

    def attach_timed(scene, config):
        t0 = time.perf_counter()
        out = real_attach(scene, config)
        # the scene it returns, not the one it was given: holding that one
        # (with quad_grid's own packed tree) would raise the render's peak
        built.append((time.perf_counter() - t0, out.bvh.builder, out, config))
        return out

    argv = ["--scene", "grid:100000", "--width", "1024", "--height", "1024",
            "--spp", "4", "--out", f"{out_dir}/grid100k.png"]
    torch.cuda.reset_peak_memory_stats()
    render_mod.render_fused_queue_chunked = _timed_entry(
        "render_fused_queue_chunked", real, seen)
    bvh.attach_bvh = attach_timed
    try:
        with (_captured_scatter(fused_queue, "scatter_add_rows", (SCATTER_PICK,)) as kept,
              spans.recording() as rec):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
    finally:
        render_mod.render_fused_queue_chunked = real
        bvh.attach_bvh = real_attach
    launches = _launches(rec)
    refs["scatter rows"] = kept
    log(f"phase 3: cli {' '.join(argv[:-2])} (spp cut from config 3's 512 to 4 "
        f"only to fit the smoke's time limit; the chunked queue driver) -> rc {rc}")
    # the numpy builder on the same triangles (in leaf order), timed here
    # for comparison with the native build (PERF.md, Findings)
    secs, builder, scene, config = built[0]
    v = torch.stack([scene.v0, scene.v1, scene.v2], dim=1).cpu().numpy()
    t0 = time.perf_counter()
    bvh.build_bvh(v, config.leaf_size, config.aabb_pad)
    numpy_s = time.perf_counter() - t0
    log(f"  the CLI's BVH build (attach_bvh, builder {builder}) took "
        f"{' + '.join(f'{b[0]:.3f}' for b in built)} s of its wall; the numpy "
        f"builder alone on the same {len(v)} triangles {numpy_s:.3f} s")
    img, same = _render_report("queue grid:100000", wall, seen, launches, real,
                               ("trace_kernel",))
    refs["queue"] = (img.cpu(), seen["rays"], seen["seconds"])
    # one image scatter per iteration, as many as kernel 1's launches
    ok = (rc == 0 and all(b[1] == "native" for b in built) and same
          and launches["trace_closest"] > 0
          and launches["trace_occlusion"] > 0 and launches["trace_near"] == 0
          and launches["scatter_rows"] == launches["trace_closest"]
          and launches["scatter_fixed"] == 0 and len(kept) == 1
          and bool(torch.isfinite(img).all()) and float(img.mean()) > 0)
    return ok, launches


# ---------------------------------------------------------------------------
# phase 3b: the scan renderer through the CLI at full size
# ---------------------------------------------------------------------------

def _profiled(fn, kernel_name):
    """Device time of one run of ``fn`` under torch.profiler (CUDA activity
    only), after a warm-up load: (kernels, device busy ms, ms in kernels
    whose name holds ``kernel_name``, or any of them if it is a tuple, how
    many such kernels it recorded, and the SM clock right after: the
    profiler may drop records, so the callers log that count beside the
    launches counted)."""
    dev, mhz = _device_events(fn)
    busy_us = sum(e.device_time_total for e in dev)
    names = kernel_name if isinstance(kernel_name, tuple) else (kernel_name,)
    kern = [e.device_time_total for e in dev if any(n in e.name for n in names)]
    return len(dev), busy_us / 1e3, sum(kern) / 1e3, len(kern), mhz


def _device_events(fn):
    """(CUDA events, SM clock right after) of one run of ``fn`` under
    torch.profiler (CUDA activity only), after a warm-up load."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):   # start-up, untimed
        torch.ones(1, device="cuda").sum()
    _warm()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    mhz = _sm_clock()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], mhz


def _traced_rays(render_args):
    """(closest-hit rays, shadow rays) of the render ``render_args`` gives:
    the same render once more with the tracer's stats summed on the device
    and read once at the end."""
    import tinyraytracing_tpu_torch.render as render_mod

    real, acc = render_mod.trace, {}

    def trace_stats(*a, **k):
        rad, stats = real(*a, return_stats=True, **k)
        for key, v in stats.items():
            acc[key] = acc.get(key, 0) + v.sum()
        return rad

    render_mod.trace = trace_stats
    try:
        a, k = render_args
        render_mod.render(*a, **k)
    finally:
        render_mod.trace = real
    return int(acc["primary"]), int(acc["shadow"])


def phase_cli_scan(dev, out_dir, refs, size=1024):
    """Two scan renders through the CLI, each with every launch count set to
    0 just before and read just after: grid:100000 with "auto" (a BVH is
    attached: the packet-BVH kernel) and cornell with "pallas" (the slot
    kernel). 1024x1024 at 1 spp is 16 chunks of 65,536 rays x 16 bounces x
    (1 closest hit + 1 shadow dispatch) = 512 launches of the kernel.

    Only the render call is timed (synchronised before and after); nothing
    inside it is wrapped. The same render is then run once more, timed the
    same way, and twice untimed: under torch.profiler for its kernel and
    device-busy time, and with the tracer's stats for the traced-ray
    count. Keeps grid:100000's image mean in ``refs["scan mean"]`` for
    phase 9."""
    n_chunks = -(-size * size // SCAN_CHUNK)
    expect = n_chunks * 16 * 2
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.utils import spans

    real_render = render_mod.render
    seen = {}

    def render_timed(*a, **k):
        seen["args"] = (a, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = real_render(*a, **k)
        torch.cuda.synchronize()
        seen.update(img=img, seconds=time.perf_counter() - t0)
        return img

    runs = (("grid:100000", "auto", "bvh_intersect"),
            ("cornell", "pallas", "slot_intersect"))
    ok, launches = True, {}
    for scene_arg, isect, kname in runs:
        argv = ["--scene", scene_arg, "--renderer", "scan", "--intersector",
                isect, "--width", str(size), "--height", str(size), "--spp", "1",
                "--out", f"{out_dir}/scan_{isect}.png"]
        seen.clear()
        torch.cuda.reset_peak_memory_stats()
        render_mod.render = render_timed
        try:
            with spans.recording() as rec:
                t0 = time.perf_counter()
                rc = cli.main(argv)
                wall = time.perf_counter() - t0
        finally:
            render_mod.render = real_render
        counts = _launches(rec, ("bvh_intersect", "slot_intersect", *TRACE_KERNELS))
        peak = torch.cuda.max_memory_allocated()
        img, secs = seen["img"], seen["seconds"]
        mean = float(img.mean())
        a, k = seen["args"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_render(*a, **k)                  # the same render, warm
        torch.cuda.synchronize()
        secs_again = time.perf_counter() - t0
        n_dev, busy_ms, kern_ms, n_kern, mhz = _profiled(
            lambda: real_render(*a, **k), kname)
        primary, shadow = _traced_rays(seen["args"])
        rays = primary + shadow
        render_ms = 1e3 * secs
        log(f"phase 3b: cli {' '.join(argv[:-2])} (spp cut from config 3's "
            f"512 to 1 only to fit the smoke's time limit) -> rc {rc}")
        log(f"  cli wall {wall:.2f}s incl. scene + BVH build; render "
            f"{secs:.3f}s, {rays} traced rays ({primary} closest-hit + "
            f"{shadow} shadow), {rays / secs:.4g} rays/s; the same render "
            f"again {secs_again:.3f}s, {rays / secs_again:.4g} rays/s")
        log(f"  the same render under torch.profiler: {n_dev} device ops "
            f"({n_dev / (n_chunks * 16):.0f} per bounce), {kern_ms:.1f} ms in "
            f"{n_kern} recorded launches of {kname} = "
            f"{100 * kern_ms / render_ms:.1f}% of the unprofiled "
            f"render, device busy {busy_ms:.1f} ms: the card idles "
            f"{100 * (1 - busy_ms / render_ms):.0f}%; {_mhz(mhz)} after it")
        log(f"  kernel launches {counts}; peak device memory "
            f"{peak / 2**20:.1f} MiB; image mean {mean:.6g}, shape "
            f"{tuple(img.shape)}")
        want = {k: (expect if k == kname else 0) for k in counts}
        ok &= (rc == 0 and counts == want and bool(torch.isfinite(img).all())
               and mean > 0)
        launches[kname] = counts[kname]
        if scene_arg == "grid:100000":
            refs["scan mean"] = mean
    return ok, launches


# ---------------------------------------------------------------------------
# phases 3c and 3d: the persistent renderer, and kernel 3 on the main path
# ---------------------------------------------------------------------------

def _timed_entry(name, stats_fn, seen):
    """A stand-in for ``render.<name>`` that runs ``stats_fn`` (the same
    render, returning (image, traced rays)) between two synchronisations
    and records its arguments, image, ray count and seconds in ``seen``."""
    def timed(*a, **k):
        seen["args"] = (a, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = stats_fn(*a, **k)
        torch.cuda.synchronize()
        seen.update(img=img, rays=float(rays), seconds=time.perf_counter() - t0)
        return (img, rays) if name == "render_fused_queue_chunked" else img
    return timed


def _render_report(label, wall, seen, counts, stats_fn, kernels):
    """Log one main-path render: wall and render time, rays/s, launches,
    and kernel and busy time from torch.profiler of the same render run
    again, whose image must be bitwise the first one's (same key, same
    image); returns (the image, whether the rerun's is bitwise equal)."""
    a, k = seen["args"]
    peak = torch.cuda.max_memory_allocated()        # the render's, unprofiled
    again = []
    n_dev, busy_ms, kern_ms, n_kern, mhz = _profiled(
        lambda: again.append(stats_fn(*a, **k)[0]), kernels)
    img, secs = seen["img"], seen["seconds"]
    same = torch.equal(again[0], img)
    render_ms = 1e3 * secs
    log(f"  {label}: wall {wall:.2f}s; render {secs:.3f}s, {seen['rays']:.0f} "
        f"traced rays, {seen['rays'] / secs:.4g} rays/s; peak device memory "
        f"{peak / 2**20:.1f} MiB; image mean "
        f"{float(img.mean()):.6g}, shape {tuple(img.shape)}")
    log(f"  kernel launches {counts}; the same render under torch.profiler: "
        f"{n_dev} device ops, {kern_ms:.1f} ms in {n_kern} recorded launches "
        f"of {'/'.join(kernels)} = "
        f"{100 * kern_ms / render_ms:.1f}% of the unprofiled render, device "
        f"busy {busy_ms:.1f} ms: the card idles "
        f"{100 * (1 - busy_ms / render_ms):.0f}%; {_mhz(mhz)} after it")
    log(f"  the same key again: image bitwise the first render's: {same}")
    return img, same


def phase_cli_persistent(dev, out_dir, refs):
    """Phase 3c: cornell through the CLI with "auto" (under 512 triangles:
    the persistent renderer) at 1024x1024, 4 spp, 262,144 lanes: 4 epochs
    of one merged bounce + shadow dispatch per iteration. Keeps (image,
    traced rays, seconds) in ``refs["fused"]`` for phase 9."""
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.integrator.fused import render_fused_stats
    from tinyraytracing_tpu_torch.utils import spans

    seen = {}
    real = render_mod.render_fused_image
    argv = ["--scene", "cornell", "--width", "1024", "--height", "1024",
            "--spp", "4", "--lanes", "262144", "--out", f"{out_dir}/cornell.png"]
    torch.cuda.reset_peak_memory_stats()
    render_mod.render_fused_image = _timed_entry("render_fused_image",
                                                 render_fused_stats, seen)
    try:
        with spans.recording() as rec:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
    finally:
        render_mod.render_fused_image = real
    counts = _launches(rec, TRACE_KERNELS)
    log(f"phase 3c: cli {' '.join(argv[:-2])} (auto: the persistent renderer, "
        f"4 epochs of 262,144 lanes) -> rc {rc}")
    img, same = _render_report("persistent cornell", wall, seen, counts,
                               render_fused_stats, ("trace_kernel",))
    refs["fused"] = (img.cpu(), seen["rays"], seen["seconds"])
    ok = (rc == 0 and same and counts["trace_closest"] > 0 and counts["trace_near"] == 0
          and counts["trace_occlusion"] == 0 and tuple(img.shape) == (1024, 1024, 3)
          and bool(torch.isfinite(img).all()) and float(img.mean()) > 0)
    return ok


def phase_near_queue(dev):
    """Phase 3d: grid:100000 (config 3, leaf 8) at 1024x1024, 4 spp through
    ``render_image`` with walk_order="near" (the chunked queue; every
    trace walks near-first, and shadow compaction and the morton resort
    follow the JAX package's auto rules), then the same call under
    preorder; the two images compared."""
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.utils import spans

    scene, cam = quad_grid(100_000, 1024, 1024, device=dev)       # leaf 8
    real = render_mod.render_fused_queue_chunked
    imgs, launches, ok = {}, {}, True
    log(f"phase 3d: render_image(grid:100000, 1024x1024, 4 spp, queue) "
        f"with walk_order near, then preorder ({scene.bvh.packed.n_wide} wide "
        f"nodes)")
    for order in ("near", "preorder"):
        seen = {}
        cfg = RenderConfig(walk_order=order)
        torch.cuda.reset_peak_memory_stats()
        render_mod.render_fused_queue_chunked = _timed_entry(
            "render_fused_queue_chunked", real, seen)
        try:
            with spans.recording() as rec:
                t0 = time.perf_counter()
                render_mod.render_image(scene, cam, cfg, spp=4, renderer="queue")
                wall = time.perf_counter() - t0
        finally:
            render_mod.render_fused_queue_chunked = real
        launches[order] = _launches(rec, TRACE_KERNELS)
        img, same = _render_report(order, wall, seen, launches[order], real,
                                   ("trace_kernel", "packet_dirs_kernel"))
        imgs[order] = img.reshape(cam.height, cam.width, 3).cpu()
        ok &= same and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    a, b = imgs["near"], imgs["preorder"]
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"  near vs preorder: {int((~close).sum())} of {close.numel()} pixels "
        f"outside rtol 1e-4/atol 1e-5 (bound: 1%), image means differ "
        f"{mean_rel:.3g} relative (bound 1e-4)")
    near = launches["near"]
    ok &= (near["trace_near"] > 0 and near["packet_dirs"] == near["trace_near"]
           and near["trace_closest"] == 0 and near["trace_occlusion"] == 0
           and bool(close.float().mean() >= 0.99) and mean_rel <= 1e-4)
    return ok, near


# ---------------------------------------------------------------------------
# phase 4: the same render on the card and on the CPU
# ---------------------------------------------------------------------------

def _compare_images(label, imgs, secs, size):
    a, b = imgs["cuda"], imgs["cpu"]
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)
    diff = (a - b).abs().amax(dim=-1)
    worst = int(diff.argmax())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"{label}: cuda {secs['cuda']:.2f}s, cpu {secs['cpu']:.2f}s; "
        f"{int((~close).sum())} of {close.numel()} pixels outside rtol 1e-4/"
        f"atol 1e-5 (bound: 1%), image means differ {mean_rel:.3g} relative "
        f"(bound 1e-4); worst pixel {divmod(worst, size)} off by "
        f"{float(diff.max()):.4g} ({a.view(-1, 3)[worst].tolist()} vs "
        f"{b.view(-1, 3)[worst].tolist()})")
    return bool(close.float().mean() >= 0.99) and mean_rel <= 1e-4


def phase_scan_vs_scan(dev):
    """Phase 4b: the scan render with intersector "bvh_pallas" on the card
    (the kernel) and on the CPU (its plain version)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data
    from tinyraytracing_tpu_torch.render import render

    cfg = RenderConfig(intersector="bvh_pallas")
    scene, cam = cornell_box(64, 64, device="cpu")
    scene = attach_bvh(scene, cfg)
    imgs, secs = {}, {}
    for where, s in (("cuda", scene.to(dev)), ("cpu", scene)):
        t0 = time.perf_counter()
        imgs[where] = render(s, cam, master_key_data(0), cfg, 2).cpu()
        secs[where] = time.perf_counter() - t0
    return _compare_images("phase 4b: scan cornell 64x64 @ 2 spp, bvh_pallas",
                           imgs, secs, 64)


def phase_persistent_vs_persistent(dev):
    """Phase 4c: the persistent render of cornell on the card (the closest
    hit kernel) and on the CPU (its plain version)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused import render_fused_image
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    cfg = RenderConfig()
    scene, cam = cornell_box(64, 64, device="cpu")
    scene = attach_bvh(scene, cfg)
    imgs, secs = {}, {}
    for where, s in (("cuda", scene.to(dev)), ("cpu", scene)):
        t0 = time.perf_counter()
        imgs[where] = render_fused_image(s, cam, master_key_data(0), cfg,
                                         2).cpu()
        secs[where] = time.perf_counter() - t0
    return _compare_images("phase 4c: persistent cornell 64x64 @ 2 spp",
                           imgs, secs, 64)


def phase_resume(dev, tmp):
    """Phase 5: the chunked queue render of grid:6000 (64x64, 4 spp, 4096
    lanes) with a snapshot after every chunk, interrupted after three
    chunks and resumed, against the one-shot render: bitwise (the image
    scatter adds in a fixed order), the same ray count, the resume
    continuing from the snapshot, and the snapshot removed at the end."""
    import os

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused_queue import (
        render_fused_queue, render_fused_queue_chunked,
    )
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    class Interrupted(Exception):
        pass

    scene, cam = quad_grid(6000, 64, 64, device=dev)
    cfg, key = RenderConfig(), master_key_data(0)
    one, rays = render_fused_queue(scene, cam, key, cfg, 4, lanes=4096)
    path = f"{tmp}/queue.npz"
    kw = dict(lanes=4096, target_chunk_s=1e-9, checkpoint_path=path,
              checkpoint_every_s=0.0)
    first, then = [], []

    def stop(it, counter, seconds):
        first.append(it)
        if len(first) == 3:
            raise Interrupted

    try:
        render_fused_queue_chunked(scene, cam, key, cfg, 4, progress=stop, **kw)
    except Interrupted:
        pass
    saved = os.path.exists(path)
    got, rays2 = render_fused_queue_chunked(
        scene, cam, key, cfg, 4, resume=True,
        progress=lambda it, counter, seconds: then.append(it), **kw)
    cleared = not os.path.exists(path)
    same = torch.equal(got, one)
    err = float((got - one).abs().max())
    log(f"phase 5: chunked grid:6000 64x64 @ 4 spp, 4096 lanes: interrupted "
        f"after iterations {first} (snapshot written: {saved}), resumed at "
        f"{then[0]} of {then[-1]} iterations; bitwise the one-shot render: "
        f"{same} (max abs diff {err:.3g}); rays {float(rays2):.0f} vs "
        f"{float(rays):.0f}; snapshot removed: {cleared}")
    return (saved and cleared and then[0] > first[1] and same
            and float(rays2) == float(rays))


def phase_render_vs_render(dev):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    scene, cam = quad_grid(6000, 64, 64, device="cpu")
    cfg, key = RenderConfig(), master_key_data(0)
    imgs, secs = {}, {}
    for where, s in (("cuda", scene.to(dev)), ("cpu", scene)):
        t0 = time.perf_counter()
        img, _ = render_fused_queue(s, cam, key, cfg, 4, lanes=4096)
        imgs[where] = img.cpu().reshape(64, 64, 3)
        secs[where] = time.perf_counter() - t0
    return _compare_images("phase 4: grid:6000 64x64 @ 4 spp, 4096 lanes",
                           imgs, secs, 64)


# ---------------------------------------------------------------------------
# phase 6: the differentiable fast path (diff/) on the trace kernels
# ---------------------------------------------------------------------------

DIFF_DEPTH, DIFF_SPP = 3, 2
# card against CPU, stated before the first card run: the loss within
# 1e-4 relative, and each gradient within 1e-2 of its norm (L2): the
# paths are the same arithmetic on both, but for the order of float adds
# in sums and in the replay's scatter, and a grazing decision that flips
# moves one pixel's paths (phase 4c: 4 of 4,096 pixels)
DIFF_LOSS_RTOL, DIFF_GRAD_RTOL = 1e-4, 1e-2


def _loss_and_grads(scene, cam, fields, cfg, key, target, counts=None,
                    loss_fn=None, **kw):
    """``render_loss_fast`` (or ``loss_fn``) forward and backward on
    ``fields``, with the keywords ``kw``: (loss, {field: gradient}). With
    ``counts`` (a dict), the kernels' launches of the forward and of the
    backward are recorded in it, each counted from 0."""
    from tinyraytracing_tpu_torch.diff import SceneParams, render_loss_fast

    p = SceneParams.init_from(scene, cam, *fields)
    for t in p.tensors():
        t.requires_grad_(True)
    loss, counts_fwd = _counted(lambda: (loss_fn or render_loss_fast)(
        p, scene, cam, key, target, cfg, DIFF_SPP, **kw))
    _, counts_bwd = _counted(loss.backward)
    if counts is not None:
        counts.update(forward=counts_fwd, backward=counts_bwd)
    return loss.detach(), {f: getattr(p, f).grad for f in fields}


def _profile_loss(label, run, kernel, launches_ok, repeat=True):
    """One main-path run of a loss's forward + backward (``run(counts)``
    records the launches of each in ``counts``): warmed once, timed alone
    with its peak memory, then run again under torch.profiler. Logs the
    seconds, loss, peak memory, launches, device ops, busy/idle share, the
    device time of the kernels whose name holds ``kernel``, the sorted
    ``indexing_backward`` kernels, the top three device ops, and whether
    the timed run's loss and gradients are bitwise the warm run's (the
    same key). Returns (ok, seconds, {"forward": launches, "backward":
    launches}): ok holds a finite positive loss, finite non-zero
    gradients, ``launches_ok(forward, backward)`` and, with ``repeat``,
    the bitwise rerun."""
    loss0, grads0 = run()                  # warm: allocator, records
    counts = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = run(counts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = torch.equal(loss, loss0) and all(torch.equal(grads[f], grads0[f])
                                            for f in grads)
    del loss0, grads0
    peak = torch.cuda.max_memory_allocated()
    events, mhz = _device_events(run)
    ms = 1e3 * secs
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    kern = [e.device_time_total for e in events if kernel in e.name]
    sorted_bw = [e.device_time_total for e in events
                 if "indexing_backward" in e.name]
    fwd, bwd = counts["forward"], counts["backward"]
    log(f"  {label}: forward + backward {secs:.3f} s; loss {float(loss):.6g}; "
        f"peak device memory {peak / 2**20:.1f} MiB; launches forward {fwd}, "
        f"backward {bwd}")
    log(f"    under torch.profiler: {len(events)} device ops, device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / ms:.1f}% of the unprofiled "
        f"{ms:.1f} ms (idle {100 * (1 - busy_ms / ms):.0f}%); {kernel} "
        f"{sum(kern) / 1e3:.3f} ms in {len(kern)} recorded launches, the "
        f"other device ops {busy_ms - sum(kern) / 1e3:.1f} ms; sorted "
        f"indexing_backward kernels {len(sorted_bw)}, "
        f"{sum(sorted_bw) / 1e3:.2f} ms; {_mhz(mhz)} after it")
    log("    the most device time: " + "; ".join(
        f"{name[:60]} {t:.1f} ms" for name, t in _top_ops(events)))
    log(f"    the same key again: loss and gradients bitwise the warm run's: "
        f"{same}{'' if repeat else ' (logged, not required)'}")
    ok = (bool(torch.isfinite(loss)) and float(loss) > 0
          and all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
                  for g in grads.values())
          and launches_ok(fwd, bwd) and (same or not repeat))
    return ok, secs, counts


def _summed(counts):
    """A loss's launches of forward + backward, per kernel."""
    return {k: v + counts["backward"][k] for k, v in counts["forward"].items()}


def _diff_report(label, scene, cam, fields, cfg, key):
    """One main-path run of the fast path on the card: ``_profile_loss`` of
    ``render_loss_fast`` (the trace kernels' device time), and the forward
    alone for the traced-ray count. Returns (ok, launch counts of the
    forward and of the backward)."""
    from tinyraytracing_tpu_torch.diff import SceneParams, apply_params, render_diff

    target = torch.zeros(cam.height, cam.width, 3, device=scene.device)
    run = lambda counts=None: _loss_and_grads(scene, cam, fields, cfg, key,
                                              target, counts)
    ok, secs, counts = _profile_loss(
        f"{label}, max_depth {cfg.max_depth}, {DIFF_SPP} spp, params "
        f"{'+'.join(fields)} (launches of the backward: the checkpointed "
        f"bounces' recompute)", run, "trace_kernel",
        lambda fwd, bwd: (fwd["trace_closest"] > 0 and fwd["trace_occlusion"] > 0
                          and bwd["trace_closest"] > 0
                          and bwd["scatter_fixed"] > 0
                          and fwd["scatter_fixed"] == 0
                          and all(c[k] == 0 for c in (fwd, bwd) for k in
                                  ("trace_near", "bvh_intersect",
                                   "slot_intersect", "scatter_rows"))))
    with torch.no_grad():
        s2, c2 = apply_params(scene, cam,
                              SceneParams.init_from(scene, cam, *fields))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rays = render_diff(s2, c2, key, cfg, DIFF_SPP, return_rays=True)
        rays = float(rays)
        fwd_secs = time.perf_counter() - t0
    log(f"    {rays:.0f} traced rays: {rays / secs:.4g} rays/s forward + "
        f"backward; the forward alone {fwd_secs:.3f} s, "
        f"{rays / fwd_secs:.4g} rays/s")
    return ok, counts


def phase_diff(dev, refs):
    """Phase 6: the fast differentiable path (``diff.fast``) on the card,
    at BASELINE config 4's scene: ``render_loss_fast`` forward + backward
    on cornell 512x512 in kd + vertex_offset (its gradients repeat bitwise;
    every cotangent scatter of one more run kept in ``refs["scatter
    fixed"]`` for phase 6b); four ``make_train_step``
    steps there in kd; one forward + backward in vertex_offset on
    grid:100000 512x512 (a refit of its tree every call), and that
    refit's own time; then the gradients on the card against the CPU's
    at 32x32. Returns (ok, the cornell run's launch counts)."""
    import math

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff import (
        SceneParams, make_train_step, render_diff, render_loss_fast,
    )
    from tinyraytracing_tpu_torch.diff.refit import refit_bvh
    from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
    from tinyraytracing_tpu_torch.ops import lookup
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    cfg, key = RenderConfig(max_depth=DIFF_DEPTH), master_key_data(0)
    log("phase 6: the differentiable fast path (render_loss_fast: trace "
        "kernels forward, path replay backward)")
    scene, cam = cornell_box(512, 512, device=dev)
    scene = attach_bvh(scene, cfg)
    ok, counts = _diff_report("cornell 512x512", scene, cam,
                              ("kd", "vertex_offset"), cfg, key)
    # every cotangent scatter of one more forward + backward, for phase 6b
    with _captured_scatter(lookup, "scatter_add_rows_fixed") as kept:
        _loss_and_grads(scene, cam, ("kd", "vertex_offset"), cfg, key,
                        torch.zeros(512, 512, 3, device=dev))
    refs["scatter fixed"] = kept

    # Adam in kd: on the cornell box a vertex step beyond the tie band
    # flips the emissive tie-break of the light, coplanar with the ceiling
    with torch.no_grad():
        target = render_diff(scene, cam, key, cfg, DIFF_SPP)
    step, init = make_train_step(scene, cam, target, cfg, DIFF_SPP,
                                 learning_rate=0.02, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=scene.kd * 0.5 + 0.1))
    losses = []
    t0 = time.perf_counter()
    for _ in range(4):
        state, loss = step(state, key)
        losses.append(float(loss))
    log(f"  make_train_step (Adam, lr 0.02) in kd from kd/2 + 0.1 toward the "
        f"render at kd, cornell 512x512: losses {losses} in "
        f"{time.perf_counter() - t0:.2f} s")
    ok &= all(map(math.isfinite, losses)) and losses[-1] < losses[0]

    grid, gcam = quad_grid(100_000, 512, 512, device=dev)
    grid = attach_bvh(grid, cfg)
    log(f"  grid:100000: {grid.num_triangles} triangles, {grid.bvh.n_nodes} "
        f"binary nodes in {grid.bvh.n_levels} levels, {grid.bvh.packed.n_wide} "
        f"wide nodes, builder {grid.bvh.builder}")
    ok_g, _ = _diff_report("grid:100000 512x512", grid, gcam,
                           ("vertex_offset",), cfg, key)
    ok &= ok_g and grid.bvh.builder == "native"
    with torch.no_grad():
        refit = lambda: refit_bvh(grid)
        events, mhz = _device_events(lambda: [refit() for _ in range(10)])
        dev_ms = sum(e.device_time_total for e in events) / 1e3 / 10
        host_ms = _host_ms(refit, 10)
    log(f"  refit_bvh of grid:100000's tree: {dev_ms:.3f} ms device (the sum "
        f"of its launches under torch.profiler over 10 calls, / 10), "
        f"{host_ms:.3f} ms host-inclusive per call; {_mhz(mhz)} after it")

    # the card against the CPU at 32x32
    small, scam = cornell_box(32, 32, device="cpu")
    small = attach_bvh(small, cfg)
    fields = ("kd", "radiance", "vertex_offset", "eye")
    out = {}
    for where in ("cuda", "cpu"):
        s = small.to(where)
        t0 = time.perf_counter()
        loss, grads = _loss_and_grads(
            s, scam, fields, cfg, key, torch.zeros(32, 32, 3, device=where))
        out[where] = (float(loss), {f: g.cpu() for f, g in grads.items()},
                      time.perf_counter() - t0)
    (lc, gc, tc), (lp, gp, tp) = out["cuda"], out["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    errs = {f: float((gc[f] - gp[f]).norm() / gp[f].norm()) for f in fields}
    log(f"  card vs CPU, cornell 32x32 in {'+'.join(fields)}: cuda "
        f"{tc:.2f} s, cpu {tp:.2f} s; loss {lc:.7g} vs {lp:.7g} ({loss_rel:.3g} "
        f"relative, bound {DIFF_LOSS_RTOL:g}); gradient distance / norm "
        + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
        + f" (bound {DIFF_GRAD_RTOL:g})")
    ok &= loss_rel <= DIFF_LOSS_RTOL and all(
        e <= DIFF_GRAD_RTOL for e in errs.values())
    ok_s, counts["scan"] = _scan_loss_report(dev, key)
    ok &= ok_s
    log(f"phase 6: {'ok' if ok else 'FAILED'}")
    return ok, counts


SCAN_LOSS_FIELDS = ("kd", "radiance")


def _scan_loss_setup(dev):
    """Phase 6's scan ``render_loss`` case: (scene, cam, cfg, target) of
    cornell 512x512 under ``intersector="bvh_pallas"`` (kernel 4) at phase
    6's depth, the loss taken in SCAN_LOSS_FIELDS."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    cfg = RenderConfig(intersector="bvh_pallas", max_depth=DIFF_DEPTH)
    scene, cam = cornell_box(512, 512, device=dev)
    target = torch.zeros(cam.height, cam.width, 3, device=dev)
    return attach_bvh(scene, cfg), cam, cfg, target


def _scan_loss_report(dev, key):
    """``_profile_loss`` of ``render_loss`` over the scan renderer
    (``_scan_loss_setup``): kernel 4 launches spp x chunks x bounces x 2
    times in the forward and none in the backward; the log shows whether a
    sorted ``indexing_backward`` kernel remains. Returns (ok, launches of
    forward + backward)."""
    from tinyraytracing_tpu_torch.diff import render_loss

    scene, cam, cfg, target = _scan_loss_setup(dev)
    run = lambda counts=None: _loss_and_grads(scene, cam, SCAN_LOSS_FIELDS, cfg,
                                              key, target, counts, render_loss)
    want = DIFF_SPP * -(-cam.width * cam.height // cfg.ray_chunk) * cfg.max_depth * 2
    ok, _, counts = _profile_loss(
        f"render_loss (scan, bvh_pallas) cornell 512x512, max_depth "
        f"{cfg.max_depth}, {DIFF_SPP} spp, params {'+'.join(SCAN_LOSS_FIELDS)} "
        f"(kernel 4 expected {want} + 0; the cotangent scatter in the "
        f"backward)", run, "bvh_intersect",
        lambda fwd, bwd: (fwd["bvh_intersect"] == want
                          and all(v == 0 for k, v in fwd.items()
                                  if k != "bvh_intersect")
                          and bwd["scatter_fixed"] > 0
                          and all(v == 0 for k, v in bwd.items()
                                  if k != "scatter_fixed")))
    return ok, _summed(counts)


# ---------------------------------------------------------------------------
# phase 6b: the scatter kernels (csrc/scatter_add.cu) on the main paths' calls
# ---------------------------------------------------------------------------

# a spin kernel's cycles (torch.cuda._sleep): ~20 ms at 1,980 MHz, longer
# than the host takes to queue a timed set of calls behind it
SPIN_CYCLES = 40_000_000


def _device_total_ms(fn, n=20):
    """(device ms of one call of ``fn``, SM clock MHz after): CUDA events
    around ``n`` back-to-back calls queued behind a spin kernel, after one
    untimed call and a warm-up load. The host queues the calls while the card spins, so the
    events time the card's own work: every kernel of a call (a sort, a
    fill, the levels) and the gaps between them, with no record dropped
    (torch.profiler drops some). Where the host took longer to queue them
    than the spin lasted, the log says so: the time is then partly the
    host's."""
    fn()                          # the allocator's blocks, the libraries
    _warm()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    s0, s1, e0, e1 = ev(), ev(), ev(), ev()
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    s1.record()
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    e1.record()
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)
    if host_ms > spin_ms:
        log(f"    (the host took {host_ms:.1f} ms to queue {n} calls, the spin "
            f"lasted {spin_ms:.1f} ms: the time is partly the host's)")
    return e0.elapsed_time(e1) / n, _sm_clock()


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32).cpu(),
                       b.contiguous().view(torch.int32).cpu())


def _ops_text(ops, want):
    return (f"{ops} device ops a call (the nodes of its CUDA graph; at most "
            f"{want})")


def _never_synchronizes(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): True unless
    it raises (a read back to the host)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return True
    except RuntimeError as e:
        log(f"    synchronized: {e}")
        return False
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def _scatter_rows_case(label, dev, args, iterations):
    """The image scatter of one main-path iteration (``args``: its CPU
    copies): the kernel bitwise its plain version and the CPU's index_add_
    on the rows below ``keep``; device time per call against a library
    stable sort of the same rows alone, index_add_ (atomics) and
    index_put_ with accumulate (the deterministic library path), each into
    the same image; the device ops of a call and a run under the sync
    debug mode. Returns (ok, case dict)."""
    from tinyraytracing_tpu_torch.ops import scatter as sc

    dst0, dim, rows, src, keep = args
    cpu = dst0.clone().index_add_(dim, rows, src)
    dst0, rows, src = dst0.to(dev), rows.to(dev), src.to(dev)
    got = sc.scatter_add_rows(dst0.clone(), dim, rows, src, keep)
    plain = sc.scatter_add_rows_plain(dst0.clone(), dim, rows, src, keep)
    part = (slice(None), slice(0, keep)) if dim == 1 else (slice(0, keep),)
    same = _bits_equal(got[part], plain[part]) and _bits_equal(got[part], cpu[part])
    err = float((got[part] - plain[part]).abs().max())
    buf = dst0.clone()
    idx = ((torch.arange(dst0.shape[0], device=dev)[:, None], rows[None, :])
           if dim == 1 else (rows,))
    call = lambda: sc.scatter_add_rows(buf, dim, rows, src, keep)
    ms, mhz = _device_total_ms(call)
    host = _host_ms(call)
    ops = _tests_module("torch_scatter_emulate").device_ops(call)
    quiet = _never_synchronizes(call)
    sort_ms, _ = _device_total_ms(lambda: torch.sort(rows.to(torch.int32), stable=True))
    add_ms, _ = _device_total_ms(lambda: buf.index_add_(dim, rows, src))
    put_ms, _ = _device_total_ms(lambda: buf.index_put_(idx, src, accumulate=True))
    plain_ms = _events_ms(lambda: sc.scatter_add_rows_plain(buf, dim, rows, src,
                                                            keep), 3)
    n, C = rows.numel(), src.shape[1 - dim]
    use = (rows >= 0) & (rows < keep)
    n_kept, D = int(use.sum()), int(torch.unique(rows[use]).numel())
    # every row id read once, the kept values once, each row added into
    # read and written once (a dropped lane's values are never read)
    bound, by = _bound(C * n_kept,
                       rows.element_size() * n + 4 * C * n_kept + 8 * C * D)
    want_ops = sc.DEVICE_OPS["scatter_rows"]
    log(f"  {label}: {n:,} lanes into {tuple(dst0.shape)} along dim {dim}, "
        f"{n_kept:,} kept into {D:,} rows: bitwise its plain version and the "
        f"CPU's index_add_: {same} (max abs diff {err:.3g}); device "
        f"{ms:.4f} ms a call (host-inclusive {host:.4f}), "
        f"{_ops_text(ops, want_ops)}, no host synchronization: {quiet}; a "
        f"library stable sort of the rows alone {sort_ms:.4f}; index_add_ "
        f"{add_ms:.4f} (the kernel {ms / add_ms:.2f}x it), index_put_ "
        f"(accumulate) {put_ms:.4f}; plain {plain_ms:.2f}; bound {bound:.5f} "
        f"({by}); x {iterations} iterations: {ms * iterations:.2f} ms against "
        f"index_add_'s {add_ms * iterations:.2f}; {_mhz(mhz)} after it")
    ok = same and quiet and 0 < ops <= want_ops
    return ok, dict(ms=ms, device_ms=ms, host_ms=host, sort_ms=sort_ms,
                    library_ms=add_ms, index_put_ms=put_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, max_abs_err=err,
                    iterations=iterations, sm_mhz=mhz, ops_per_call=ops)


def _scatter_edge_cases(dev):
    """Both kernels bitwise their plain versions on the edge cases of the
    CPU tests (tests/torch_scatter_emulate.py): rows past keep and
    negative, one row taking every value, every row unique, fewer than 32
    values, a short last block, no values, 256 and 257 rows."""
    from tinyraytracing_tpu_torch.ops import scatter as sc

    emu = _tests_module("torch_scatter_emulate")
    on = lambda a: torch.from_numpy(a).to(dev)
    bad = []
    for case in emu.ROWS_CASES:
        rows, dst, src, dim, keep = emu.rows_case(case)
        rows, dst, src = on(rows), on(dst), on(src)
        got = sc.scatter_add_rows(dst.clone(), dim, rows, src, keep)
        if not _bits_equal(got, sc.scatter_add_rows_plain(dst.clone(), dim, rows,
                                                          src, keep)):
            bad.append(f"rows: {case}")
    for case in emu.FIXED_CASES:
        rows, src, n_rows = emu.fixed_case(case)
        rows, src = on(rows), on(src)
        if not _bits_equal(sc.scatter_add_rows_fixed(n_rows, rows, src),
                           sc.scatter_add_rows_fixed_plain(n_rows, rows, src)):
            bad.append(f"fixed: {case}")
    log(f"  edge cases ({len(emu.ROWS_CASES)} image, {len(emu.FIXED_CASES)} "
        f"cotangent): bitwise their plain versions: "
        f"{'all' if not bad else 'NOT ' + ', '.join(bad)}")
    return not bad


def phase_scatter(dev, refs, reports, counts):
    """Phase 6b: both scatter kernels on copies of their main paths' own
    calls, held bitwise to their plain versions on the card (and to the
    CPU's), timed against the library calls they replace: the image
    scatter of phase 3's queue render and of phase 8's ``render_regen``
    (iteration SCATTER_PICK; ``counts``: their iterations), and every
    cotangent scatter of one phase-6 forward + backward of cornell
    512x512 in kd + vertex_offset, alone and summed over the call; each
    call's device ops and a run under the sync debug mode; then the edge
    cases of the CPU tests."""
    from tinyraytracing_tpu_torch.ops import scatter as sc

    log("phase 6b: the fixed-order scatter kernels (csrc/scatter_add.cu, no "
        "TPU counterpart) on the main paths' own calls; device time per call "
        "from CUDA events around calls queued behind a spin kernel")
    ok = True
    rep = {"cases": {}}
    for key, label, its in (
            ("scatter rows", "queue image, grid:100000 1024x1024, 4 spp",
             counts["queue"]),
            ("scatter rows regen", "render_regen image, grid:100000 "
             "1024x1024, 1 spp", counts["regen"])):
        (args,) = refs[key]
        same, case = _scatter_rows_case(f"{label}, iteration {SCATTER_PICK}",
                                        dev, args, its)
        ok &= same
        rep["cases"][label] = case
        if key == "scatter rows":              # the main path's
            rep.update(case)
    reports["scatter_rows"] = rep

    calls = [(n, r.to(dev), g.to(dev)) for n, r, g in refs["scatter fixed"]]
    errs, same = [], True
    for n_rows, rows, g in calls:
        got = sc.scatter_add_rows_fixed(n_rows, rows, g)
        plain = sc.scatter_add_rows_fixed_plain(n_rows, rows, g)
        same &= _bits_equal(got, plain)
        errs.append(float((got - plain).abs().max()))
    # the call with the longest runs (the most rows into the fewest) on
    # the CPU too: the plain version is the same adds on any device
    n_rows, rows, g = max(calls, key=lambda c: c[1].numel() / c[0])
    cpu_same = _bits_equal(sc.scatter_add_rows_fixed(n_rows, rows, g),
                           sc.scatter_add_rows_fixed_plain(n_rows, rows.cpu(),
                                                           g.cpu()))
    zeros = lambda n, g: torch.zeros((n, *g.shape[1:]), device=dev)
    one = dict(
        kernel=lambda: sc.scatter_add_rows_fixed(n_rows, rows, g),
        index_add=lambda: zeros(n_rows, g).index_add_(0, rows, g),
        index_put=lambda: zeros(n_rows, g).index_put_((rows,), g, accumulate=True))
    t1 = {k: _device_total_ms(f)[0] for k, f in one.items()}
    host = _host_ms(one["kernel"])
    mhz = _sm_clock()
    emu = _tests_module("torch_scatter_emulate")
    each = [emu.device_ops(lambda: sc.scatter_add_rows_fixed(n, r, x))
            for n, r, x in {c[0]: c for c in calls}.values()]
    ops = max(each)
    quiet = _never_synchronizes(lambda: [sc.scatter_add_rows_fixed(n, r, x)
                                         for n, r, x in calls])
    plain_ms = _events_ms(lambda: sc.scatter_add_rows_fixed_plain(n_rows, rows, g), 3)
    n, C = rows.numel(), g[0].numel()
    D = int(torch.unique(rows).numel())
    bound, by = _bound(C * (n - D), rows.element_size() * n + 4 * C * n
                       + 4 * C * n_rows)
    every = dict(
        kernel=lambda: [sc.scatter_add_rows_fixed(n, r, x) for n, r, x in calls],
        index_add=lambda: [zeros(n, x).index_add_(0, r, x) for n, r, x in calls],
        index_put=lambda: [zeros(n, x).index_put_((r,), x, accumulate=True)
                           for n, r, x in calls])
    tall = {k: _device_total_ms(f, 2)[0] for k, f in every.items()}
    shapes = sorted({(c[1].numel(), c[0], c[2][0].numel()) for c in calls})
    want_ops = sc.DEVICE_OPS["scatter_fixed"]
    log(f"  cotangents: {len(calls)} scatters in one cornell 512x512 forward + "
        f"backward (rows, table rows, channels: {shapes}); each bitwise its "
        f"plain version on the card: {same} (max abs diff {max(errs):.3g}); "
        f"the call of {n:,} rows into {n_rows} ({C} channels) also on the "
        f"CPU: {cpu_same}; {_ops_text(ops, want_ops)}; no host "
        f"synchronization in all {len(calls)}: {quiet}")
    log(f"    that call: kernel {t1['kernel']:.4f} ms device (host-inclusive "
        f"{host:.4f}), index_add_ {t1['index_add']:.4f}, index_put_ "
        f"(accumulate) {t1['index_put']:.4f}, plain {plain_ms:.2f}; bound "
        f"{bound:.5f} ({by}); {_mhz(mhz)} after it")
    log(f"    all {len(calls)} of them: kernel {tall['kernel']:.3f} ms device, "
        f"index_add_ {tall['index_add']:.3f}, index_put_ {tall['index_put']:.3f}")
    ok &= same and cpu_same and quiet and 0 < min(each) and ops <= want_ops
    reports["scatter_fixed"] = dict(
        ms=t1["kernel"], device_ms=t1["kernel"], host_ms=host,
        library_ms=t1["index_add"], index_put_ms=t1["index_put"],
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=max(errs),
        sm_mhz=mhz, ops_per_call=ops,
        cases={"every cotangent scatter of one forward + backward":
               dict(calls=len(calls), ms=tall["kernel"],
                    library_ms=tall["index_add"],
                    index_put_ms=tall["index_put"])})
    ok &= _scatter_edge_cases(dev)
    log(f"phase 6b: {'ok' if ok else 'FAILED'}")
    return ok


# ---------------------------------------------------------------------------
# phase 2c: the threefry kernels (csrc/rng.cu) at the main paths' shapes
# ---------------------------------------------------------------------------

RNG_KERNELS = ("threefry_draws", "threefry_path_keys")
# (lanes, draws, bounce a plane?) of the main paths' calls: the queue and
# persistent loops' 4,194,304 lanes, and render_loss_fast's 1024x1024 at
# 2 spp with one bounce for every lane (a 0-d tensor)
RNG_CALLS = ((4_194_304, 9, True), (2_097_152, 9, False))
RNG_KEY = (2**31 + 7, 2**32 - 1)  # master key words of the path-key calls
RNG_SEED = 3_000_000_017          # the renders' master key seed


def _rng_bound(R, n, bounce_plane=True):
    """(ms, "operations" | "bytes"): the least time of a threefry call of
    ``R`` lanes, ``n`` draws (0: the path keys): its 32-bit integer
    operations, one instruction each at the card's issue rate (INSTR_RATE,
    whichever pipe takes them), against each plane's bytes moved once at
    PEAK_BYTES. A threefry2x32 block is 77 operations (20 rounds of an
    add, a rotate and an xor; the counter plus the key; five injections of
    3), the key's parity word 2, a draw 3 (a shift, a conversion, a
    product)."""
    if n:
        ops, nbytes = 2 + 77 * ((n + 1) // 2) + 3 * n, 16 + 8 * bounce_plane + 4 * n
    else:
        ops, nbytes = 2 + 77, 8 + 16
    t_ops, t_bytes = R * ops / INSTR_RATE, R * nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _rng_inputs(R, plane, dev):
    """(k0, k1, bounce) on ``dev`` from a seed: random 32-bit key words,
    the first lanes at and above 2^31 and at 2^32 - 1; bounces 0 to 16 as
    a plane, or one word (0-d) for every lane."""
    gen = torch.Generator().manual_seed(R + plane)
    k0, k1 = (torch.randint(0, 2**32, (R,), dtype=torch.int64, generator=gen)
              for _ in range(2))
    edge = torch.tensor([2**31, 2**32 - 1, 0, 2**31 - 1, 2**31 + 1], dtype=torch.int64)
    k0[:5], k1[:5] = edge, edge.flip(0)
    bounce = (torch.randint(0, 17, (R,), dtype=torch.int64, generator=gen) if plane
              else torch.tensor(3, dtype=torch.int64))
    return k0.to(dev), k1.to(dev), bounce.to(dev)


def _rng_calls(R, n, plane, dev):
    """{kernel: (label, the wrapper's call, the plain version's, bound)} of
    one main-path shape: the draws, and the path keys of the same lanes
    (``k1`` as the path ids)."""
    from tinyraytracing_tpu_torch.ops import rng

    k0, k1, b = _rng_inputs(R, plane, dev)
    return {
        "threefry_draws": (
            f"{R:,} lanes, n = {n}, bounce {'a plane' if plane else '0-d'}",
            lambda: rng.bounce_uniforms(k0, k1, b, n),
            lambda: rng.bounce_uniforms_plain(k0, k1, b, n), _rng_bound(R, n, plane)),
        "threefry_path_keys": (
            f"{R:,} lanes", lambda: rng.path_keys(RNG_KEY, k1),
            lambda: rng.path_keys_plain(RNG_KEY, k1), _rng_bound(R, 0))}


def _cell(name):
    """(configuration, traffic) of the benchmark's cell ``name``, as its
    registry of cells holds them (BENCHMARK.json, portbench/configs/ and
    portbench/traffic/)."""
    root = os.path.dirname(os.path.abspath(__file__))

    def read(*path):
        with open(os.path.join(root, *path)) as f:
            return json.load(f)

    (cell,) = [w for w in read("BENCHMARK.json")["workloads"] if w["name"] == name]
    return (read("portbench", "configs", f"{cell['config']}.json"),
            read("portbench", "traffic", f"{cell['traffic']}.json"))


def _cell_renders(dev):
    """(label, render) of one unit of each one-card render cell, at its
    shapes (``_cell``) on the port's procedural scenes, from the key
    fold_in(master_key_data(RNG_SEED), 0): a grid100k bucket of the queue
    loop (the chunked driver, the first path slice) and a cornell pass4
    pass of the persistent loop; ``render()`` -> (image, rays)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused import render_fused
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue_chunked
    from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
    from tinyraytracing_tpu_torch.ops import rng
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    key = rng.fold_in(rng.master_key_data(RNG_SEED), 0)
    rc = lambda cfg: RenderConfig(max_depth=cfg["max_depth"], p_rr=cfg["p_rr"],
                                  leaf_size=cfg["leaf_size"])
    cfg, tr = _cell("grid100k.bucket512")
    grid, cam = quad_grid(cfg["scene"]["triangles"], cfg["width"], cfg["height"],
                          device=dev)
    yield "grid100k.bucket512, bucket 0", lambda: render_fused_queue_chunked(
        grid, cam, key, rc(cfg), tr["spp"], lanes=tr["lanes"], path_lo=0,
        n_paths=tr["bucket_pixels"] * tr["spp"])
    cfg, tr = _cell("cornell.pass4")
    box, cam = cornell_box(tr["width"], tr["height"], device=dev)
    box = attach_bvh(box, rc(cfg))
    yield "cornell.pass4, pass 0", lambda: render_fused(
        box, cam, key, rc(cfg), tr["spp"], lanes=tr["lanes"])


def phase_rng(dev, reports):
    """Phase 2c: both threefry kernels bitwise their plain versions (the
    int64 chain, on the card) at the main paths' shapes (``RNG_CALLS``),
    each with a storage a plane and a run under the sync debug mode, timed
    beside their bound and the plain chain's device time; then one unit
    of each one-card render cell (``_cell_renders``), whose loops launch
    each kernel once an iteration (the wrappers' ``launches.*`` counters
    against ``queue.iterations`` / ``fused.iterations``). Returns (ok,
    launches)."""
    from tinyraytracing_tpu_torch.utils import spans

    log("phase 2c: the threefry kernels (csrc/rng.cu, no TPU counterpart: "
        "XLA fuses the same chain) against the int64 chain on the card; "
        "the plain chain's device time from CUDA events around a call "
        "queued behind a spin kernel")
    ok = True
    for i, (R, n, plane) in enumerate(RNG_CALLS):
        for name, (label, fn, plain, (bound, by)) in _rng_calls(R, n, plane, dev).items():
            got, want = fn(), plain()
            same = len(got) == len(want) and all(map(_bits_equal, got, want))
            own = len({g.untyped_storage().data_ptr() for g in got}) == len(got)
            quiet = _never_synchronizes(fn)
            dev_ms, host_ms, mhz = _times(fn, (name,))
            plain_ms, _ = _device_total_ms(plain, 1)
            log(f"  {name}, {label}: bitwise the plain chain {same}; a storage "
                f"a plane {own}; no host synchronization {quiet}; device "
                f"{dev_ms:.4f} ms a call (host-inclusive {host_ms:.4f}), bound "
                f"{bound:.4f} ({by}), the plain chain {plain_ms:.3f} ms device; "
                f"{_mhz(mhz)} after it")
            ok &= same and own and quiet
            case = dict(ms=dev_ms, device_ms=dev_ms, host_ms=host_ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, max_abs_err=0.0 if same else None,
                        sm_mhz=mhz)
            rep = reports.setdefault(name, {})
            rep.setdefault("cases", {})[label] = case
            if i == 0:                         # the render loops' call
                rep.update(case)
    launches = dict.fromkeys(RNG_KERNELS, 0)
    for label, render in _cell_renders(dev):
        render()                                 # the allocator's blocks
        with spans.recording() as rec:
            t0 = time.perf_counter()
            img, rays = render()
            rays = float(rays)
            wall = time.perf_counter() - t0
        its = rec.counts.get("queue.iterations", 0) + rec.counts.get("fused.iterations", 0)
        got = {k: rec.counts.get("launches." + k, 0) for k in RNG_KERNELS}
        each = its > 0 and all(c == its for c in got.values())
        log(f"  {label}: {its} iterations, launches {got}: one of each an "
            f"iteration {each}; {wall:.3f} s, {rays / wall:.4g} rays/s, image "
            f"mean {float(img.mean()):.6g}")
        ok &= each and bool(torch.isfinite(img).all())
        for k in RNG_KERNELS:
            launches[k] += got[k]
    log(f"phase 2c: {'ok' if ok else 'FAILED'}")
    return ok, launches


def rng_times(tree):
    """``--rng-times TREE``: the main paths' threefry calls (``RNG_CALLS``,
    through ``ops.rng.bounce_uniforms`` and ``path_keys``: the kernels
    here, the int64 chain in a tree without them) and one unit of each
    one-card render cell (``_cell_renders``), as the package in ``TREE``
    runs them. Prints one JSON object: per case [device ms of a call (CUDA
    events behind a spin; a render's wall, synchronized), host-inclusive
    ms (CUDA events around back-to-back calls; a render's again), digest
    of the outputs, SM clock MHz after the set]."""
    import hashlib

    sys.path.insert(0, os.path.abspath(tree))
    import tinyraytracing_tpu_torch

    def digest(out):
        h = hashlib.sha256()
        for x in out:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    dev = torch.device("cuda")
    res = {"package": os.path.dirname(tinyraytracing_tpu_torch.__file__)}
    for R, n, plane in RNG_CALLS:
        for name, (label, fn, _, _) in _rng_calls(R, n, plane, dev).items():
            ms, mhz = _device_total_ms(fn, 1)
            res[f"{name} {label}"] = [ms, _host_ms(fn, 5), digest(fn()), mhz]
    for label, render in _cell_renders(dev):
        render()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        res[f"render {label}"] = [walls[0], walls[1], digest(out), _sm_clock()]
    print(json.dumps(res), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 10: the inverse-rendering examples
# ---------------------------------------------------------------------------

EXAMPLE_SIZE, EXAMPLE_STEPS = 32, 8


def phase_examples(dev):
    """Phase 10: both inverse-rendering examples
    (``tinyraytracing_tpu_torch/examples/``) on the card at EXAMPLE_SIZE
    for EXAMPLE_STEPS steps, each with its launches counted: the loss
    falls and the albedo error ends below where it started."""
    from tinyraytracing_tpu_torch.examples import inverse_demo, inverse_rendering
    from tinyraytracing_tpu_torch.models.procedural import cornell_box

    kd = cornell_box(8, 8, device="cpu")[0]
    obs = ~kd.mtl_emissive
    kd = kd.kd
    log(f"phase 10: the inverse-rendering examples, cornell "
        f"{EXAMPLE_SIZE}x{EXAMPLE_SIZE}, {EXAMPLE_STEPS} steps")
    ok = True
    runs = (("inverse_rendering (scan render_loss, mxu, plain steps)",
             lambda: inverse_rendering.recover_albedo(
                 EXAMPLE_STEPS, EXAMPLE_SIZE, device=dev, print_every=0),
             float((kd * 0.4 + 0.25 - kd).abs()[obs].max()),
             ("scatter_fixed",)),
            ("inverse_demo (render_loss_fast, Adam)",
             lambda: inverse_demo.recover_albedo(
                 EXAMPLE_STEPS, EXAMPLE_SIZE, device=dev, print_every=0)[0],
             float((0.5 - kd).abs()[obs].max()),
             ("trace_closest", "trace_occlusion", "scatter_fixed")))
    for label, run, start, kernels in runs:
        t0 = time.perf_counter()
        steps, counts = _counted(run)
        secs = time.perf_counter() - t0
        losses = [x["loss"] for x in steps]
        errs = [x["kd_max_err"] for x in steps]
        good = (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
                and errs[-1] < start and all(counts[k] > 0 for k in kernels))
        log(f"  {label}: {secs:.2f} s; losses {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}; albedo error {start:.4f} at the start, "
            f"{errs[-1]:.4f} at the end; launches "
            f"{ {k: v for k, v in counts.items() if v} }: "
            f"{'ok' if good else 'FAILED'}")
        ok &= good
    log(f"phase 10: {'ok' if ok else 'FAILED'}")
    return ok


# ---------------------------------------------------------------------------
# phase 7: the edge-sampled boundary terms (diff/edge.py)
# ---------------------------------------------------------------------------

# card against CPU on the FD scenes, stated before the first card run:
# the same keys sample the same edges and points, and kernel 5 is bitwise
# its plain version, so only float-add order (sums, the cotangent
# scatters' atomics) and the library solve of the projection differ
EDGE_LOSS_RTOL, EDGE_GRAD_RTOL = 1e-5, 1e-3
EDGE_SAMPLES = (0, 8192, 65536)
# the call whose kernel-4 dispatches are held to the plain version: the
# primary term's first trace (closest hit, shadow) and the shadow term's
# three dispatches (camera rays, f on both sides)
EDGE_CHECKED, EDGE_PICKS = 8192, (0, 1, 12, 13, 14)


def _edge_launches(cfg, edge_samples, shadow_edge_samples):
    """Intersect launches of the edge terms in one ``render_loss_fast``:
    the primary term traces G on both sides of every sample
    (``wavefront.trace``: per bounce one closest-hit and one shadow
    dispatch), the shadow term its camera rays and f on both sides."""
    return ((2 * cfg.max_depth * 2 if edge_samples else 0)
            + (3 if shadow_edge_samples else 0))


def phase_edge(dev, reports):
    """Phase 7: (1) the FD scenes of tests/test_diff_edge.py
    (tests/torch_edge_scenes.py) at 48x48 with ``intersector="pallas"``
    on the card (kernel 5) and on the CPU (its plain version): the card's
    interior plus edge gradient against the central difference at the JAX
    tests' tolerances, and against the CPU's gradient and loss. (2) Full
    size: ``render_loss_fast`` on cornell 512x512 (phase 6's shape) in
    kd + vertex_offset with edge_samples = shadow_edge_samples at 0, 8,192
    and 65,536 (kernel 4), and kernel 4 held bitwise to its plain version
    on the 8,192-sample call's own dispatches. Returns (ok, {"edge":
    launches of the 65,536 call, "edge_fd": of the three FD edge calls on
    the card})."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff.edge import build_edge_aux
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    fd = _tests_module("torch_edge_scenes")
    log("phase 7: the edge-sampled boundary terms (render_loss_fast with "
        "edge_samples / shadow_edge_samples)")
    ok, fd_launches = True, {}
    for name, case in fd.CASES.items():
        out = {}
        for where, device in (("cuda", dev), ("cpu", "cpu")):
            seen = {}

            def wrap(fn):
                res, seen["launches"] = _counted(fn)
                return res

            t0 = time.perf_counter()
            r = fd.fd_check(name, device, "pallas", wrap=wrap)
            out[where] = (r, seen["launches"], time.perf_counter() - t0)
        (rc, lc, tc), (rp, _, tp) = out["cuda"], out["cpu"]
        gerr = float((rc["grad"].cpu() - rp["grad"]).norm() / rp["grad"].norm())
        lerr = abs(rc["loss"] - rp["loss"]) / abs(rp["loss"])
        want = _edge_launches(fd.config(name), case.edge_samples,
                              case.shadow_edge_samples)
        rel = abs(rc["g_full"] - rc["fd"]) / abs(rc["fd"])
        log(f"  {name} 48x48, {case.spp} spp, edge {case.edge_samples} / "
            f"shadow {case.shadow_edge_samples} samples: FD {rc['fd']:.6g} "
            f"(step {case.eps}); card interior {rc['g_int']:.3g}, interior + "
            f"edge {rc['g_full']:.6g} ({rel:.3g} from FD, bound {case.rel}); "
            f"CPU interior + edge {rp['g_full']:.6g}; card vs CPU loss "
            f"{lerr:.3g} (bound {EDGE_LOSS_RTOL:g}), gradient distance / norm "
            f"{gerr:.3g} (bound {EDGE_GRAD_RTOL:g}); launches in the edge call "
            f"{lc} (kernel 5 expected {want}); cuda {tc:.2f} s, cpu {tp:.2f} s")
        ok &= (rc["ok"] and lerr <= EDGE_LOSS_RTOL and gerr <= EDGE_GRAD_RTOL
               and lc["slot_intersect"] == want and lc["bvh_intersect"] == 0)
        for k, v in lc.items():
            fd_launches[k] = fd_launches.get(k, 0) + v

    cfg, key = RenderConfig(max_depth=DIFF_DEPTH), master_key_data(0)
    scene, cam = cornell_box(512, 512, device=dev)
    scene = attach_bvh(scene, cfg)
    t0 = time.perf_counter()
    aux = build_edge_aux(scene)
    log(f"  cornell 512x512: build_edge_aux {time.perf_counter() - t0:.3f} s "
        f"({aux['ends'].shape[0]} edges)")
    target = torch.zeros(cam.height, cam.width, 3, device=dev)
    fields = ("kd", "vertex_offset")
    edge_launches = {}
    for n in EDGE_SAMPLES:
        kw = dict(edge_samples=n, shadow_edge_samples=n, edge_aux=aux)
        run = lambda counts=None: _loss_and_grads(scene, cam, fields, cfg, key,
                                                  target, counts, **kw)
        want = _edge_launches(cfg, n, n)
        if n == EDGE_CHECKED:
            # one untimed run whose kernel-4 dispatches are kept and checked
            with _captured_rays("bvh", EDGE_PICKS) as kept:
                run()
            ok &= _main_path_rays_ok(
                f"cornell leaf 8, the edge terms' kernel-4 dispatches at {n} "
                f"samples", scene, "bvh", kept, EDGE_PICKS, cfg, reports,
                "phase 7")
            del kept
        ok_n, _, counts = _profile_loss(
            f"cornell 512x512, max_depth {cfg.max_depth}, {DIFF_SPP} spp, "
            f"kd+vertex_offset, edge_samples = shadow_edge_samples = {n} "
            f"(kernel 4 expected {want} + 0)", run, "bvh_intersect",
            lambda fwd, bwd: (fwd["bvh_intersect"] == want
                              and bwd["bvh_intersect"] == 0
                              and fwd["slot_intersect"] == 0
                              and bwd["slot_intersect"] == 0
                              and fwd["trace_closest"] > 0
                              and bwd["scatter_fixed"] > 0),
            repeat=False)
        ok &= ok_n
        if n == EDGE_SAMPLES[-1]:
            edge_launches = _summed(counts)
    log(f"phase 7: {'ok' if ok else 'FAILED'}")
    return ok, {"edge": edge_launches, "edge_fd": fd_launches}


# ---------------------------------------------------------------------------
# phase 8: the regeneration oracles (integrator/regen.py)
# ---------------------------------------------------------------------------

def _oracle_checks(label, fn, scene, cam, cfg, cpu_cfg):
    """The oracle ``fn`` against the port's scan render of the same scene
    on the card at 64x64, 16 spp (the JAX tests' criteria: means within
    10%, correlation > 0.9), and against itself on the CPU at 64x64, 2 spp
    with ``cpu_cfg`` on both devices (the kernel on the card, its plain
    version on the CPU; phases 4/4b/4c's bounds)."""
    import dataclasses

    import numpy as np

    from tinyraytracing_tpu_torch.ops.rng import master_key_data
    from tinyraytracing_tpu_torch.render import render

    cam64 = dataclasses.replace(cam, width=64, height=64)
    key = master_key_data(3)
    t0 = time.perf_counter()
    a = render(scene, cam64, key, cfg, 16).cpu().numpy()
    b = fn(scene, cam64, key, cfg, 16)[0].cpu().numpy()
    mean_rel = abs(a.mean() - b.mean()) / a.mean()
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    log(f"  {label} vs the scan render, 64x64 @ 16 spp on the card: means "
        f"{b.mean():.6g} vs {a.mean():.6g} ({mean_rel:.3g} relative, bound "
        f"0.1), correlation {corr:.4f} (bound 0.9); "
        f"{time.perf_counter() - t0:.2f} s")
    ok = bool(np.isfinite(b).all()) and mean_rel < 0.1 and corr > 0.9
    imgs, secs = {}, {}
    for where, s in (("cuda", scene), ("cpu", scene.to("cpu"))):
        t0 = time.perf_counter()
        imgs[where] = fn(s, cam64, key, cpu_cfg, 2)[0].cpu()
        secs[where] = time.perf_counter() - t0
    return ok & _compare_images(f"  {label} 64x64 @ 2 spp, "
                                f"{cpu_cfg.intersector}, card vs CPU",
                                imgs, secs, 64)


# the oracles' dispatches held to the plain version: the first iteration's
# closest hit (camera rays on every lane) and shadow test, and the 21st
# iteration's (fresh camera rays among bounces)
ORACLE_PICKS = (0, 1, 40, 41)


def _oracle_report(label, fn, kname, scene, cfg, reports, refs, scatters):
    """One main-path run of an oracle (``fn(stats)``): first one untimed run
    that warms the allocator and the scene's kernel records and keeps the
    kernel's ORACLE_PICKS dispatches, which go through the kernel and its
    plain version (and, where ``scatters``, its image scatter of iteration
    SCATTER_PICK, in ``refs["scatter rows regen"]`` for phase 6b); then one
    run timed alone with its launches counted, whose image must be bitwise
    the first run's, then one under torch.profiler. ``scatters``: one image
    scatter per iteration, else none. Returns (ok, launches)."""
    from tinyraytracing_tpu_torch.integrator import regen

    kind = "bvh" if kname == "bvh_intersect" else "slot"
    with _captured_rays(kind, ORACLE_PICKS) as seen, _captured_scatter(
            regen, "scatter_add_rows", (SCATTER_PICK,)) as kept:
        img0, _ = fn({})
    if scatters:
        refs["scatter rows regen"] = kept
    ok = _main_path_rays_ok(f"{label.split(',')[0]}'s dispatches", scene,
                            kind, seen, ORACLE_PICKS, cfg, reports, "phase 8")
    del seen                               # out of the timed run's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    (img, rays), counts = _counted(lambda: fn(stats))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_dev, busy_ms, kern_ms, n_kern, mhz = _profiled(lambda: fn({}), kname)
    ms, it, exact = 1e3 * secs, stats["iterations"], stats["rays"]
    same = torch.equal(img, img0)
    del img0
    log(f"  {label}: {secs:.3f} s (after one warm run), {it} iterations, traced "
        f"rays {float(rays):.0f} (float32) / {exact} (exact), "
        f"{exact / secs:.4g} rays/s; peak device memory {peak / 2**20:.1f} "
        f"MiB; image mean {float(img.mean()):.6g}")
    log(f"    the same key again: image bitwise the first run's: {same}")
    log(f"    launches {counts} ({kname} expected 2 per iteration: {2 * it}"
        f"{', scatter_rows 1 per iteration' if scatters else ''}); "
        f"under torch.profiler {n_dev} device ops ({n_dev / max(it, 1):.0f} per "
        f"iteration), {kname} {kern_ms:.2f} ms in {n_kern} recorded launches = "
        f"{100 * kern_ms / ms:.2f}% of the unprofiled run, device busy "
        f"{busy_ms:.1f} ms (idle {100 * (1 - busy_ms / ms):.0f}%); "
        f"{_mhz(mhz)} after it")
    want = {k: 0 for k in counts}
    want.update({kname: 2 * it}, **({"scatter_rows": it} if scatters else {}))
    ok &= (bool(torch.isfinite(img).all()) and float(img.mean()) > 0 and same
           and counts == want
           and abs(float(rays) - exact) <= 1e-6 * exact * it)
    return ok, {k: v for k, v in counts.items() if v}


def phase_oracles(dev, reports, refs):
    """Phase 8: ``render_regen`` on grid:100000 (leaf 8, the CLI's tree) at
    1024x1024, 1 spp, 131,072 lanes with intersector "auto" (kernel 4), and
    ``render_persistent`` on cornell 512x512, 4 spp, 262,144 lanes with
    "pallas" (kernel 5); each kernel held bitwise to its plain version on
    the oracle's own dispatches, and each oracle held to the scan render
    statistically and to itself on the CPU. Returns (ok, {kernel:
    launches})."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.regen import (
        render_persistent, render_regen,
    )
    from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    key = master_key_data(0)
    log("phase 8: the regeneration oracles")
    cfg = RenderConfig()
    grid, gcam = quad_grid(100_000, 1024, 1024, device=dev)
    grid = attach_bvh(grid, cfg)
    ok, n4 = _oracle_report(
        "render_regen grid:100000 1024x1024, 1 spp, 131,072 lanes, auto",
        lambda st: render_regen(grid, gcam, key, cfg, 1, lanes=131072, stats=st),
        "bvh_intersect", grid, cfg, reports, refs, True)
    ok &= _oracle_checks("render_regen grid:100000", render_regen, grid, gcam,
                         cfg, cfg.replace(intersector="bvh_pallas"))
    pcfg = RenderConfig(intersector="pallas")
    cornell, ccam = cornell_box(512, 512, device=dev)
    ok_p, n5 = _oracle_report(
        "render_persistent cornell 512x512, 4 spp, 262,144 lanes, pallas",
        lambda st: render_persistent(cornell, ccam, key, pcfg, 4, lanes=262144,
                                     stats=st),
        "slot_intersect", cornell, pcfg, reports, refs, False)
    ok &= ok_p and _oracle_checks("render_persistent cornell",
                                  render_persistent, cornell, ccam, pcfg, pcfg)
    log(f"phase 8: {'ok' if ok else 'FAILED'}")
    return ok, {k: n4.get(k, 0) + n5.get(k, 0) for k in {**n4, **n5}}


# ---------------------------------------------------------------------------
# phase 9: the multi-rank renderers (parallel/) over torch.distributed
# ---------------------------------------------------------------------------

P9_WORLD = 4
P9_TIMEOUT_S = 300          # a set of ranks that runs longer fails the phase
P9_RANKS = (1, 2, 4)        # the rank counts of the fused and queue sweeps
P9_SCAN_SPP = 2
P9_SPP = 4                  # the fused and queue renders' spp (phases 3, 3c)


def _p9_spawn(body, world, backend, label):
    """``body(r, world, out)`` in ``world`` rank processes (spawn start
    method, a ``file://`` rendezvous in a temporary directory, process
    group ``backend``, rank r on card r modulo the cards); returns each
    rank's result in
    rank order, or None when a rank failed or the set outlasted
    P9_TIMEOUT_S (the others are then ended)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(
            _p9_rank, args=(world, backend, f"file://{d}/rendezvous", d, body),
            nprocs=world, join=False, start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > P9_TIMEOUT_S:
                    log(f"  {label}: the ranks outlasted {P9_TIMEOUT_S} s; "
                        f"the stages each rank finished: "
                        f"{_p9_marks(d, world)}")
                    return None
        except ProcessException as e:
            log(f"  {label}: a rank failed: {e}")
            return None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _p9_marks(d, world):
    """{rank: the stage lines it wrote to ``d``}."""
    out = {}
    for r in range(world):
        path = os.path.join(d, f"marks{r}.txt")
        out[r] = open(path).read().split("\n")[:-1] if os.path.exists(path) else []
    return out


def _p9_rank(r, world, backend, init, out, body):
    """One rank: join the process group, run ``body``, save its result."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(r % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=r,
                            timeout=datetime.timedelta(seconds=P9_TIMEOUT_S))
    try:
        res = body(r, world, out)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def _p9_call(fn, group=None):
    """(result, seconds, launches of every kernel, peak device MiB) of one
    call, started together with the other ranks of ``group`` (a barrier)
    and synchronised before and after."""
    import torch.distributed as dist

    dist.barrier(group=group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts = _counted(fn)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, counts, torch.cuda.max_memory_allocated() / 2**20


def _p9_busy(fn):
    """Device busy ms and device ops of one more run of ``fn`` under
    torch.profiler (this rank's CUDA activity), all ranks starting
    together."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.device_time_total for e in ev) / 1e3, len(ev)


def _p9_scenes():
    """The CLI's scenes and configs of phases 3 and 3c (the same trees), on
    the card, at 1024x1024 and P9_SPP: (grid:100000, its camera, its
    config), (cornell, ...)."""
    import dataclasses

    from tinyraytracing_tpu_torch import cli

    out = []
    for name in ("grid:100000", "cornell"):
        args = cli.build_parser().parse_args(
            ["--scene", name, "--width", "1024", "--height", "1024", "--spp",
             str(P9_SPP)])
        scene, cam, config = cli.build_scene(args)
        out.append((scene, dataclasses.replace(cam, width=1024, height=1024),
                    config))
    return out


def _p9_ranks(r, world, out):
    """Phase 9a, one of the four ranks: the fused and
    chunked queue renders at 1, 2 and 4 ranks, the chunked queue
    preempted and resumed, the one-shot sharded queue, the sharded loss
    and the sharded scan renders. Returns what the parent checks and
    logs (images on the CPU)."""
    import dataclasses

    import torch.distributed as dist

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff import (
        SceneParams, apply_params, render_diff, render_loss_fast,
    )
    from tinyraytracing_tpu_torch.integrator import fused, fused_queue, wavefront
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data
    from tinyraytracing_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    marks = [("start", t0)]

    def mark(name):
        """Record a stage, also in ``out`` (read when the ranks hang)."""
        marks.append((name, time.perf_counter()))
        with open(os.path.join(out, f"marks{r}.txt"), "a") as f:
            f.write(f"{name} {marks[-1][1] - t0:.1f}\n")

    key = master_key_data(0)
    (grid, gcam, gcfg), (cornell, ccam, ccfg) = _p9_scenes()
    mark("scenes")
    groups = {n: dist.new_group(list(range(n))) for n in P9_RANKS if n < world}
    res = {"rank": r}

    # what the code dispatches, beside what the kernels count: the
    # persistent renderer's trace calls, the queue's final iteration and
    # its lanes' ray counts summed in float64
    dispatched, finals = [0], []
    real_trace, real_result = fused.fused_trace_planes, fused_queue._result

    def trace_counted(*a, **k):
        dispatched[0] += 1
        return real_trace(*a, **k)

    def result_seen(s, n_pix):
        finals.append((s["it"], float(s["ray_count"].double().sum())))
        return real_result(s, n_pix)

    fused.fused_trace_planes = trace_counted
    fused_queue._result = result_seen

    # warm: every kernel library loaded, the scenes' device records built
    small = dataclasses.replace(ccam, width=64, height=64)
    pm.render_fused_sharded(cornell, small, key, ccfg, 1)
    pm.render_queue_sharded(grid, dataclasses.replace(gcam, width=64,
                                                      height=64), key, gcfg, 1)
    _p9_busy(lambda: torch.ones(1, device="cuda").sum())    # CUPTI start-up
    mark("warm")

    def sweep(name, run):
        for n in P9_RANKS:
            if r < n:
                g = groups.get(n)
                mesh = pm.make_mesh(group=g)
                mesh.all_reduce(torch.zeros(1, device="cuda"))  # set-up
                dispatched[0] = 0
                finals.clear()
                (img, rays), secs, counts, peak = _p9_call(
                    lambda: run(mesh), g)
                res[(name, n)] = dict(
                    secs=secs, rays=float(rays), counts=counts, peak=peak,
                    dispatched=dispatched[0], finals=list(finals),
                    img=img.cpu() if n == world else None)  # all ranks
            dist.barrier()
            mark(f"{name} at {n}")

    sweep("fused", lambda m: pm.render_fused_sharded(
        cornell, ccam, key, ccfg, P9_SPP, m, lanes=262144))
    res["fused busy"] = _p9_busy(lambda: pm.render_fused_sharded(
        cornell, ccam, key, ccfg, P9_SPP, lanes=262144))
    mark("fused")
    sweep("queue", lambda m: pm.render_queue_sharded_chunked(
        grid, gcam, key, gcfg, P9_SPP, m, lanes=262144))
    res["queue busy"] = _p9_busy(lambda: pm.render_queue_sharded_chunked(
        grid, gcam, key, gcfg, P9_SPP, lanes=262144))
    mark("queue")

    # preempted after one chunk, then resumed; the one-shot sharded queue
    ck = os.path.join(out, "queue.npz")
    part, rest = [], []
    pm.render_queue_sharded_chunked(
        grid, gcam, key, gcfg, P9_SPP, lanes=262144, checkpoint_path=ck,
        stop_after_chunks=1, progress=lambda **p: part.append(p["it"]))
    kept = os.path.exists(f"{ck}.rank{r}-of-{world}")
    img, rays = pm.render_queue_sharded_chunked(
        grid, gcam, key, gcfg, P9_SPP, lanes=262144, checkpoint_path=ck,
        resume=True, progress=lambda **p: rest.append(p["it"]))
    res["resumed"] = dict(img=img.cpu() if r == 0 else None, rays=float(rays),
                          part=part, rest=rest, kept=kept,
                          cleared=not os.path.exists(f"{ck}.rank{r}-of-{world}"))
    (img, rays), secs, _, _ = _p9_call(
        lambda: pm.render_queue_sharded(grid, gcam, key, gcfg, P9_SPP,
                                        lanes=262144))
    res["one-shot"] = dict(img=img.cpu() if r == 0 else None,
                           rays=float(rays), secs=secs)
    mark("resume, one-shot")

    # the sharded loss (phase 6's cornell call) and the single-process one
    dcfg = RenderConfig(max_depth=DIFF_DEPTH)
    dscene, dcam = cornell_box(512, 512, device="cuda")
    dscene = attach_bvh(dscene, dcfg)
    target = torch.zeros(512, 512, 3, device="cuda")
    fields = ("kd", "vertex_offset")

    def loss_run(loss_fn):
        p = SceneParams.init_from(dscene, dcam, *fields)
        for t in p.tensors():
            t.requires_grad_(True)
        loss = loss_fn(p, dscene, dcam, key, target, dcfg, DIFF_SPP)
        loss.backward()
        return loss.detach().cpu(), {f: getattr(p, f).grad.cpu() for f in fields}

    loss_run(pm.render_loss_fast_sharded)                    # warm
    (loss, grads), secs, counts, peak = _p9_call(
        lambda: loss_run(pm.render_loss_fast_sharded))
    res["loss"] = dict(loss=loss, grads=grads, secs=secs, counts=counts,
                       peak=peak)
    res["loss busy"] = _p9_busy(lambda: loss_run(pm.render_loss_fast_sharded))
    with torch.no_grad():          # the forward's traced rays of this rank
        s2, c2 = apply_params(dscene, dcam,
                              SceneParams.init_from(dscene, dcam, *fields))
        per = -(-512 * 512 // world)
        res["loss"]["rays"] = float(render_diff(
            s2, c2, key, dcfg, DIFF_SPP, return_rays=True, pix_lo=r * per,
            n_pix_local=per)[1])
    if r == 0:
        res["loss ref"], res["loss ref counts"] = _counted(
            lambda: loss_run(render_loss_fast))
    dist.barrier()
    mark("loss")

    # the scan renderer on a 2x2 mesh: grid:100000 (kernel 4), cornell
    # 64x64 (phase 4b's scene, held to the CPU by the parent)
    mesh22 = pm.make_mesh(2, 2)
    for axis in ("tile", "spp"):          # each axis group's set-up
        mesh22.all_reduce(torch.zeros(1, device="cuda"), axis)
    scfg = gcfg                     # phase 3b's: intersector "auto"
    img, secs, counts, peak = _p9_call(lambda: pm.render_sharded(
        grid, gcam, key, scfg, mesh22, spp=P9_SCAN_SPP))
    res["scan"] = dict(mean=float(img.mean()), finite=bool(
        torch.isfinite(img).all()), shape=tuple(img.shape), secs=secs,
        counts=counts, peak=peak)
    res["scan busy"] = _p9_busy(lambda: pm.render_sharded(
        grid, gcam, key, scfg, mesh22, spp=P9_SCAN_SPP))
    # the same render once more with the tracer's stats: this rank's rays
    real_wf, counted = wavefront.trace, []

    def trace_stats(*a, **k):
        rad, st = real_wf(*a, return_stats=True, **k)
        counted.append(st["primary"].sum() + st["shadow"].sum())
        return rad

    wavefront.trace = trace_stats
    try:
        pm.render_sharded(grid, gcam, key, scfg, mesh22, spp=P9_SCAN_SPP)
    finally:
        wavefront.trace = real_wf
    res["scan"]["rays"] = float(sum(counted))
    bcfg = RenderConfig(intersector="bvh_pallas")
    small, scam = cornell_box(64, 64, device="cuda")
    small = attach_bvh(small, bcfg)
    res["scan small"] = pm.render_sharded(small, scam, key, bcfg, mesh22,
                                          spp=P9_SCAN_SPP).cpu()
    mark("scan")
    res["marks"] = [(k, t - marks[0][1]) for k, t in marks]
    return res


def _p9_nccl(r, world, out):
    """Phase 9b, one NCCL rank: the sharded calls beside the
    single-process ones on cornell 64x64."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.diff import SceneParams, render_loss_fast
    from tinyraytracing_tpu_torch.integrator.fused import render_fused_stats
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data
    from tinyraytracing_tpu_torch.parallel import mesh as pm

    key, cfg = master_key_data(0), RenderConfig(max_depth=DIFF_DEPTH)
    scene, cam = cornell_box(64, 64, device="cuda")
    scene = attach_bvh(scene, cfg)
    mesh = pm.make_mesh()
    cpu = lambda x: tuple(map(cpu, x)) if isinstance(x, tuple) else x.cpu()
    res = {"backend": torch.distributed.get_backend(mesh.group)}
    # spp 4: several paths of a pixel finish in one iteration, and the
    # image scatter adds them in a fixed order
    res["queue"] = cpu((pm.render_queue_sharded(scene, cam, key, cfg, P9_SPP,
                                                mesh, lanes=4096),
                        render_fused_queue(scene, cam, key, cfg, P9_SPP,
                                           lanes=4096)))
    res["fused"] = cpu((pm.render_fused_sharded(scene, cam, key, cfg, 2, mesh,
                                                lanes=4096),
                        render_fused_stats(scene, cam, key, cfg, 2, lanes=4096)))
    target = torch.zeros(64, 64, 3, device="cuda")
    for name, fn in (("loss", pm.render_loss_fast_sharded),
                     ("loss ref", render_loss_fast)):
        p = SceneParams.init_from(scene, cam, "kd", "vertex_offset")
        for t in p.tensors():
            t.requires_grad_(True)
        loss = fn(p, scene, cam, key, target, cfg, DIFF_SPP)
        loss.backward()
        res[name] = cpu((loss.detach(), p.kd.grad, p.vertex_offset.grad))
    return res



def _ulp32(x):
    """The float32 spacing at ``x``."""
    t = torch.tensor(x, dtype=torch.float32)
    return float(torch.nextafter(t, torch.tensor(float("inf"))) - t)


def _p9_launch_ok(label, per_rank, want):
    """Log each rank's launches beside what the code implies (``want``,
    per rank: {kernel: count}); True if they agree."""
    ok = all(c == w for c, w in zip(per_rank, want))
    show = lambda cs: {k: [c[k] for c in cs] for k in cs[0]
                       if any(c[k] for c in cs)}
    log(f"    {label}: launches per rank {show(per_rank)}, the code's count "
        f"{show(want)}: {'ok' if ok else 'MISMATCH'}")
    return ok


def _p9_zero(counts, **nonzero):
    """``counts`` with every kernel at 0 but ``nonzero``."""
    return {k: nonzero.get(k, 0) for k in counts}


def phase_sharded(dev, refs, backend="gloo"):
    """Phase 9: ``parallel/`` on the card. (a) Four gloo ranks on the one
    card (NCCL refuses two ranks on one device): ``render_fused_sharded``
    on phase 3c's cornell (bitwise its image) and the chunked
    ``render_queue_sharded_chunked`` on phase 3's grid:100000 (its ray
    count within float32 rounding, its image within the scatter's
    rounding), each at 1, 2 and 4 ranks; the chunked queue preempted after
    one chunk and resumed, and the one-shot ``render_queue_sharded``;
    ``render_loss_fast_sharded`` on phase 6's cornell call against the
    single-process loss (the JAX test's bounds, gradients equal on every
    rank); ``render_sharded`` on grid:100000 (kernel 4) within 10% of phase
    3b's mean, and on cornell 64x64 against the CPU (phase 4b's bounds).
    (b) One NCCL rank in a process of its own, bitwise its
    single-process queue and fused calls and loss gradients. With ``backend="nccl"``
    (``--four-cards``) the four ranks are NCCL ranks on four cards, one
    each, and the same checks and timings run. Every collective
    runs on the tensors' own device; the harness stages nothing. Returns
    (ok, {kernel: launches of the main calls, all ranks})."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    t_phase = time.perf_counter()
    n_cards = P9_WORLD if backend == "nccl" else 1
    log(f"phase 9: parallel/ over torch.distributed: {P9_WORLD} {backend} "
        f"ranks on {n_cards} card(s), then one NCCL rank")
    if torch.cuda.device_count() < n_cards:
        log(f"  NCCL takes one card per rank: {torch.cuda.device_count()} "
            f"card(s) here")
        return False, {}
    res = _p9_spawn(_p9_ranks, P9_WORLD, backend, "phase 9a")
    if res is None:
        return False, {}
    log(f"  rank 0's seconds since it started, after each stage: "
        f"{', '.join(f'{k} {t:.1f}' for k, t in res[0]['marks'])}; the four "
        f"ranks in all {time.perf_counter() - t_phase:.1f} s")
    ok, launches = True, {}
    fused_img, fused_rays, fused_secs = refs["fused"]
    queue_img, queue_rays, queue_secs = refs["queue"]
    queue_img = queue_img.reshape(1024, 1024, 3)

    def add(counts_per_rank):
        for c in counts_per_rank:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v

    for name, single, secs1 in (("fused", fused_rays, fused_secs),
                                ("queue", queue_rays, queue_secs)):
        log(f"  {name}: single process (phase {'3c' if name == 'fused' else '3'}) "
            f"{secs1:.3f} s, {single:.0f} rays, {single / secs1:.4g} rays/s")
        for n in P9_RANKS:
            runs = [res[i][(name, n)] for i in range(n)]
            wall = max(x["secs"] for x in runs)
            rays = runs[0]["rays"]
            counts = [x["counts"] for x in runs]
            log(f"  {name} at {n} rank(s): wall {wall:.3f} s (ranks "
                f"{', '.join(f'{x['secs']:.3f}' for x in runs)}), {rays:.0f} "
                f"rays, {rays / wall:.4g} rays/s ({rays / wall / (single / secs1):.2f}x "
                f"the single process); peak per rank "
                f"{', '.join(f'{x['peak']:.1f}' for x in runs)} MiB")
            if name == "fused":
                want = [_p9_zero(c, trace_closest=x["dispatched"])
                        for c, x in zip(counts, runs)]
            else:
                want = [_p9_zero(c, trace_closest=x["finals"][-1][0],
                                 trace_occlusion=x["finals"][-1][0],
                                 scatter_rows=x["finals"][-1][0])
                        for c, x in zip(counts, runs)]
                exact = [x["finals"][-1][1] for x in runs]
                log(f"    each rank's lanes' counts summed in float64: {exact}"
                    f" = {sum(exact):.0f}")
                ok &= sum(exact) == round(sum(exact))
            ok &= _p9_launch_ok(f"{name} at {n}", counts, want)
            ok &= all(x["rays"] == rays for x in runs)
            # float32 totals: a few ulps of the total apart
            ok &= abs(rays - single) <= 8 * _ulp32(single)
            if n == P9_WORLD:
                add(counts)
                img = runs[0]["img"]
                if name == "fused":
                    same = torch.equal(img, fused_img)
                    log(f"    image bitwise phase 3c's: {same}; rays "
                        f"{rays:.0f} vs {single:.0f}")
                else:
                    close = torch.isclose(img, queue_img, rtol=1e-5, atol=1e-7)
                    same = bool(close.all())
                    log(f"    image within rtol 1e-5 / atol 1e-7 of phase 3's: "
                        f"{same} (max abs diff "
                        f"{float((img - queue_img).abs().max()):.3g}); rays "
                        f"{rays:.0f} vs {single:.0f}")
                ok &= same and all(torch.equal(res[i][(name, n)]["img"], img)
                                   for i in range(n))
        busy = [res[i][f"{name} busy"] for i in range(P9_WORLD)]
        wall = max(res[i][(name, P9_WORLD)]["secs"] for i in range(P9_WORLD))
        log(f"    under torch.profiler at {P9_WORLD} ranks: device busy "
            f"{' + '.join(f'{b:.1f}' for b, _ in busy)} ms in "
            f"{sum(n for _, n in busy)} device ops = "
            f"{100 * sum(b for b, _ in busy) / (1e3 * wall):.0f}% of the wall")

    # preempt, resume, one-shot
    rz = [res[i]["resumed"] for i in range(P9_WORLD)]
    one = res[0]["one-shot"]
    whole = res[0][("queue", P9_WORLD)]
    close = torch.isclose(rz[0]["img"], one["img"], rtol=1e-5, atol=1e-7)
    close_w = torch.isclose(whole["img"], one["img"], rtol=1e-5, atol=1e-7)
    log(f"  queue preempted after iterations {rz[0]['part']}, resumed at "
        f"{rz[0]['rest'][0]} of {rz[0]['rest'][-1]} (snapshots kept "
        f"{[x['kept'] for x in rz]}, removed {[x['cleared'] for x in rz]}); "
        f"resumed and run-through images within rtol 1e-5 / atol 1e-7 of "
        f"the one-shot render_queue_sharded ({one['secs']:.3f} s): "
        f"{bool(close.all())}, {bool(close_w.all())} (bitwise: "
        f"{torch.equal(rz[0]['img'], one['img'])}, "
        f"{torch.equal(whole['img'], one['img'])}); rays {rz[0]['rays']:.0f}, "
        f"{whole['rays']:.0f}, {one['rays']:.0f}")
    ok &= (all(x["kept"] and x["cleared"] for x in rz)
           and rz[0]["rest"][0] > rz[0]["part"][-1]
           and bool(close.all()) and bool(close_w.all())
           and abs(rz[0]["rays"] - one["rays"]) <= 8 * _ulp32(one["rays"]))

    # the loss
    lr = [res[i]["loss"] for i in range(P9_WORLD)]
    ref_loss, ref_grads = res[0]["loss ref"]
    # forward and the backward's recompute: a closest-hit and a shadow
    # dispatch per bounce and pass, each; as many cotangent scatters as
    # the single-process loss (each rank gathers from the same tables)
    n = 2 * DIFF_DEPTH * DIFF_SPP
    n_fixed = res[0]["loss ref counts"]["scatter_fixed"]
    want = [_p9_zero(x["counts"], trace_closest=n, trace_occlusion=n,
                     scatter_fixed=n_fixed) for x in lr]
    ok &= _p9_launch_ok("loss (forward + recompute)", [x["counts"] for x in lr],
                        want)
    add([x["counts"] for x in lr])
    same = all(torch.equal(x["loss"], lr[0]["loss"])
               and all(torch.equal(x["grads"][f], lr[0]["grads"][f])
                       for f in ref_grads) for x in lr)
    rel = abs(float(lr[0]["loss"]) - float(ref_loss)) / abs(float(ref_loss))
    gclose = all(torch.allclose(lr[0]["grads"][f], ref_grads[f], rtol=2e-4,
                                atol=1e-6) for f in ref_grads)
    gdist = {f: float((lr[0]["grads"][f] - ref_grads[f]).norm()
                      / ref_grads[f].norm()) for f in ref_grads}
    busy = [res[i]["loss busy"] for i in range(P9_WORLD)]
    wall = max(x["secs"] for x in lr)
    rays = sum(x["rays"] for x in lr)
    log(f"  render_loss_fast_sharded cornell 512x512, depth {DIFF_DEPTH}, "
        f"{DIFF_SPP} spp, kd + vertex_offset: forward + backward {wall:.3f} s, "
        f"the forward's {rays:.0f} traced rays over it: {rays / wall:.4g} "
        f"rays/s "
        f"(peak per rank {', '.join(f'{x['peak']:.1f}' for x in lr)} MiB); "
        f"loss {float(lr[0]['loss']):.7g} vs single-process "
        f"{float(ref_loss):.7g} ({rel:.2g} relative, bound 1e-5); gradients "
        f"within rtol 2e-4 / atol 1e-6: {gclose} (relative distances "
        f"{gdist}); equal on every rank: {same}; device busy "
        f"{' + '.join(f'{b:.1f}' for b, _ in busy)} ms = "
        f"{100 * sum(b for b, _ in busy) / (1e3 * wall):.0f}% of the wall")
    ok &= same and rel <= 1e-5 and gclose

    # the scan renderer
    sc = [res[i]["scan"] for i in range(P9_WORLD)]
    want = [_p9_zero(x["counts"], bvh_intersect=(P9_SCAN_SPP // 2) * 16 * 2)
            for x in sc]
    ok &= _p9_launch_ok("render_sharded grid:100000", [x["counts"] for x in sc],
                        want)
    add([x["counts"] for x in sc])
    mean_rel = abs(sc[0]["mean"] - refs["scan mean"]) / refs["scan mean"]
    busy = [res[i]["scan busy"] for i in range(P9_WORLD)]
    wall = max(x["secs"] for x in sc)
    rays = sum(x["rays"] for x in sc)
    log(f"  render_sharded grid:100000 1024x1024, {P9_SCAN_SPP} spp, mesh 2x2, "
        f"auto: {wall:.3f} s, {rays:.0f} traced rays, {rays / wall:.4g} "
        f"rays/s; image mean {sc[0]['mean']:.6g} vs phase 3b's "
        f"{refs['scan mean']:.6g} at 1 spp ({mean_rel:.3g} relative, bound "
        f"0.1); peak per rank {', '.join(f'{x['peak']:.1f}' for x in sc)} MiB; "
        f"device busy {' + '.join(f'{b:.1f}' for b, _ in busy)} ms = "
        f"{100 * sum(b for b, _ in busy) / (1e3 * wall):.0f}% of the wall")
    ok &= (all(x["finite"] and x["shape"] == (1024, 1024, 3) for x in sc)
           and mean_rel <= 0.1)
    cfg = RenderConfig(intersector="bvh_pallas")
    scene, cam = cornell_box(64, 64, device="cpu")
    scene = attach_bvh(scene, cfg)
    t0 = time.perf_counter()
    cpu = _tests_module("torch_parallel_ranks").serial_render_sharded(
        scene, cam, master_key_data(0), cfg, P9_SCAN_SPP, 2, 2)
    secs = {"cuda": 0.0, "cpu": time.perf_counter() - t0}
    card = res[0]["scan small"]
    ok &= all(torch.equal(res[i]["scan small"], card) for i in range(P9_WORLD))
    ok &= _compare_images(f"  render_sharded cornell 64x64 @ {P9_SCAN_SPP} spp, "
                          f"mesh 2x2, bvh_pallas (the CPU: its shares run "
                          f"serially)", {"cuda": card, "cpu": cpu}, secs, 64)

    # (b) one NCCL rank
    nc = _p9_spawn(_p9_nccl, 1, "nccl", "phase 9b")
    if nc is None:
        return False, launches
    nc = nc[0]
    (qi, qr), (qi1, qr1) = nc["queue"]
    (fi, fr), (fi1, fr1) = nc["fused"]
    q_same = torch.equal(qi, qi1.reshape(qi.shape)) and torch.equal(qr, qr1)
    f_same = torch.equal(fi, fi1) and torch.equal(fr, fr1)
    (l, gk, gv), (l1, gk1, gv1) = nc["loss"], nc["loss ref"]
    lrel = abs(float(l) - float(l1)) / abs(float(l1))
    g_same = torch.equal(gk, gk1) and torch.equal(gv, gv1)
    log(f"  one {nc['backend']} rank, cornell 64x64: render_queue_sharded "
        f"({P9_SPP} spp) bitwise render_fused_queue: {q_same}; "
        f"render_fused_sharded bitwise render_fused: {f_same}; "
        f"render_loss_fast_sharded's loss {lrel:.2g} from render_loss_fast's "
        f"(bound 1e-5; a sum, then a division, against torch.mean) and its "
        f"gradients bitwise render_loss_fast's: {g_same}")
    ok &= nc["backend"] == "nccl" and q_same and f_same and lrel <= 1e-5 and g_same
    log(f"phase 9: {'ok' if ok else 'FAILED'} in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return ok, launches


# ---------------------------------------------------------------------------
# --compare: the redesigned kernels against a parent tree, in one call
# ---------------------------------------------------------------------------

def kernel_times(tree):
    """``--kernel-times TREE``: device and host-inclusive times of the
    kernels the last changes redesigned, as the package in ``TREE`` runs
    them, with this script's timing code: the trace kernels through
    ``ops.trace.fused_trace_planes`` (closest hit with attributes on phase
    2's 262,144 camera + bounce rays, occlusion on its 262,144 shadow rays,
    each preorder and near-first) on grid100k at leaf 8 and 32 and on
    cornell; the packet sums of 262,144 rays in packets of 2048 (beside
    torch.sum) and of 16384; the packet-BVH kernel on phase 2b's three
    kinds of rays on the same scenes; and the slot kernel on phase 2b's
    three kinds of rays on cornell and grid6000, with an empty kernel on
    its grid as the floor under its time; and the scan ``render_loss``
    forward + backward of phase 6 (``_loss_case``); and the two scatter
    kernels at phase 6b's shapes (``_scatter_cases``). Prints one JSON
    object: per case [device ms, host-inclusive ms, digest of the outputs,
    SM clock MHz after the set] (no digest for torch.sum, the empty
    kernel, the packets of 16384, whose order of adds the packet-sum
    repair changed, and the loss, whose cotangents add in no fixed
    order)."""
    import hashlib

    sys.path.insert(0, os.path.abspath(tree))
    import tinyraytracing_tpu_torch
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops import bvh_intersect as bi
    from tinyraytracing_tpu_torch.ops import slot_intersect as si
    from tinyraytracing_tpu_torch.ops import trace

    def digest(out):
        h = hashlib.sha256()
        for x in (out if isinstance(out, tuple) else (out,)):
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def case(fn, names, checked=True):
        dev, host, mhz = _times(fn, names)
        return [dev, host, digest(fn()) if checked else "", mhz]

    def slot_cases(name, scene, probe):
        for label, r in probe.items():
            fn = lambda: si.slot_intersect_planes(scene, r, cfg)
            res[f"slot_intersect {name}, {label}"] = case(fn,
                                                          ("slot_intersect",))

    res = {"package": os.path.dirname(tinyraytracing_tpu_torch.__file__)}
    cfg = RenderConfig()
    orders = {"preorder": cfg,
              "near": RenderConfig(walk_order="near", bvh_walk="wide")}
    gen = torch.Generator().manual_seed(2024)
    for name, scene, cam in _phase2_scenes():
        scene = scene.to("cuda")
        rays, shadow = _probe_rays(scene, cam, 131072, gen, cfg)
        for order, ocfg in orders.items():
            for query, r in (("closest", rays), ("occlusion", shadow)):
                fn = lambda: trace.fused_trace_planes(
                    scene, *r[:6], ocfg, t_bound=r[6], target_mtl=r[7],
                    query=query)
                res[f"trace {query} {order} {name}"] = case(fn, ("trace_kernel",))
        probe = _scan_probe_rays(scene, cam, torch.Generator().manual_seed(2024))
        for label, r in probe.items():
            fn = lambda: bi.bvh_intersect_planes(scene, r, cfg)
            res[f"bvh_intersect {name}, {label}"] = case(fn, ("bvh_intersect",))
        if name.startswith("cornell"):
            slot_cases(name, scene, probe)
    grid6k, cam = quad_grid(6000, device="cuda")
    slot_cases("grid6000", grid6k, _scan_probe_rays(
        grid6k, cam, torch.Generator().manual_seed(2024)))
    res[f"empty kernel on the slot grid, {SCAN_CHUNK} rays"] = case(
        lambda: _empty_launch(SCAN_CHUNK), ("empty_kernel",), False)
    R = 262144
    d = torch.randn(3, R, generator=torch.Generator().manual_seed(7))
    rays = torch.zeros(8, R)
    rays[3:6] = d / d.norm(dim=0)
    rays = rays.cuda()
    for tile in (2048, 16384):
        res[f"packet_dirs, packets of {tile}"] = case(
            lambda: trace.packet_dirs_kernel(rays, tile), ("packet_dirs",),
            tile <= 4096)
    n = R // 2048
    res["torch.sum, packets of 2048"] = case(
        lambda: rays[3:6].reshape(3, n, 2048).sum(dim=2), None, False)
    res["render_loss scan bvh_pallas cornell 512x512, kd+radiance, "
        "forward + backward"] = _loss_case()
    _scatter_cases(res, digest)
    print(json.dumps(res), flush=True)
    return 0


def _scatter_cases(res, digest):
    """The scatter kernels at phase 6b's shapes, as the package in use runs
    them, into ``res``: [device ms a call (CUDA events behind a spin),
    host-inclusive ms, digest of the outputs, SM MHz]. Inputs from a seed
    (tests/torch_scatter_emulate.py): the queue's image call at 4 spp (phase
    3's) and at 256 spp (the CLI's default: ~19 finished lanes a pixel,
    so almost every call sorts), render_regen's, 262,144 cotangent rows into 2 (the longest runs), 32, 256 and 257 (one
    sort pass and two) and 100,000 rows; and every cotangent scatter of
    one phase-6 cornell 512x512 forward + backward, as that package's own
    loss makes them."""
    import numpy as np

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops import lookup
    from tinyraytracing_tpu_torch.ops import scatter as sc
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    emu = _tests_module("torch_scatter_emulate")

    def timed(label, fn, once, n=20):
        ms, mhz = _device_total_ms(fn, n)
        res[label] = [ms, _host_ms(fn, n), digest(once()), mhz]

    for label, make in (("queue image call", emu.queue_call),
                        ("queue image call at 256 spp (the CLI's default)",
                         lambda: emu.queue_call(spp=256)),
                        ("render_regen image call", emu.regen_call)):
        rows, dst, src, dim, keep = make()
        rows, dst, src = (torch.from_numpy(a).cuda() for a in (rows, dst, src))
        buf = dst.clone()
        timed(f"scatter_rows, {label}",
              lambda: sc.scatter_add_rows(buf, dim, rows, src, keep),
              lambda: sc.scatter_add_rows(dst.clone(), dim, rows, src, keep))
    # 2 rows: the longest runs; 256 and 257: one sort pass and two
    for n_rows in (2, 32, 256, 257, 100_000):
        rng = np.random.default_rng(n_rows)
        rows = torch.from_numpy(rng.integers(0, n_rows, 262_144)).cuda()
        src = torch.from_numpy(emu.values(rng, 262_144, 3)).cuda()
        fn = lambda: sc.scatter_add_rows_fixed(n_rows, rows, src)
        timed(f"scatter_fixed, 262,144 rows into {n_rows:,}", fn, fn)
    cfg = RenderConfig(max_depth=DIFF_DEPTH)
    scene, cam = cornell_box(512, 512, device="cuda")
    scene = attach_bvh(scene, cfg)
    with _captured_scatter(lookup, "scatter_add_rows_fixed") as kept:
        _loss_and_grads(scene, cam, ("kd", "vertex_offset"), cfg,
                        master_key_data(0), torch.zeros(512, 512, 3, device="cuda"))
    calls = [(n, r.cuda(), g.cuda()) for n, r, g in kept]
    fn = lambda: tuple(sc.scatter_add_rows_fixed(n, r, x) for n, r, x in calls)
    timed(f"scatter_fixed, the {len(calls)} cotangent calls of a cornell "
          f"512x512 forward + backward", fn, fn, 2)


def _loss_case():
    """[device ms, host-inclusive ms, "", SM MHz] of phase 6's scan
    ``render_loss`` forward + backward (``_scan_loss_setup``): the device
    time is the sum of all its kernels under torch.profiler (after the
    host timing), the host-inclusive time CUDA events around 5 calls."""
    from tinyraytracing_tpu_torch.diff import render_loss
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    scene, cam, cfg, target = _scan_loss_setup("cuda")
    fn = lambda: _loss_and_grads(scene, cam, SCAN_LOSS_FIELDS, cfg,
                                 master_key_data(0), target, loss_fn=render_loss)
    host = _host_ms(fn, 5)
    events, mhz = _device_events(fn)
    return [sum(e.device_time_total for e in events) / 1e3, host, "", mhz]


def _walk_launch(lib, rec, rays, cfg, attrs, occl, tile, md, refill):
    """One launch of trace.cu's ``trt_trace`` from ``lib`` (the plain or
    the measurement build), with or without the resident blocks' refill."""
    from tinyraytracing_tpu_torch.ops import trace

    R = rays.shape[1]
    out = torch.empty((2 if occl else 9, R), device=rays.device)
    counter = torch.empty(1, dtype=torch.int32, device=rays.device)
    err = lib.trt_trace(
        rays.data_ptr(), rec.node.data_ptr(), rec.slot.data_ptr(),
        rec.shade.data_ptr(), rec.slot_id.data_ptr(), out.data_ptr(),
        counter.data_ptr() if refill else None, R,
        2 if occl else (0 if attrs else 1), None if md is None else md.data_ptr(),
        tile, rec.root_kids, trace.near_pause(rec, md),
        cfg.t_min, cfg.n_dot_d_min, 1.0 + cfg.tie_eps,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
    return out


def profile_walk(out_path):
    """``--profile-walk``: where the trace kernels' time goes, on phase 2's
    rays of grid100k at leaf 8 (the main path's tree). For each of kernels
    1-3 (closest with attributes and occlusion, preorder and near-first):
    the device ms of the kernel launched as a plain grid (one ray per
    thread) and with its resident blocks refilling lanes (what the wrapper
    launches), both bitwise equal to the plain walk; then, from trace.cu
    built with -DTRT_PROFILE and launched as a plain grid, per-ray clock64
    counts summed over warps of 32 rays: a warp's cycles (its slowest
    lane's), the shares of its node and leaf loops, how many interior
    steps and slot tests the warp runs against what its mean lane needs,
    and the cycles of one warp step; and, launched both ways, the SIMT
    efficiency of the node loop's iterations and of the slot tests (the
    mean share of a warp's lanes active in them)."""
    import ctypes

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import kernels, trace

    libs = {}
    for key, defines in (("plain", ()), ("profile", ("TRT_PROFILE",))):
        lib = kernels.library("trace.cu", defines)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trt_trace.argtypes = [P, P, P, P, P, P, P, I, I, P, I, I, I, F, F,
                                  F, P]
        lib.trt_trace.restype = I
        libs[key] = lib
    libs["profile"].trt_set_prof.argtypes = [ctypes.c_void_p]
    cfg = RenderConfig()
    near = RenderConfig(walk_order="near", bvh_walk="wide")
    name, scene, cam = next(_phase2_scenes())
    scene = scene.to("cuda")
    rays, shadow = _probe_rays(scene, cam, 131072,
                               torch.Generator().manual_seed(2024), cfg)
    pk, rec = scene.bvh.packed, scene.trace_records
    R = rays.shape[1]
    buf = torch.zeros(12 * R + 512, dtype=torch.int64, device="cuda")
    if libs["profile"].trt_set_prof(buf.data_ptr()):
        raise RuntimeError("trt_set_prof failed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"{smi}; {name}, {rays.shape[1]} camera + bounce rays, "
        f"{shadow.shape[1]} shadow rays")
    table = {}
    for label, r, attrs, occl, c in (
            ("kernel 1: closest, preorder", rays, True, False, cfg),
            ("kernel 2: occlusion, preorder", shadow, False, True, cfg),
            ("kernel 3: closest, near", rays, True, False, near),
            ("kernel 3: occlusion, near", shadow, False, True, near)):
        tile, md = trace.walk_packets(pk, r, c, occl)
        want = trace.trace_plain(pk, r, c, attrs=attrs, occl=occl, tile=tile,
                                 md=md)
        row = {}
        for how, lib, refill in (("grid", "plain", False),
                                 ("refill", "plain", True),
                                 ("profile", "profile", False)):
            fn = lambda: _walk_launch(libs[lib], rec, r, c, attrs, occl,
                                      tile, md, refill)
            same = torch.equal(fn(), want)
            dev, _, mhz = _times(fn, ("trace_kernel",))
            row[how] = dict(device_ms=dev, sm_mhz=mhz, equal=same)
        simt = {}
        for how, refill in (("refill", True), ("grid", False)):  # grid last
            buf.zero_()
            _walk_launch(libs["profile"], rec, r, c, attrs, occl, tile, md,
                         refill)
            w = buf[8 * R:].view(-1, 4).double().sum(dim=0)
            simt[how] = (float(w[0] / (32 * w[1] / 2 ** 20)),
                         float(w[2] / (32 * w[3] / 2 ** 20)))
        q = buf[:8 * R].view(-1, 32, 8).double()        # (warps, lanes, 8)
        wmax = q.max(dim=1).values
        cyc = wmax[:, 0].sum()
        prof = dict(
            warp_cycles_mean=float(wmax[:, 0].mean()),
            warp_cycles_max=float(wmax[:, 0].max()),
            node_loop_share=float(wmax[:, 1].sum() / cyc),
            leaf_loop_share=float(wmax[:, 2].sum() / cyc),
            lane_steps_mean=float(q[:, :, 3].mean()),
            warp_steps_mean=float(wmax[:, 3].mean()),
            step_simt=float(q[:, :, 3].sum() / (32 * wmax[:, 3].sum())),
            lane_slots_mean=float(q[:, :, 5].mean()),
            warp_slots_mean=float(wmax[:, 5].mean()),
            slot_simt=float(q[:, :, 5].sum() / (32 * wmax[:, 5].sum())),
            cycles_per_warp_step=float(wmax[:, 1].sum() / wmax[:, 3].sum()),
            cycles_per_warp_slot=float(wmax[:, 2].sum() / wmax[:, 5].sum()),
            node_loop_simt_grid=simt["grid"][0],
            slot_simt_grid=simt["grid"][1],
            node_loop_simt_refill=simt["refill"][0],
            slot_simt_refill=simt["refill"][1])
        row["counts"] = prof
        table[label] = row
        log(f"  {label}: grid {row['grid']['device_ms']:.4f} ms, refill "
            f"{row['refill']['device_ms']:.4f} ms, measurement build "
            f"{row['profile']['device_ms']:.4f} ms (device, at "
            f"{_mhz(row['refill']['sm_mhz'])}); bitwise equal to plain: "
            f"{all(v['equal'] for k, v in row.items() if k != 'counts')}")
        log("    per warp of 32 rays (grid): "
            + ", ".join(f"{k} {v:.3g}" for k, v in prof.items()))
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"device": smi, "cases": table}, f, indent=1)
    return 0 if all(v["equal"] for row in table.values()
                    for k, v in row.items() if k != "counts") else 1


def _sass_loops(text):
    """Per function of a ``cuobjdump -sass`` listing: its instructions, and
    the loops (a backward branch and its target) as address spans."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs[m.group(1)] = {"ins": [], "labels": {}, "pending": []}
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur["pending"].append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in cur["pending"]:
                cur["labels"][lab] = addr
            cur["pending"] = []
            cur["ins"].append((addr, m.group(2)))
    out = {}
    for name, f in funcs.items():
        loops = []
        for addr, ins in f["ins"]:
            op = re.sub(r"^@!?U?P\w+\s+", "", ins)
            if not op.startswith("BRA"):
                continue
            m = re.search(r"\((\.L_x_\d+)\)", op) or re.search(r"(0x[0-9a-f]+)", op)
            if m is None:
                continue
            tgt = f["labels"].get(m.group(1)) if m.group(1).startswith(".L") \
                else int(m.group(1), 16)
            if tgt is not None and tgt <= addr:
                loops.append((tgt, addr))
        out[name] = (f["ins"], loops)
    return out


def _opcode(ins):
    import re

    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def sass_counts(tree, out_path):
    """``--sass TREE``: the SASS of the slot kernel of the package in TREE
    (``cuobjdump -sass`` of its built library). For each kernel function:
    its instructions and the subroutines it calls; and in its chunk loop
    (the loop that loads the most slot attributes from shared memory: its
    slot tests are the bytes it loads over 64) the instructions per slot
    test on the common path, by opcode. Not on the common path: the blocks
    a branch skips right after a warp vote (a slot accepted, the slow
    reciprocal) and the blocks a branch skips that call a subroutine (the
    division's or reciprocal's slow path); those are counted apart. Then
    the issue-rate bound of the common path for the scan dispatch on
    cornell and grid6000: instructions per test x (ray, triangle) tests /
    INSTR_RATE lane-instructions per second."""
    import re
    import shutil

    sys.path.insert(0, os.path.abspath(tree))
    from tinyraytracing_tpu_torch.ops import kernels

    path, _ = kernels._build_one("slot_intersect.cu")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    if out_path:
        with open(out_path, "w") as f:
            f.write(text)
    nbytes = lambda op: (16 if op.endswith(".128") else 8 if op.endswith(".64")
                         else 4) if op.startswith("LDS") else 0
    res = {}
    for name, (ins, loops) in _sass_loops(text).items():
        if "slot_intersect_kernel" not in name:
            continue
        ops = [_opcode(i) for _, i in ins]
        calls = sorted({i.split()[-1] for (_, i), op in zip(ins, ops)
                        if op.startswith("CALL")})
        row = dict(instructions=len(ins), calls=calls)
        tests = lambda lo, hi: sum(nbytes(op) for (a, _), op in zip(ins, ops)
                                   if lo <= a <= hi) / 64
        if loops:
            lo, hi = max(loops, key=lambda l: (tests(*l), l[0] - l[1]))
            body = [(a, i, op) for (a, i), op in zip(ins, ops) if lo <= a <= hi]
            skipped = {}
            for k, (a, i, op) in enumerate(body):
                m = re.search(r"BRA (0x[0-9a-f]+)", i)
                if not (i.startswith("@") and op == "BRA" and m):
                    continue
                tgt = int(m.group(1), 16)
                block = [x for x in body if a < x[0] < tgt]
                voted = any(x[2].startswith("VOTE") for x in body[max(k - 3, 0):k])
                if voted or any(x[2].startswith("CALL") for x in block):
                    kind = "after a vote" if voted else "slow path"
                    for x in block:
                        skipped.setdefault(x[0], kind)
            n = tests(lo, hi)
            common = [op for a, _, op in body if a not in skipped]
            count = {}
            for op in common:
                count[op] = count.get(op, 0) + 1
            per = len(common) / n
            kinds = list(skipped.values())
            row.update(
                tests_per_iteration=n, per_test=per,
                per_test_after_a_vote=kinds.count("after a vote") / n,
                per_test_slow_path=kinds.count("slow path") / n,
                per_test_ops={k: v / n for k, v in sorted(count.items(),
                                                         key=lambda kv: -kv[1])})
            for scene, n_tri in (("cornell", 32), ("grid6000", 6012)):
                row[f"issue_bound_ms {scene}"] = (
                    1e3 * per * SCAN_CHUNK * n_tri / INSTR_RATE)
        res[name] = row
        log(f"{name}: {json.dumps(row)}")
    print(json.dumps({"package": os.path.dirname(os.path.dirname(
        kernels.__file__)), "functions": res}), flush=True)
    return 0


def compare(parent, out_path, mode="--kernel-times"):
    """``--compare PARENT``: ``--kernel-times`` (or ``mode``: ``--compare-rng
    PARENT`` runs ``--rng-times``) of the package in PARENT (a
    ``git archive`` of the parent commit, unpacked) and of this tree, in
    turns (parent, this, this, parent), each in its own process, so both
    are timed on the same card; prints the device times side by side, each
    with the SM clock it was read at, and fails unless the two trees'
    outputs are bitwise equal in every case and the parent has no case
    this tree lacks."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tree in (parent, here, here, parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode, tree], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode != 0:
            log(f"{mode} {tree} failed:\n{res.stdout[-3000:]}"
                f"{res.stderr[-3000:]}")
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        log(f"timed {runs[-1].pop('package')}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"{smi}; device ms per launch (host-inclusive ms in brackets; SM "
        f"MHz after the set); runs in the order parent, this, this, parent")
    ok, table = True, {}
    for key in runs[0]:
        if key not in runs[1]:
            ok = False
            table[key] = dict(missing_here=True)
            log(f"  {key}: MISSING in this tree (the parent has it)")
    for key in runs[1]:
        new = [runs[1][key], runs[2][key]]
        if key not in runs[0]:
            table[key] = dict(device_ms=[r[0] for r in new],
                              host_ms=[r[1] for r in new],
                              sm_mhz=[r[3] for r in new])
            log(f"  {key}: this {new[0][0]:.5f} / {new[1][0]:.5f} [{new[0][1]:.5f}"
                f" / {new[1][1]:.5f}] (the parent has no such case); MHz "
                f"{[r[3] for r in new]}")
            continue
        old = [runs[0][key], runs[3][key]]
        same = len({r[2] for r in old + new}) == 1
        checked = bool(old[0][2])
        ok &= same or not checked
        om, nm = statistics.mean(r[0] for r in old), statistics.mean(r[0] for r in new)
        table[key] = dict(parent_device_ms=[r[0] for r in old],
                          device_ms=[r[0] for r in new],
                          parent_host_ms=[r[1] for r in old],
                          host_ms=[r[1] for r in new],
                          parent_sm_mhz=[r[3] for r in old],
                          sm_mhz=[r[3] for r in new],
                          speedup=om / nm,
                          outputs_equal=same if checked else None)
        low = min(r[3] for r in old + new) < LOW_MHZ
        log(f"  {key}: parent {old[0][0]:.5f} / {old[1][0]:.5f} "
            f"[{old[0][1]:.5f} / {old[1][1]:.5f}], this {new[0][0]:.5f} / "
            f"{new[1][0]:.5f} [{new[0][1]:.5f} / {new[1][1]:.5f}]: "
            f"{om / nm:.2f}x; MHz {[r[3] for r in old]} / {[r[3] for r in new]}"
            f"{f' (below {LOW_MHZ:,} MHz)' if low else ''}; outputs "
            f"{'not compared' if not checked else 'bitwise equal' if same else 'DIFFER'}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"device": smi, "cases": table}, f, indent=1)
    return 0 if ok else 1


def four_cards():
    """Phase 9 across four cards, one NCCL rank each: the same renders,
    checks and timings as on the one card, against phases 3, 3b and 3c's
    single-process renders on card 0."""
    from tinyraytracing_tpu_torch.ops import kernels

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    secs, _ = kernels.build()
    log(f"phase 1: kernels built in {secs:.1f}s")
    dev, refs = torch.device("cuda"), {}
    with tempfile.TemporaryDirectory() as tmp:
        ok = (phase_cli(dev, tmp, refs)[0] and phase_cli_scan(dev, tmp, refs)[0]
              and phase_cli_persistent(dev, tmp, refs))
    ok = phase_sharded(dev, refs, "nccl")[0] and ok
    log(f"four cards: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="PARENT",
                    help="time the redesigned kernels against the tree PARENT")
    ap.add_argument("--compare-rng", metavar="PARENT",
                    help="the threefry calls and one unit of each one-card "
                         "render cell, timed and checked bitwise against the "
                         "tree PARENT")
    ap.add_argument("--four-cards", action="store_true",
                    help="phase 9 with one NCCL rank on each of four cards "
                         "(after phases 1, 3, 3b and 3c on card 0)")
    ap.add_argument("--profile-walk", action="store_true",
                    help="where the trace kernels' time goes (clock64 counts)")
    ap.add_argument("--sass", metavar="TREE",
                    help="instructions per slot test in the slot kernel of "
                         "the package in TREE (cuobjdump)")
    ap.add_argument("--out", help="with --compare(-rng) or --profile-walk: write "
                                  "the table here (JSON); with --sass, the "
                                  "listing")
    ap.add_argument("--kernel-times", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--rng-times", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.kernel_times:
        return kernel_times(args.kernel_times)
    if args.rng_times:
        return rng_times(args.rng_times)
    if args.sass:
        return sass_counts(args.sass, args.out)
    if args.compare:
        return compare(os.path.abspath(args.compare), args.out)
    if args.compare_rng:
        return compare(os.path.abspath(args.compare_rng), args.out, "--rng-times")
    if args.four_cards:
        return four_cards()
    if args.profile_walk:
        return profile_walk(args.out)
    from tinyraytracing_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    secs, logs = kernels.build()
    log(f"phase 1: kernels built in {secs:.1f}s")
    from tinyraytracing_tpu_torch import native

    t0 = time.perf_counter()
    for src in ("bvh_builder.cc", "objparser.cc"):
        native._library(src)
    log(f"  native BVH builder and OBJ parser built (g++) in "
        f"{time.perf_counter() - t0:.1f}s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # full float32 products everywhere (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ok2, ok2b, reports = phase_kernels(dev)
    ok2c, rng_launches = phase_rng(dev, reports)
    _second_readings_summary()
    refs = {}                   # phases 3, 3b and 3c's renders, for phase 9
    with tempfile.TemporaryDirectory() as tmp:
        ok3, launches = phase_cli(dev, tmp, refs)
        ok3b, scan_launches = phase_cli_scan(dev, tmp, refs)
        ok3c = phase_cli_persistent(dev, tmp, refs)
        ok3d, near_launches = phase_near_queue(dev)
        ok5 = phase_resume(dev, tmp)
    launches.update(scan_launches)
    launches.update({k: near_launches[k] for k in ("trace_near", "packet_dirs")})
    ok4 = phase_render_vs_render(dev)
    ok4b = phase_scan_vs_scan(dev)
    ok4c = phase_persistent_vs_persistent(dev)
    ok6, diff_launches = phase_diff(dev, refs)
    t0 = time.perf_counter()
    ok7, edge_launches = phase_edge(dev, reports)
    diff_launches.update(edge_launches)
    t7 = time.perf_counter()
    ok8, oracle_launches = phase_oracles(dev, reports, refs)
    log(f"phases 7 and 8 took {t7 - t0:.1f} s and "
        f"{time.perf_counter() - t7:.1f} s")
    t0 = time.perf_counter()
    ok6b = phase_scatter(dev, refs, reports, {
        "queue": launches["scatter_rows"],
        "regen": oracle_launches.get("scatter_rows", 0)})
    for k, n in oracle_launches.items():
        launches[k] = launches.get(k, 0) + n
    # the cotangent scatter's main path is the differentiable one
    launches["scatter_fixed"] += diff_launches["backward"]["scatter_fixed"]
    ok10 = phase_examples(dev)
    log(f"phases 6b and 10 took {time.perf_counter() - t0:.1f} s")
    ok9, sharded_launches = phase_sharded(dev, refs)
    for k, n in sharded_launches.items():
        launches[k] = launches.get(k, 0) + n
    launches.update(rng_launches)          # phase 2c's renders of the cells

    # no single PyTorch call computes a BVH walk or brute-force closest
    # hit; the packet sums have one (a sum over each packet)
    kern = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                 launches=launches.get(k, 0),
                 diff_launches={w: c.get(k, 0) for w, c in diff_launches.items()},
                 max_abs_err=r["max_abs_err"],
                 ms=r.get("ms"), device_ms=r.get("device_ms"),
                 host_ms=r.get("host_ms"), plain_ms=r.get("plain_ms"),
                 bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
                 library_ms=r.get("library_ms"),
                 **({"cases": r["cases"]} if "cases" in r else {}))
            for k, r in reports.items()]
    log(json.dumps({"kernels": kern}))
    phases = {"kernels": ok2, "scan kernels": ok2b, "threefry kernels": ok2c,
              "cli render": ok3,
              "cli scan render": ok3b, "cli persistent render": ok3c,
              "near queue render": ok3d, "render vs render": ok4,
              "scan vs scan": ok4b, "persistent vs persistent": ok4c,
              "chunked resume": ok5, "diff": ok6, "scatter kernels": ok6b,
              "edge terms": ok7, "oracles": ok8, "sharded": ok9,
              "examples": ok10}
    log("phases: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                               for k, v in phases.items())
        + f"; {time.perf_counter() - t_start:.0f} s in all")
    if not all(phases.values()):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
