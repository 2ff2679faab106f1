"""GPU smoke test of tinyraytracing_tpu_torch: builds the hand-written CUDA
kernels, holds each against its plain PyTorch version on the card (the
trace kernels in both walk orders), renders through the CLI with the queue
renderer (the 100K-triangle scene), with the scan renderer (the
100K-triangle scene through the packet-BVH kernel, cornell through the
slot kernel) and with the persistent renderer (cornell), renders the
100K-triangle scene under the near-first walk through ``render_image``,
renders small scenes on the card and on the CPU to compare, and
interrupts and resumes a checkpointed queue render. The slot kernel is
also checked on grid6000 and on the tie scene of the CPU tests
(``tests/torch_slot_emulate.py``). Run from the repository root:

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero on any failure (and without
a result when there is no CUDA device). The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels,
each with its device time per launch (torch.profiler) and its
host-inclusive time (CUDA events around back-to-back calls). Each timed
set runs after ~50 ms of back-to-back launches that raise the card's
clock from idle, and the log gives the SM clock nvidia-smi read right
after it, marking readings below 1,500 MHz.

Before and after a kernel's redesign, on one card in one call:

    git archive <parent> | tar -x -C tmp_out/parent    # here, not on the card
    python3 chip_smoke.py --compare tmp_out/parent --out tmp_out/compare.json

times the redesigned kernels of the parent's package and of this tree in
turns (parent, this, this, parent) and checks their outputs bitwise equal:
the trace kernels through ``ops.trace.fused_trace_planes`` (closest hit
and occlusion, preorder and near-first), the packet sums, the packet-BVH
kernel and the slot kernel. ``--sass TREE`` counts the SASS instructions
per slot test of the slot kernel of TREE's package.
"""

from __future__ import annotations

import functools
import json
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
           "slot_intersect": CSRC + "slot_intersect.cu"}
REPLACES = {
    "trace_closest": "tinyraytracing_tpu/ops/pallas_trace.py:962",
    "trace_occlusion": "tinyraytracing_tpu/ops/pallas_trace.py:206",
    "trace_near": "tinyraytracing_tpu/ops/pallas_trace.py:382",
    "packet_dirs": "tinyraytracing_tpu/ops/pallas_trace.py:376",
    "bvh_intersect": "tinyraytracing_tpu/ops/pallas_bvh.py:188",
    "slot_intersect": "tinyraytracing_tpu/ops/pallas_intersect.py:168",
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


def _times(fn, names, n=20):
    """(device ms per launch, host-inclusive ms per call, SM clock MHz right
    after) of ``fn``, after a warm-up load of ``fn`` itself."""
    _warm(fn)
    dev, host = _device_ms(fn, names, n), _host_ms(fn, n)
    return dev, host, _sm_clock()


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
    import importlib.util

    from tinyraytracing_tpu_torch.models.procedural import quad_grid

    grid6k, cam = quad_grid(6000, device=dev)
    ok2b &= phase_intersect_kernels("grid6000 leaf 8", grid6k, cam, ("slot",),
                                    gen, reports)
    # the tie scene of the slot kernel's CPU tests, loaded from its file
    # (the card's machine may have another package named tests)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_slot_emulate.py")
    spec = importlib.util.spec_from_file_location("torch_slot_emulate", path)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
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


def phase_intersect_kernels(name, scene, cam, kinds, gen, reports, rays=None):
    """Kernels 4 ("bvh") and 5 ("slot") against their plain versions on the
    scan path's three kinds of rays (``rays``, else ``_scan_probe_rays``):
    every output plane bitwise equal. The slot kernel's cases also time an
    empty kernel on its grid (the floor under its device time)."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import bvh_intersect as bi
    from tinyraytracing_tpu_torch.ops import slot_intersect as si

    cfg = RenderConfig()
    t0 = time.perf_counter()
    rays = rays or _scan_probe_rays(scene, cam, gen)
    pk = scene.bvh.packed if scene.bvh is not None else None
    P, n_chunks = scene.slot_payload
    T = scene.num_triangles
    log(f"phase 2b [{name}]: {T} triangles, {n_chunks} slot chunks, "
        f"{SCAN_CHUNK} rays of each kind; setup {time.perf_counter() - t0:.1f}s")
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

def phase_cli(dev, out_dir):
    """Phase 3: grid:100000 through the CLI with "auto" (the queue, through
    the chunked driver). Only the render call is timed; kernel and busy time
    come from torch.profiler of the same render run again (_render_report)."""
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.ops import bvh, trace

    seen, built = {}, []
    real = render_mod.render_fused_queue_chunked
    real_attach = bvh.attach_bvh

    def attach_timed(*a, **k):
        t0 = time.perf_counter()
        out = real_attach(*a, **k)
        built.append(time.perf_counter() - t0)
        return out

    argv = ["--scene", "grid:100000", "--width", "1024", "--height", "1024",
            "--spp", "4", "--out", f"{out_dir}/grid100k.png"]
    torch.cuda.reset_peak_memory_stats()
    render_mod.render_fused_queue_chunked = _timed_entry(
        "render_fused_queue_chunked", real, seen)
    bvh.attach_bvh = attach_timed
    trace.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        render_mod.render_fused_queue_chunked = real
        bvh.attach_bvh = real_attach
    launches = dict(trace.LAUNCHES)
    log(f"phase 3: cli {' '.join(argv[:-2])} (spp cut from config 3's 512 to 4 "
        f"only to fit the smoke's time limit; the chunked queue driver) -> rc {rc}")
    log(f"  the CLI's BVH build (attach_bvh, numpy) took "
        f"{' + '.join(f'{b:.2f}' for b in built)} s of its wall")
    img = _render_report("queue grid:100000", wall, seen, launches, real,
                         ("trace_kernel",))
    ok = (rc == 0 and launches["trace_closest"] > 0
          and launches["trace_occlusion"] > 0 and launches["trace_near"] == 0
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):   # start-up, untimed
        torch.ones(1, device="cuda").sum()
    _warm()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    mhz = _sm_clock()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in dev)
    names = kernel_name if isinstance(kernel_name, tuple) else (kernel_name,)
    kern = [e.device_time_total for e in dev if any(n in e.name for n in names)]
    return len(dev), busy_us / 1e3, sum(kern) / 1e3, len(kern), mhz


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


def phase_cli_scan(dev, out_dir, size=1024):
    """Two scan renders through the CLI, each with every launch count set to
    0 just before and read just after: grid:100000 with "auto" (a BVH is
    attached: the packet-BVH kernel) and cornell with "pallas" (the slot
    kernel). 1024x1024 at 1 spp is 16 chunks of 65,536 rays x 16 bounces x
    (1 closest hit + 1 shadow dispatch) = 512 launches of the kernel.

    Only the render call is timed (synchronised before and after); nothing
    inside it is wrapped. The same render is then run once more, timed the
    same way, and twice untimed: under torch.profiler for its kernel and
    device-busy time, and with the tracer's stats for the traced-ray
    count."""
    n_chunks = -(-size * size // SCAN_CHUNK)
    expect = n_chunks * 16 * 2
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.ops import bvh_intersect as bi
    from tinyraytracing_tpu_torch.ops import slot_intersect as si
    from tinyraytracing_tpu_torch.ops import trace

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
        for mod in (trace, bi, si):
            mod.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
        finally:
            render_mod.render = real_render
        counts = {**bi.LAUNCHES, **si.LAUNCHES, **trace.LAUNCHES}
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
    again; returns the image."""
    a, k = seen["args"]
    peak = torch.cuda.max_memory_allocated()        # the render's, unprofiled
    n_dev, busy_ms, kern_ms, n_kern, mhz = _profiled(
        lambda: stats_fn(*a, **k), kernels)
    img, secs = seen["img"], seen["seconds"]
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
    return img


def phase_cli_persistent(dev, out_dir):
    """Phase 3c: cornell through the CLI with "auto" (under 512 triangles:
    the persistent renderer) at 1024x1024, 4 spp, 262,144 lanes: 4 epochs
    of one merged bounce + shadow dispatch per iteration."""
    import tinyraytracing_tpu_torch.render as render_mod
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.integrator.fused import render_fused_stats
    from tinyraytracing_tpu_torch.ops import trace

    seen = {}
    real = render_mod.render_fused_image
    argv = ["--scene", "cornell", "--width", "1024", "--height", "1024",
            "--spp", "4", "--lanes", "262144", "--out", f"{out_dir}/cornell.png"]
    torch.cuda.reset_peak_memory_stats()
    render_mod.render_fused_image = _timed_entry("render_fused_image",
                                                 render_fused_stats, seen)
    trace.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        render_mod.render_fused_image = real
    counts = dict(trace.LAUNCHES)
    log(f"phase 3c: cli {' '.join(argv[:-2])} (auto: the persistent renderer, "
        f"4 epochs of 262,144 lanes) -> rc {rc}")
    img = _render_report("persistent cornell", wall, seen, counts,
                         render_fused_stats, ("trace_kernel",))
    ok = (rc == 0 and counts["trace_closest"] > 0 and counts["trace_near"] == 0
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
    from tinyraytracing_tpu_torch.ops import trace

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
        trace.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            render_mod.render_image(scene, cam, cfg, spp=4, renderer="queue")
            wall = time.perf_counter() - t0
        finally:
            render_mod.render_fused_queue_chunked = real
        launches[order] = dict(trace.LAUNCHES)
        img = _render_report(order, wall, seen, launches[order], real,
                             ("trace_kernel", "packet_dirs_kernel"))
        imgs[order] = img.reshape(cam.height, cam.width, 3).cpu()
        ok &= bool(torch.isfinite(img).all()) and float(img.mean()) > 0
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
    chunks and resumed, against the one-shot render: within the float-add
    rounding of the scatter's atomics, the same ray count, the resume
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
    close = torch.isclose(got, one, rtol=1e-5, atol=1e-7).all(dim=-1)
    err = float((got - one).abs().max())
    log(f"phase 5: chunked grid:6000 64x64 @ 4 spp, 4096 lanes: interrupted "
        f"after iterations {first} (snapshot written: {saved}), resumed at "
        f"{then[0]} of {then[-1]} iterations; {int((~close).sum())} of "
        f"{close.numel()} pixels outside rtol 1e-5/atol 1e-7 of the one-shot "
        f"render (max abs diff {err:.3g}); rays {float(rays2):.0f} vs "
        f"{float(rays):.0f}; snapshot removed: {cleared}")
    return (saved and cleared and then[0] > first[1] and bool(close.all())
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
    its grid as the floor under its time. Prints one JSON object: per
    case [device ms, host-inclusive ms, digest of the outputs, SM clock
    MHz after the set] (no digest for torch.sum, the empty kernel and the
    packets of 16384, whose order of adds the packet-sum repair
    changed)."""
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
    print(json.dumps(res), flush=True)
    return 0


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


def compare(parent, out_path):
    """``--compare PARENT``: ``--kernel-times`` of the package in PARENT (a
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
                              "--kernel-times", tree], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode != 0:
            log(f"--kernel-times {tree} failed:\n{res.stdout[-3000:]}"
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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="PARENT",
                    help="time the redesigned kernels against the tree PARENT")
    ap.add_argument("--profile-walk", action="store_true",
                    help="where the trace kernels' time goes (clock64 counts)")
    ap.add_argument("--sass", metavar="TREE",
                    help="instructions per slot test in the slot kernel of "
                         "the package in TREE (cuobjdump)")
    ap.add_argument("--out", help="with --compare or --profile-walk: write "
                                  "the table here (JSON); with --sass, the "
                                  "listing")
    ap.add_argument("--kernel-times", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.kernel_times:
        return kernel_times(args.kernel_times)
    if args.sass:
        return sass_counts(args.sass, args.out)
    if args.compare:
        return compare(os.path.abspath(args.compare), args.out)
    if args.profile_walk:
        return profile_walk(args.out)
    from tinyraytracing_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    secs, logs = kernels.build()
    log(f"phase 1: kernels built in {secs:.1f}s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # full float32 products everywhere (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ok2, ok2b, reports = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ok3, launches = phase_cli(dev, tmp)
        ok3b, scan_launches = phase_cli_scan(dev, tmp)
        ok3c = phase_cli_persistent(dev, tmp)
        ok3d, near_launches = phase_near_queue(dev)
        ok5 = phase_resume(dev, tmp)
    launches.update(scan_launches)
    launches.update({k: near_launches[k] for k in ("trace_near", "packet_dirs")})
    ok4 = phase_render_vs_render(dev)
    ok4b = phase_scan_vs_scan(dev)
    ok4c = phase_persistent_vs_persistent(dev)

    # no single PyTorch call computes a BVH walk or brute-force closest
    # hit; the packet sums have one (a sum over each packet)
    kern = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                 launches=launches.get(k, 0), max_abs_err=r["max_abs_err"],
                 ms=r.get("ms"), device_ms=r.get("device_ms"),
                 host_ms=r.get("host_ms"), plain_ms=r.get("plain_ms"),
                 bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
                 library_ms=r.get("library_ms"),
                 **({"cases": r["cases"]} if "cases" in r else {}))
            for k, r in reports.items()]
    log(json.dumps({"kernels": kern}))
    phases = {"kernels": ok2, "scan kernels": ok2b, "cli render": ok3,
              "cli scan render": ok3b, "cli persistent render": ok3c,
              "near queue render": ok3d, "render vs render": ok4,
              "scan vs scan": ok4b, "persistent vs persistent": ok4c,
              "chunked resume": ok5}
    log("phases: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                               for k, v in phases.items()))
    if not all(phases.values()):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
