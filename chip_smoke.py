"""GPU smoke test of tinyraytracing_tpu_torch: builds the hand-written CUDA
kernels, holds each against its plain PyTorch version on the card, renders
the 100K-triangle scene through the CLI, and renders a small scene on the
card and on the CPU to compare. Run from the repository root:

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero on any failure (and without
a result when there is no CUDA device). The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

T_RTOL, T_ATOL = 1e-5, 1e-6      # _check_fused tolerance for t
A_TOL = 1e-4                     # ... and for shading normal / texcoord
SOURCE = "tinyraytracing_tpu_torch/csrc/trace.cu"
REPLACES = {
    "trace_closest": "tinyraytracing_tpu/ops/pallas_trace.py:962",
    "trace_occlusion": "tinyraytracing_tpu/ops/pallas_trace.py:206",
}


def log(*a):
    print(*a, flush=True)


def _events_ms(fn, runs):
    """Median milliseconds of ``fn()`` over ``runs`` timed runs (CUDA
    events), after one warm-up run."""
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

    grid, cam = quad_grid(100_000, 1024, 1024)                # leaf 8
    yield "grid100k leaf 8", grid, cam
    yield "grid100k leaf 32", attach_bvh(grid, RenderConfig(leaf_size=32)), cam
    scene, cam = cornell_box(1024, 1024)
    yield "cornell leaf 8", attach_bvh(scene, RenderConfig(leaf_size=8)), cam


def phase_kernels(dev):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.ops import trace

    cfg = RenderConfig()
    reports = {k: {"max_abs_err": 0.0} for k in REPLACES}
    ok = True
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
        for label, r, attrs, occl, kname in cases:
            k = trace.trace_kernel(pk, r, cfg, attrs=attrs, occl=occl)
            p = trace.trace_plain(pk, r, cfg, attrs=attrs, occl=occl)
            torch.cuda.synchronize()
            ok &= _compare(label, k, p, attrs, occl, reports[kname])
            kms = _events_ms(lambda: trace.trace_kernel(
                pk, r, cfg, attrs=attrs, occl=occl), 10)
            pms = _events_ms(lambda: trace.trace_plain(
                pk, r, cfg, attrs=attrs, occl=occl), 2)
            log(f"    time at {r.shape[1]} rays: kernel {kms:.4f} ms, "
                f"plain {pms:.1f} ms (median, CUDA events)")
            # the main path's dispatches: bounce and shadow rays on its tree
            if name == "grid100k leaf 8" and label in (
                    "closest attrs", "shadow occlusion"):
                reports[kname].update(ms=kms, plain_ms=pms)
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
        t0 = time.perf_counter()
    return ok, reports


# ---------------------------------------------------------------------------
# phase 3: the CLI at full size
# ---------------------------------------------------------------------------

def phase_cli(dev, out_dir):
    import tinyraytracing_tpu_torch.integrator.fused_queue as fq
    from tinyraytracing_tpu_torch import cli
    from tinyraytracing_tpu_torch.ops import trace

    seen = {}
    kernel_events = []
    real_render, real_kernel = fq.render_fused_queue, trace.trace_kernel

    def render_rec(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = real_render(*a, **k)
        torch.cuda.synchronize()
        seen.update(img=img, rays=float(rays), seconds=time.perf_counter() - t0)
        return img, rays

    def kernel_rec(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_kernel(*a, **k)
        e1.record()
        kernel_events.append((e0, e1))
        return out

    out = f"{out_dir}/grid100k.png"
    argv = ["--scene", "grid:100000", "--width", "1024", "--height", "1024",
            "--spp", "4", "--out", out]
    torch.cuda.reset_peak_memory_stats()
    fq.render_fused_queue, trace.trace_kernel = render_rec, kernel_rec
    trace.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        fq.render_fused_queue, trace.trace_kernel = real_render, real_kernel
    launches = dict(trace.LAUNCHES)
    torch.cuda.synchronize()
    kms = sum(a.elapsed_time(b) for a, b in kernel_events)
    render_ms = seen["seconds"] * 1e3
    img = seen["img"]
    mean = float(img.mean())
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 3: cli {' '.join(argv[:-2])} (spp cut from config 3's 512 to 4 "
        f"only to fit the smoke's time limit) -> rc {rc}")
    log(f"  cli wall {wall:.2f}s incl. scene + BVH build; render {seen['seconds']:.3f}s, "
        f"{seen['rays']:.0f} traced rays, {seen['rays'] / seen['seconds']:.4g} rays/s")
    log(f"  kernel launches {launches}; time in kernels {kms:.1f} ms = "
        f"{100 * kms / render_ms:.1f}% of the render, rest {render_ms - kms:.1f} ms")
    log(f"  peak device memory {peak / 2**20:.1f} MiB; image mean {mean:.6g}, "
        f"shape {tuple(img.shape)}")
    ok = (rc == 0 and all(v > 0 for v in launches.values())
          and bool(torch.isfinite(img).all()) and mean > 0)
    return ok, launches


# ---------------------------------------------------------------------------
# phase 4: the same render on the card and on the CPU
# ---------------------------------------------------------------------------

def phase_render_vs_render(dev):
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    scene, cam = quad_grid(6000, 64, 64)
    cfg, key = RenderConfig(), master_key_data(0)
    imgs, secs = {}, {}
    for where, s in (("cuda", scene.to(dev)), ("cpu", scene)):
        t0 = time.perf_counter()
        img, _ = render_fused_queue(s, cam, key, cfg, 4, lanes=4096)
        imgs[where] = img.cpu().reshape(64, 64, 3)
        secs[where] = time.perf_counter() - t0
    a, b = imgs["cuda"], imgs["cpu"]
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)
    diff = (a - b).abs().amax(dim=-1)
    worst = int(diff.argmax())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"phase 4: grid:6000 64x64 @ 4 spp, 4096 lanes: cuda {secs['cuda']:.2f}s, "
        f"cpu {secs['cpu']:.2f}s; {int((~close).sum())} of {close.numel()} pixels "
        f"outside rtol 1e-4/atol 1e-5 (bound: 1%), image means differ "
        f"{mean_rel:.3g} relative (bound 1e-4); worst pixel {divmod(worst, 64)} "
        f"off by {float(diff.max()):.4g} ({a.view(-1, 3)[worst].tolist()} vs "
        f"{b.view(-1, 3)[worst].tolist()})")
    return bool(close.float().mean() >= 0.99) and mean_rel <= 1e-4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    ok2, reports = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ok3, launches = phase_cli(dev, tmp)
    ok4 = phase_render_vs_render(dev)

    kern = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                 launches=launches.get(k, 0), max_abs_err=r["max_abs_err"],
                 ms=r.get("ms"), plain_ms=r.get("plain_ms"))
            for k, r in reports.items()]
    log(json.dumps({"kernels": kern}))
    ok = ok2 and ok3 and ok4
    log(f"phases: kernels {'ok' if ok2 else 'FAILED'}, cli render "
        f"{'ok' if ok3 else 'FAILED'}, render vs render {'ok' if ok4 else 'FAILED'}")
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
