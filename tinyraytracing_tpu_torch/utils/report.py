"""Per-render observability report, the counterpart of
``tinyraytracing_tpu/utils/report.py``: scene statistics, BVH quality,
traced-ray counts and throughput (rays/s), optionally with a
``torch.profiler`` trace of the render in place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch


@dataclasses.dataclass
class RenderReport:
    num_triangles: int
    num_materials: int
    num_lights: int
    bvh_nodes: int | None
    bvh_depth: int | None
    width: int
    height: int
    spp: int
    seconds: float
    rays_traced: int
    rays_per_s: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def bvh_depth(skip) -> int:
    """Max depth of the preorder skip-link tree."""
    skip = np.asarray(skip)
    n = len(skip)
    depth = np.zeros(n, np.int32)
    stack = []
    for i in range(n):
        while stack and stack[-1] <= i:
            stack.pop()
        depth[i] = len(stack)
        if skip[i] > i + 1:
            stack.append(skip[i])
    return int(depth.max()) + 1 if n else 0


def profiled_render(scene, cam, config, spp, seed=0, trace_dir=None):
    """Render ``spp`` passes of the scan renderer's estimator (one
    ``wavefront.trace`` of every pixel per pass, pass s from
    ``fold_in(key, s)``) on the scene's device, timed; returns (the mean
    image as float32 numpy, RenderReport). ``rays_traced`` is what
    ``trace(..., return_stats=True)`` counts: closest-hit plus shadow
    rays. With ``trace_dir``, the timed passes run under
    ``torch.profiler`` and its Chrome trace is written there."""
    from tinyraytracing_tpu_torch.integrator.wavefront import trace
    from tinyraytracing_tpu_torch.models.camera import generate_rays
    from tinyraytracing_tpu_torch.ops.rng import fold_in, master_key_data, split

    key = master_key_data(seed)
    dev = scene.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def one_pass(k):
        k1, k2 = split(k)
        o, d = generate_rays(cam, k1, dev)
        rad, stats = trace(scene, o, d, k2, config, return_stats=True)
        return (rad.reshape(cam.height, cam.width, 3),
                stats["primary"].sum() + stats["shadow"].sum())

    # kernel builds and the scene's device records outside the timed region
    one_pass(fold_in(key, 0))
    sync()

    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        ctx = profile(activities=acts)
    else:
        ctx = contextlib.nullcontext()
    acc = np.zeros((cam.height, cam.width, 3), np.float64)
    total_rays = 0
    t0 = time.perf_counter()
    with ctx as prof:
        for s in range(spp):
            img, nrays = one_pass(fold_in(key, s))
            acc += img.cpu().numpy()
            total_rays += int(nrays)
        sync()
    dt = time.perf_counter() - t0
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    report = RenderReport(
        num_triangles=scene.num_triangles,
        num_materials=scene.num_materials,
        num_lights=scene.num_lights,
        bvh_nodes=scene.bvh.n_nodes if scene.bvh is not None else None,
        bvh_depth=(
            bvh_depth(scene.bvh.skip.cpu().numpy())
            if scene.bvh is not None else None
        ),
        width=cam.width,
        height=cam.height,
        spp=spp,
        seconds=dt,
        rays_traced=total_rays,
        rays_per_s=total_rays / dt if dt > 0 else 0.0,
    )
    return (acc / spp).astype(np.float32), report
