"""Render the cases of tests/test_torch_render.py (the queue renderer, and
the persistent one for the configs named "persistent*") with both
packages, with the arithmetic of the two aligned, and save the images:

    XLA_FLAGS=--xla_cpu_max_isa=AVX JAX_PLATFORMS=cpu \\
        python -m tests.torch_aligned_render OUT.npz [SCENE ...]

A SCENE written ``scan:<scene>`` renders the scan-renderer cases of
tests/test_torch_scan_render.py (``SCAN_CASES``) instead of the queue's;
one written ``textured:<dir>`` loads the scene files of
tests/test_torch_textures.py from ``<dir>`` with each package's
``load_scene`` and renders ``TEXTURED_CASES``; one written ``diff:<scene>``
saves the fast differentiable path's image (``render_diff``) and the
gradients of ``render_loss_fast`` and of the scan renderer's
``render_loss`` in ``DIFF_FIELDS`` (tests/test_torch_diff.py); one written
``regen:<scene>`` renders the regeneration oracles' ``REGEN_CASES``
(tests/test_torch_regen.py); one written ``sharded:<scene>[:<kind>]``
renders ``SHARDED_CASES`` (those of renderer ``<kind>``: scan, fused,
queue, or "slices" for the slices alone) with the JAX package's sharded renderers on a 2x2 mesh
of its first four devices (run it with
``--xla_force_host_platform_device_count=8`` in XLA_FLAGS, as
tests/conftest.py sets it) and with the port's per-rank shares, and the
queue renderer on the path-queue slices ``SLICES``
(tests/test_torch_parallel.py).

Three things make the JAX package's CPU render differ from the port's in
the last ulp, and each of them alone flips a few shadow and bounce
decisions (a ray grazing its own surface just past t_min), so a few
percent of the pixels of a 16x16 render move by one path's share:

- XLA's CPU backend contracts a*b+c into a fused multiply-add; PyTorch's
  eager CPU ops never do, and the port's CUDA kernel is built with
  --fmad=false. ``--xla_cpu_max_isa=AVX`` (an ISA without FMA) turns the
  contraction off; the flag must be set before XLA starts, hence a
  process of its own.
- On the CPU, the JAX package's ``fused_trace_planes`` runs its
  Moller-Trumbore reference, not the Woop-plane walk of its kernel. Here
  it runs the kernel in interpret mode (``force_kernel=True``). (The scan
  renderer's "bvh_pallas" and "pallas" backends run their kernels in
  interpret mode on the CPU anyway.)
- XLA's sqrt, rsqrt, sin, cos, arcsin, arccos and pow differ from
  PyTorch's in the last ulp. Here the port computes them with XLA's (their
  derivatives with PyTorch's, so gradients flow through them).

With all three aligned the two renders agree to float rounding of the
pixel sums; tests/test_torch_render.py holds them to that.
"""

from __future__ import annotations

import functools
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

import tinyraytracing_tpu.diff.fast as jfast  # noqa: E402
import tinyraytracing_tpu.ops.pallas_trace as jtrace  # noqa: E402
from tinyraytracing_tpu.config import RenderConfig as JConfig  # noqa: E402
from tinyraytracing_tpu.integrator.fused import render_fused_stats_jit  # noqa: E402
from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit  # noqa: E402
from tinyraytracing_tpu.models import procedural as jproc  # noqa: E402
from tinyraytracing_tpu.ops.bvh import attach_bvh  # noqa: E402
from tinyraytracing_tpu.render import render as jax_scan_render  # noqa: E402
from tinyraytracing_tpu.render import render_image as jax_render_image  # noqa: E402
from tinyraytracing_tpu_torch.config import RenderConfig  # noqa: E402
from tinyraytracing_tpu_torch.integrator.fused import render_fused_stats  # noqa: E402
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue  # noqa: E402
from tinyraytracing_tpu_torch.models.camera import Camera  # noqa: E402
from tinyraytracing_tpu_torch.ops import vec  # noqa: E402
from tinyraytracing_tpu_torch.ops.rng import master_key_data  # noqa: E402
from tinyraytracing_tpu_torch.render import render as port_scan_render  # noqa: E402
from tinyraytracing_tpu_torch.render import render_image as port_render_image  # noqa: E402
from tests.torch_port_util import port_scene  # noqa: E402

SIZE, SPP, LANES, SEED = 16, 2, 512, 3

CONFIGS = {
    "default": {},
    "compact": dict(shadow_compact="on"),
    "morton": dict(queue_resort_every=1, queue_resort_key="morton"),
    "tmin": dict(shadow_test="tmin"),
    # the queue's other refill / resort policies, once each
    "row": dict(queue_refill="row", queue_resort_every=2),
    "octant": dict(queue_resort_every=1, queue_resort_key="path_octant",
                   light_sampler="uniform", specular_weight="ks"),
    # the near-first walk in packets of 256 lanes (two per bounce dispatch)
    "near": dict(walk_order="near", bvh_walk="wide", ray_tile=256),
    "near_compact": dict(walk_order="near", bvh_walk="wide", ray_tile=256,
                         shadow_compact="on"),
    # the persistent renderer (its merged bounce + shadow dispatch)
    "persistent": {},
    "persistent_tmin": dict(shadow_test="tmin", light_sampler="uniform"),
}
CASES = ([(n, c) for n in ("cornell", "grid600")
          for c in ("default", "compact", "morton", "tmin", "near",
                    "persistent")]
         + [("grid600", "row"), ("cornell", "octant"),
            ("grid600", "near_compact"), ("cornell", "persistent_tmin")])

# the scan renderer: every intersector backend on both scenes (the
# "*pallas" ones as the JAX kernels in interpret mode and the port's plain
# versions), and ray chunks smaller than the image: 2 chunks, and 3 with
# the last one padded by the first rays
SCAN_CONFIGS = {
    "bvh": dict(intersector="bvh"),
    "mxu": dict(intersector="mxu"),
    "bvh_pallas": dict(intersector="bvh_pallas"),
    "pallas": dict(intersector="pallas"),
    "chunk128": dict(intersector="bvh", ray_chunk=128),
    "chunk96": dict(intersector="bvh", ray_chunk=96, light_sampler="uniform",
                    specular_weight="ks", shadow_test="tmin"),
}
SCAN_CASES = ([(n, c) for n in ("cornell", "grid600")
               for c in ("bvh", "mxu", "bvh_pallas", "pallas")]
              + [("cornell", "chunk128"), ("grid600", "chunk96")])

# a textured scene loaded from files: the scan renderer through the slot
# intersector, and render_image's default renderer (the persistent one
# below 512 triangles)
TEXTURED_FILES = ("scene.xml", "scene.obj", "scene.mtl")
TEXTURED_CASES = ("scan_pallas", "default")


def scenes(name):
    """(JAX scene, JAX camera, port scene, port camera), same arrays."""
    if name == "cornell":
        js, jcam = jproc.cornell_box(SIZE, SIZE)
        js = attach_bvh(js, JConfig())
    else:
        js, jcam = jproc.quad_grid(600, SIZE, SIZE)
    tcam = Camera.create(np.array(jcam.eye), np.array(jcam.lookat),
                         np.array(jcam.up), float(jcam.fovy),
                         jcam.width, jcam.height)
    return js, jcam, port_scene(js), tcam


def on_xla(fn, torch_fn):
    """A torch-tensor function whose value XLA computes (this process's
    flags) and whose derivative is that of the PyTorch function
    ``torch_fn``, the same function."""
    jf = jax.jit(fn)

    class OnXla(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.args = args
            a = [x.detach().numpy() if isinstance(x, torch.Tensor) else x
                 for x in args]
            return torch.from_numpy(np.array(jf(*a)))

        @staticmethod
        def backward(ctx, g):
            diff = lambda x: isinstance(x, torch.Tensor) and x.is_floating_point()
            with torch.enable_grad():
                xs = [x.detach().requires_grad_() if diff(x) else x
                      for x in ctx.args]
                out = torch_fn(*xs)
                gs = iter(torch.autograd.grad(
                    out, [x for x in xs if diff(x)], g.to(out.dtype),
                    allow_unused=True))
            return tuple(next(gs) if diff(x) else None for x in ctx.args)

    return OnXla.apply


def align():
    """The JAX renderers trace with their kernel; the port's
    transcendentals are XLA's (normalize as the JAX package's:
    x * rsqrt(max(|x|^2, 1e-30)))."""
    jtrace.fused_trace_planes = functools.partial(jtrace.fused_trace_planes,
                                                  force_kernel=True)
    jfast.fused_trace_planes = jtrace.fused_trace_planes
    for name, fn in (("sqrt", jnp.sqrt), ("sin", jnp.sin), ("cos", jnp.cos),
                     ("arcsin", jnp.arcsin), ("arccos", jnp.arccos),
                     ("pow", jnp.power)):
        setattr(torch, name, on_xla(fn, getattr(torch, name)))
    rsqrt = on_xla(lambda l2: lax.rsqrt(jnp.maximum(l2, 1e-30)),
                   lambda l2: torch.rsqrt(torch.clamp_min(l2, 1e-30)))
    vec.normalize = lambda a: vec.scale(a, rsqrt(vec.length2(a)))


def scan_images(name, images):
    """The scan-renderer cases of scene ``name``, both packages."""
    js, jcam, ts, tcam = scenes(name)
    for case, cfg in SCAN_CASES:
        if case != name:
            continue
        kw = SCAN_CONFIGS[cfg]
        images[f"scan-{name}-{cfg}-jax"] = np.asarray(jax_scan_render(
            js, jcam, jax.random.PRNGKey(SEED), JConfig(**kw), SPP))
        images[f"scan-{name}-{cfg}-port"] = port_scan_render(
            ts, tcam, master_key_data(SEED), RenderConfig(**kw), SPP).numpy()


def textured_scenes(directory):
    """(JAX scene, JAX camera, port scene, port camera) of the scene files
    in ``directory``, each loaded by its own package with a BVH."""
    import os

    from tinyraytracing_tpu.models.scene import load_scene as jax_load
    from tinyraytracing_tpu_torch.models.scene import load_scene as port_load

    paths = [os.path.join(directory, f) for f in TEXTURED_FILES]
    js, jcam = jax_load(*paths, with_bvh=True)
    ts, tcam = port_load(*paths, with_bvh=True, device="cpu")
    return js, jcam, ts, tcam


def textured_images(directory, images):
    """The textured cases, both packages, and the port's default render
    once more with no material textured."""
    import dataclasses

    js, jcam, ts, tcam = textured_scenes(directory)
    scan = dict(intersector="pallas")
    images["textured-scan_pallas-jax"] = np.asarray(jax_scan_render(
        js, jcam, jax.random.PRNGKey(SEED), JConfig(**scan), SPP))
    images["textured-scan_pallas-port"] = port_scan_render(
        ts, tcam, master_key_data(SEED), RenderConfig(**scan), SPP).numpy()
    images["textured-default-jax"] = jax_render_image(
        js, jcam, JConfig(), spp=SPP, seed=SEED, lanes=LANES)
    images["textured-default-port"] = port_render_image(
        ts, tcam, RenderConfig(), spp=SPP, seed=SEED, lanes=LANES)
    plain = dataclasses.replace(ts, tex_id=torch.full_like(ts.tex_id, -1))
    images["textured-default-untextured"] = port_render_image(
        plain, tcam, RenderConfig(), spp=SPP, seed=SEED, lanes=LANES)


# the differentiable paths: render_diff's image, and the losses of
# render_loss_fast ("fast") and of render_loss over the scan renderer with
# the brute intersector ("scan") against a black target, with their
# gradients in these parameters, at this depth
DIFF_FIELDS = ("kd", "radiance", "vertex_offset", "eye")
DIFF_DEPTH = 3


def diff_arrays(name, images):
    """The differentiable paths on scene ``name`` (with refit metadata),
    both packages: the image, the losses and their gradients."""
    from tinyraytracing_tpu.diff.inverse import SceneParams as JParams
    from tinyraytracing_tpu.diff.inverse import render_loss as jax_render_loss
    from tinyraytracing_tpu_torch.diff import (
        SceneParams, render_diff, render_loss, render_loss_fast,
    )

    js, jcam, ts, tcam = scenes(name)
    jkey, tkey = jax.random.PRNGKey(SEED), master_key_data(SEED)
    target = np.zeros((SIZE, SIZE, 3), np.float32)
    jcfg, tcfg = JConfig(max_depth=DIFF_DEPTH), RenderConfig(max_depth=DIFF_DEPTH)
    images[f"diff-{name}-image-jax"] = np.asarray(
        jfast.render_diff(js, jcam, jkey, jcfg, SPP))
    with torch.no_grad():
        images[f"diff-{name}-image-port"] = render_diff(
            ts, tcam, tkey, tcfg, SPP).numpy()
    losses = (("fast", jfast.render_loss_fast, render_loss_fast, {}),
              ("scan", jax_render_loss, render_loss, dict(intersector="brute")))
    for kind, jloss, tloss_fn, kw in losses:
        jcfg = JConfig(max_depth=DIFF_DEPTH, **kw)
        tcfg = RenderConfig(max_depth=DIFF_DEPTH, **kw)
        p0 = JParams.init_from(js, jcam, *DIFF_FIELDS)
        loss, g = jax.jit(jax.value_and_grad(lambda p: jloss(
            p, js, jcam, jkey, jnp.asarray(target), jcfg, SPP)))(p0)
        images[f"diff-{name}-{kind}-loss-jax"] = np.float32(loss)
        p = SceneParams.init_from(ts, tcam, *DIFF_FIELDS)
        for t in p.tensors():
            t.requires_grad_(True)
        tloss = tloss_fn(p, ts, tcam, tkey, torch.from_numpy(target), tcfg, SPP)
        tloss.backward()
        images[f"diff-{name}-{kind}-loss-port"] = np.float32(tloss.item())
        for f in DIFF_FIELDS:
            images[f"diff-{name}-{kind}-grad-{f}-jax"] = np.asarray(getattr(g, f))
            images[f"diff-{name}-{kind}-grad-{f}-port"] = getattr(p, f).grad.numpy()


# the regeneration oracles (integrator/regen.py): (renderer, lanes) with
# the "mxu" intersector at depth 4, as the JAX package's tests run them;
# 300 lanes do not divide the 512 paths, 64 and 100 lanes take 4 and 3
# epochs of the 256 pixels (the last one padded)
REGEN_CASES = {"regen": ("regen", 512), "regen_ragged": ("regen", 300),
               "persistent": ("persistent", 256),
               "persistent_epochs": ("persistent", 64),
               "persistent_ragged": ("persistent", 100)}
REGEN_CONFIG = dict(intersector="mxu", max_depth=4, tri_chunk=64)


def regen_images(name, images):
    """The regeneration oracles' cases on scene ``name``, both packages:
    images and traced-ray counts."""
    from tinyraytracing_tpu.integrator import regen as jregen
    from tinyraytracing_tpu_torch.integrator import regen

    js, jcam, ts, tcam = scenes(name)
    for case, (kind, lanes) in REGEN_CASES.items():
        jfn = getattr(jregen, f"render_{kind}_stats_jit")
        tfn = getattr(regen, f"render_{kind}_stats")
        jimg, jrays = jfn(js, jcam, jax.random.PRNGKey(SEED),
                          JConfig(**REGEN_CONFIG), SPP, lanes=lanes)
        img, rays = tfn(ts, tcam, master_key_data(SEED),
                        RenderConfig(**REGEN_CONFIG), SPP, lanes=lanes)
        images[f"regen-{name}-{case}-jax"] = np.asarray(jimg)
        images[f"regen-{name}-{case}-port"] = img.numpy()
        images[f"regen-{name}-{case}-rays-jax"] = np.float32(jrays)
        images[f"regen-{name}-{case}-rays-port"] = np.float32(rays)


# the sharded renderers on a 2x2 mesh: case -> (renderer, width, height,
# spp); the 15x13 image has a pixel count 4 does not divide, spp 5 pads
# the spp axis of 2
SHARDED_CASES = {"scan": ("scan", 16, 16, 2),
                 "scan_ragged": ("scan", 15, 13, 5),
                 "fused": ("fused", 16, 16, 2),
                 "fused_ragged": ("fused", 15, 13, 2),
                 "queue": ("queue", 16, 16, 2),
                 "queue_ragged": ("queue", 15, 13, 5)}
SHARDED_CONFIG = dict(intersector="bvh")
# path-queue slices (path_lo, n_paths) of the 16x16 x SLICE_SPP = 1,024
# paths at 128 lanes: no n_paths is a multiple of 128, and the last slice
# reaches past the path count
SLICE_SPP = 4
SLICES = ((0, 300), (300, 400), (700, 400))


def sharded_images(name, images, kind=None):
    """The sharded cases on scene ``name`` (of renderer ``kind``, default
    all), both packages: JAX's sharded renderers on a 2x2 mesh, the
    port's shares combined as its collectives combine them; and the
    path-queue slices (kind None or "slices")."""
    import dataclasses

    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue as jqueue
    from tinyraytracing_tpu.parallel import mesh as jmesh
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue as tqueue
    from tinyraytracing_tpu_torch.parallel import mesh as tmesh
    from tests.torch_parallel_ranks import serial_render_sharded

    js, jcam0, ts, tcam0 = scenes(name)
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    jcfg, tcfg = JConfig(**SHARDED_CONFIG), RenderConfig(**SHARDED_CONFIG)
    jkey, tkey = jax.random.PRNGKey(SEED), master_key_data(SEED)
    for case, (renderer, w, h, spp) in SHARDED_CASES.items():
        if kind not in (None, renderer):
            continue
        jcam = dataclasses.replace(jcam0, width=w, height=h)
        tcam = dataclasses.replace(tcam0, width=w, height=h)
        if renderer == "scan":
            jimg = jmesh.render_sharded(js, jcam, jkey, jcfg, mesh, spp=spp)
            img = serial_render_sharded(ts, tcam, tkey, tcfg, spp, 2, 2)
        elif renderer == "fused":
            jimg, jrays = jmesh.render_fused_sharded(js, jcam, jkey, jcfg, spp,
                                                     mesh, lanes=LANES)
            shares = [tmesh._fused_share(ts, tcam, tkey, tcfg, spp, LANES, 4, r)
                      for r in range(4)]
            img = tmesh._slots_to_image(torch.cat([x for x, _ in shares]), tcam)
            rays = sum(float(y) for _, y in shares)
        else:
            jimg, jrays = jmesh.render_queue_sharded(js, jcam, jkey, jcfg, spp,
                                                     mesh, lanes=LANES)
            shares = [tmesh._queue_share(ts, tcam, tkey, tcfg, spp, LANES, 4, r)
                      for r in range(4)]
            img = shares[0][0] + shares[1][0] + shares[2][0] + shares[3][0]
            rays = sum(float(y) for _, y in shares)
        images[f"sharded-{case}-jax"] = np.asarray(jimg).reshape(h, w, 3)
        images[f"sharded-{case}-port"] = img.reshape(h, w, 3).numpy()
        if renderer != "scan":
            images[f"sharded-{case}-rays-jax"] = np.float32(jrays)
            images[f"sharded-{case}-rays-port"] = np.float32(rays)
    if kind not in (None, "slices"):
        return
    # the path-queue slices and the whole queue, 16x16
    jq = jax.jit(jqueue, static_argnames=("config", "spp", "lanes",
                                          "n_paths"))
    for lo, n in SLICES + ((0, None),):
        tag = "full" if n is None else lo
        jimg, jrays = jq(js, jcam0, jkey, jcfg, SLICE_SPP, lanes=128,
                         path_lo=lo, n_paths=n)
        img, rays = tqueue(ts, tcam0, tkey, tcfg, SLICE_SPP, lanes=128,
                           path_lo=lo, n_paths=n)
        images[f"slice-{tag}-jax"] = np.asarray(jimg)
        images[f"slice-{tag}-port"] = img.numpy()
        images[f"slice-{tag}-rays-jax"] = np.float32(jrays)
        images[f"slice-{tag}-rays-port"] = np.float32(rays)


def run_processes(out_dir, names):
    """Render ``names`` (one process each, side by side, with FMA
    contraction off) into ``out_dir``; returns all their images."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX"))
    outs = [os.path.join(out_dir, f"{i}-{n.split(':')[0]}.npz")
            for i, n in enumerate(names)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_aligned_render",
                               out, n], cwd=root, env=env)
             for out, n in zip(outs, names)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0] * len(names), rcs
    images = {}
    for out in outs:
        with np.load(out) as f:
            images.update(f)
    return images


def main(out, names):
    """Render the cases of the scenes ``names`` (default: all queue cases)
    into OUT."""
    align()
    images = {}
    queue = [n for n in names if ":" not in n]
    for name in names:
        if name.startswith("scan:"):
            scan_images(name[5:], images)
        elif name.startswith("textured:"):
            textured_images(name[9:], images)
        elif name.startswith("diff:"):
            diff_arrays(name[5:], images)
        elif name.startswith("regen:"):
            regen_images(name[6:], images)
        elif name.startswith("sharded:"):
            scene, *kind = name.split(":")[1:]
            sharded_images(scene, images, *kind)
    if not names:
        queue = list(dict.fromkeys(n for n, _ in CASES))
    for name in queue:
        js, jcam, ts, tcam = scenes(name)
        for case, cfg in CASES:
            if case != name:
                continue
            kw = CONFIGS[cfg]
            jkey, tkey = jax.random.PRNGKey(SEED), master_key_data(SEED)
            if cfg.startswith("persistent"):
                jimg, _ = render_fused_stats_jit(js, jcam, jkey, JConfig(**kw),
                                                 SPP, lanes=LANES)
                img, rays = render_fused_stats(ts, tcam, tkey,
                                               RenderConfig(**kw), SPP,
                                               lanes=LANES)
            else:
                jimg = render_fused_queue_jit(js, jcam, jkey, JConfig(**kw),
                                              SPP, lanes=LANES)
                img, rays = render_fused_queue(ts, tcam, tkey,
                                               RenderConfig(**kw), SPP,
                                               lanes=LANES)
            images[f"{name}-{cfg}-jax"] = np.asarray(jimg)
            images[f"{name}-{cfg}-port"] = img.reshape(SIZE, SIZE, 3).numpy()
            images[f"{name}-{cfg}-rays"] = np.float32(rays)
    np.savez(out, **images)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
