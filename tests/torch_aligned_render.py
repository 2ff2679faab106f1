"""Render the cases of tests/test_torch_render.py (the queue renderer, and
the persistent one for the configs named "persistent*") with both
packages, with the arithmetic of the two aligned, and save the images:

    XLA_FLAGS=--xla_cpu_max_isa=AVX JAX_PLATFORMS=cpu \\
        python -m tests.torch_aligned_render OUT.npz [SCENE ...]

A SCENE written ``scan:<scene>`` renders the scan-renderer cases of
tests/test_torch_scan_render.py (``SCAN_CASES``) instead of the queue's;
one written ``textured:<dir>`` loads the scene files of
tests/test_torch_textures.py from ``<dir>`` with each package's
``load_scene`` and renders ``TEXTURED_CASES``.

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
  PyTorch's in the last ulp. Here the port computes them with XLA's.

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


def on_xla(fn):
    """A torch-tensor function computed by XLA (this process's flags)."""
    jf = jax.jit(fn)

    def call(*args):
        a = [x.numpy() if isinstance(x, torch.Tensor) else x for x in args]
        return torch.from_numpy(np.array(jf(*a)))
    return call


def align():
    """The JAX renderer traces with its kernel; the port's transcendentals
    are XLA's (normalize as the JAX package's: x * rsqrt(max(|x|^2, 1e-30)))."""
    jtrace.fused_trace_planes = functools.partial(jtrace.fused_trace_planes,
                                                  force_kernel=True)
    for name, fn in (("sqrt", jnp.sqrt), ("sin", jnp.sin), ("cos", jnp.cos),
                     ("arcsin", jnp.arcsin), ("arccos", jnp.arccos),
                     ("pow", jnp.power)):
        setattr(torch, name, on_xla(fn))
    rsqrt = on_xla(lambda l2: lax.rsqrt(jnp.maximum(l2, 1e-30)))
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
