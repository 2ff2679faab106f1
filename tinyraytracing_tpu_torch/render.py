"""Top-level render entry points, the counterpart of
``tinyraytracing_tpu/render.py``: the scan renderer (``render_pass``,
``render``) and ``render_image``.

The scan renderer runs ``spp`` passes; each pass generates one jittered
camera ray per pixel and traces them in chunks of ``config.ray_chunk``
through the fixed-depth wavefront (``integrator/wavefront.py``). The
chunking is part of the sample stream, as in the JAX package: chunk i
draws with ``fold_in(k_trace, i)``, the last chunk is padded with the
first rays, and pass s uses ``fold_in(key, s)``.

The fused renderers: the queue-fed wavefront
(``integrator/fused_queue.py``, for scenes of 512 or more triangles) and
the pixel-persistent one (``integrator/fused.py``, for smaller scenes).
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from tinyraytracing_tpu_torch.integrator.fused import render_fused_image
from tinyraytracing_tpu_torch.integrator.fused_queue import (
    render_fused_queue_chunked, render_fused_queue_image,
)
from tinyraytracing_tpu_torch.integrator.wavefront import trace
from tinyraytracing_tpu_torch.io.image import write_png
from tinyraytracing_tpu_torch.models.camera import Camera, generate_rays
from tinyraytracing_tpu_torch.models.scene import Scene
from tinyraytracing_tpu_torch.ops.rng import fold_in, master_key_data, split

# the queue pays a per-iteration scatter-add that dominates on tiny scenes;
# the JAX package measured the switch point (its benchmarks/renderers_ab.py)
_QUEUE_MIN_TRIS = 512


def render_pass(scene: Scene, cam: Camera, key, config: RenderConfig):
    """One spp pass: (H, W, 3) radiance for one jittered ray per pixel, on
    the scene's device. ``key``: (k0, k1) key words."""
    W, H = cam.width, cam.height
    k_ray, k_trace = split(key)
    org, d = generate_rays(cam, k_ray, scene.device)

    n = org.shape[0]
    chunk = min(config.ray_chunk, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        org = torch.cat([org, org[:pad]])
        d = torch.cat([d, d[:pad]])
    rad = [trace(scene, org[i * chunk:(i + 1) * chunk], d[i * chunk:(i + 1) * chunk],
                 fold_in(k_trace, i), config)
           for i in range(n_chunks)]
    return torch.cat(rad)[:n].reshape(H, W, 3)


def render(scene: Scene, cam: Camera, key, config: RenderConfig = DEFAULT_CONFIG,
           spp: int | None = None):
    """Render the mean image over ``spp`` passes. Returns (H, W, 3) linear
    float32 on the scene's device. ``key``: (k0, k1) key words
    (``ops.rng.master_key_data(seed)`` is ``jax.random.PRNGKey(seed)``)."""
    spp = spp or config.spp
    acc = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32,
                      device=scene.device)
    for s in range(spp):
        acc = acc + render_pass(scene, cam, fold_in(key, s), config)
    return acc / torch.tensor(float(spp), dtype=torch.float32, device=acc.device)


def pick_renderer(scene: Scene) -> str:
    """Auto renderer choice: pixel-persistent for tiny scenes, queue-fed
    fused wavefront otherwise (the JAX package's rule)."""
    return "queue" if scene.num_triangles >= _QUEUE_MIN_TRIS else "persistent"


def render_image(
    scene: Scene,
    cam: Camera,
    config: RenderConfig = DEFAULT_CONFIG,
    spp: int | None = None,
    seed: int = 0,
    out_path: str | None = None,
    renderer: str = "auto",
    lanes: int = 262144,
    checkpoint_path: str | None = None,
    resume: bool = False,
    progress=None,
) -> np.ndarray:
    """Render on the scene's device, pull to host, optionally write a PNG.
    Returns the linear (H, W, 3) numpy image. The seed gives the same
    sample streams as the JAX package's ``jax.random.PRNGKey(seed)``.

    ``renderer``: "auto" (by scene size), "queue" (queue-fed fused
    wavefront), "persistent" (pixel-persistent fused wavefront) or "scan"
    (fixed-depth wavefront, any ``config.intersector``). The fused
    renderers attach a BVH when the scene has none. On the card the queue
    renders in chunks (``render_fused_queue_chunked``), as the JAX package
    renders it on an accelerator, and ``checkpoint_path`` / ``resume``
    snapshot and resume its lane state; on the CPU it renders in one loop,
    or in chunks when a checkpoint is asked for (the same image, bit for
    bit). ``progress`` goes to the chunked driver. Other renderers ignore
    the three."""
    spp_val = spp or config.spp
    if renderer == "auto":
        renderer = pick_renderer(scene)
    key = master_key_data(seed)
    if renderer in ("persistent", "queue") and (
            scene.bvh is None or scene.bvh.packed is None):
        from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

        scene = attach_bvh(scene, config)
    if renderer == "scan":
        img = render(scene, cam, key, config, spp_val)
    elif renderer == "persistent":
        img = render_fused_image(scene, cam, key, config, spp_val, lanes)
    elif renderer == "queue":
        if scene.device.type == "cpu" and not (checkpoint_path or resume):
            img = render_fused_queue_image(scene, cam, key, config, spp_val,
                                           lanes)
        else:
            img, _ = render_fused_queue_chunked(
                scene, cam, key, config, spp_val, lanes,
                checkpoint_path=checkpoint_path, resume=resume,
                progress=progress)
            img = img.reshape(cam.height, cam.width, 3)
    else:
        raise ValueError(f"unknown renderer {renderer!r}")
    img = img.cpu().numpy()
    if out_path:
        write_png(out_path, img)
    return img
