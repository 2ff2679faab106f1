"""Top-level render entry point, the counterpart of
``tinyraytracing_tpu/render.py::render_image``.

Only the queue-fed fused wavefront is ported so far; the other renderers
and checkpointed renders raise ``NotImplementedError`` naming their
ROADMAP.md item instead of silently running something else.
"""

from __future__ import annotations

import numpy as np

from tinyraytracing_tpu_torch.config import (
    DEFAULT_CONFIG, RenderConfig, check_ported,
)
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue_image
from tinyraytracing_tpu_torch.io.image import write_png
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.scene import Scene
from tinyraytracing_tpu_torch.ops.rng import master_key_data

# the queue pays a per-iteration scatter-add that dominates on tiny scenes;
# the JAX package measured the switch point (its benchmarks/renderers_ab.py)
_QUEUE_MIN_TRIS = 512

_NOT_PORTED = {
    "persistent": "the persistent renderer (ROADMAP.md, modules to port, "
                  "item 1: integrator/fused.py::render_fused)",
    "scan": "the scan renderer (ROADMAP.md, modules to port, item 6: "
            "oracle renderers)",
}


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
) -> np.ndarray:
    """Render on the scene's device, pull to host, optionally write a PNG.
    Returns the linear (H, W, 3) numpy image. The seed gives the same
    sample streams as the JAX package's ``jax.random.PRNGKey(seed)``."""
    check_ported(config)
    if checkpoint_path is not None or resume:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP.md, modules to "
            "port, item 2: the chunked queue loop)")
    spp_val = spp or config.spp
    if renderer == "auto":
        renderer = pick_renderer(scene)
    if renderer in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[renderer]} is not ported yet")
    if renderer != "queue":
        raise ValueError(f"unknown renderer {renderer!r}")
    if scene.bvh is None:
        from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

        scene = attach_bvh(scene, config)
    img = render_fused_queue_image(scene, cam, master_key_data(seed), config,
                                   spp_val, lanes).cpu().numpy()
    if out_path:
        write_png(out_path, img)
    return img
