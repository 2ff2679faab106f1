"""The central-difference slope of ``render_loss_fast`` in the eye, with
both packages, on ``tests/test_torch_diff.py::_fd_scene`` (the same
quads, camera and light built with each package), beside each package's
own gradient:

    JAX_PLATFORMS=cpu python -m tests.torch_eye_fd

Prints, for steps of 1.0, 0.1, 0.01 and 3.0 along x, y and z, each
package's finite difference, its gradient and the difference of the two.
Both read the same extra slope at steps of 0.1 and 0.01 (the float32
estimator's), which is why the port's eye FD check steps by
``EYE_EPS`` = 1.0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.diff import fast as jfast
from tinyraytracing_tpu.diff.inverse import SceneParams as JParams
from tinyraytracing_tpu.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.models.camera import Camera as JCamera
from tinyraytracing_tpu.models.scene import assemble_scene
from tinyraytracing_tpu.ops.bvh import attach_bvh
from tests.test_torch_diff import _fast_loss, _fd_scene, _grad
from tinyraytracing_tpu_torch.config import RenderConfig

SIZE = 24
STEPS = (1.0, 0.1, 0.01, 3.0)


def jax_fd_scene(size):
    """``_fd_scene`` built with the JAX package."""
    quads = [
        ([(-4000, 0, -4000), (-4000, 0, 4000), (4000, 0, 4000),
          (4000, 0, -4000)], "DiffuseWhite"),
        ([(200, 800, 100), (330, 800, 100), (330, 800, 230),
          (200, 800, 230)], "Light"),
    ]
    cfg = SceneConfig(width=size, height=size, fovy=40.0,
                      eye=(0.0, 800.0, -800.0), lookat=(0.0, 0.0, 0.0),
                      up=(0.0, 1.0, 0.0),
                      lights=[LightSpec("Light", (30.0, 25.0, 20.0))])
    scene = assemble_scene(cfg, jproc._quads_to_mesh(quads),
                           dict(jproc.CORNELL_MATERIALS))
    cam = JCamera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, size, size)
    return attach_bvh(scene, JConfig()), cam


def main():
    js, jcam = jax_fd_scene(SIZE)
    jcfg, key = JConfig(max_depth=1), jax.random.PRNGKey(7)
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    jloss = lambda e: jfast.render_loss_fast(JParams(eye=e), js, jcam, key,
                                             target, jcfg, 2)
    fj = jax.jit(jloss)
    e0 = jnp.asarray(jcam.eye)
    gj = np.asarray(jax.grad(jloss)(e0))
    ts, tcam = _fd_scene(SIZE)               # the port's, seed 7 as there
    ft, x0 = _fast_loss(ts, tcam, "eye", RenderConfig(max_depth=1))
    gt = _grad(ft, x0).numpy()
    print(f"loss: JAX {float(fj(e0)):.9g}, port {float(ft(x0)):.9g}")
    print(f"gradient: JAX {gj}, port {gt}")
    for eps in STEPS:
        for k, axis in enumerate("xyz"):
            v = np.zeros(3, np.float32)
            v[k] = 1.0
            fdj = (float(fj(e0 + eps * v)) - float(fj(e0 - eps * v))) / (2 * eps)
            with torch.no_grad():
                vt = torch.from_numpy(v)
                fdt = (float(ft(x0 + eps * vt)) - float(ft(x0 - eps * vt))) / (2 * eps)
            print(f"step {eps:5} {axis}: JAX fd {fdj: .4e} grad {gj[k]: .4e} "
                  f"fd - grad {fdj - gj[k]: .3e} | port fd {fdt: .4e} grad "
                  f"{gt[k]: .4e} fd - grad {fdt - gt[k]: .3e}")


if __name__ == "__main__":
    main()
