"""Render the cases of tests/test_torch_render.py with both packages, with
the arithmetic of the two aligned, and save the images:

    XLA_FLAGS=--xla_cpu_max_isa=AVX JAX_PLATFORMS=cpu \\
        python -m tests.torch_aligned_render OUT.npz [SCENE ...]

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
  it runs the kernel in interpret mode (``force_kernel=True``).
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
from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit  # noqa: E402
from tinyraytracing_tpu.models import procedural as jproc  # noqa: E402
from tinyraytracing_tpu.ops.bvh import attach_bvh  # noqa: E402
from tinyraytracing_tpu_torch.config import RenderConfig  # noqa: E402
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue  # noqa: E402
from tinyraytracing_tpu_torch.models.camera import Camera  # noqa: E402
from tinyraytracing_tpu_torch.ops import vec  # noqa: E402
from tinyraytracing_tpu_torch.ops.rng import master_key_data  # noqa: E402
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
}
CASES = ([(n, c) for n in ("cornell", "grid600")
          for c in ("default", "compact", "morton", "tmin")]
         + [("grid600", "row"), ("cornell", "octant")])


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


def main(out, names):
    """Render the cases of the scenes ``names`` (default: all) into OUT."""
    align()
    images = {}
    for name in names or dict.fromkeys(n for n, _ in CASES):
        js, jcam, ts, tcam = scenes(name)
        for case, cfg in CASES:
            if case != name:
                continue
            kw = CONFIGS[cfg]
            images[f"{name}-{cfg}-jax"] = np.asarray(render_fused_queue_jit(
                js, jcam, jax.random.PRNGKey(SEED), JConfig(**kw), SPP,
                lanes=LANES))
            img, rays = render_fused_queue(ts, tcam, master_key_data(SEED),
                                           RenderConfig(**kw), SPP, lanes=LANES)
            images[f"{name}-{cfg}-port"] = img.reshape(SIZE, SIZE, 3).numpy()
            images[f"{name}-{cfg}-rays"] = np.float32(rays)
    np.savez(out, **images)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
