"""tinyraytracing_tpu_torch — the PyTorch / CUDA port of tinyraytracing_tpu.

The JAX package ``tinyraytracing_tpu`` stays the reference; this package
mirrors its module names so each module's counterpart is easy to find:

- ``io/``         host-side parsers (XML scene / OBJ / MTL / textures), PNG out
- ``models/``     Scene dataclass of tensors, camera, procedural scenes
- ``ops/``        threefry RNG, planar vector math, SAH BVH build, and the
                  trace op with its hand-written Hopper kernels (``csrc/``)
- ``native/``     the C++ SAH builder and OBJ parser (g++ at first use)
- ``integrator/`` the queue-fed fused wavefront and its shading helpers
- ``diff/``       gradients: BVH refit, scene parameters, the fast path
- ``render.py``   ``render_image``; ``cli.py`` the command line

Importing this package never imports jax.
"""

__version__ = "0.1.0"
