"""Render configuration: the same fields, defaults and ray-type constants as
``tinyraytracing_tpu/config.py`` (whose docstrings give each field's
rationale and the reference file:line it mirrors).

Every field is accepted, so a config carries across unchanged. Every
``intersector`` value is served: the scan renderer dispatches on it
(``ops/intersect.py``; the fused renderers have their own trace kernels
and ignore it). The scan path's ``ray_chunk`` (part of its sample
stream), ``tri_chunk`` (the brute and mxu chunking) and ``bvh_early_out``
(the "bvh" walk's pruning) act as in the JAX package. The fused
renderers' trace:

- under ``walk_order="preorder"`` (the default) the per-ray walks'
  results do not depend on the TPU packet-kernel knobs ``ray_tile``,
  ``trace_super_rays`` and ``bvh_walk``, so they change nothing, and
  ``shadow_compact`` / ``queue_resort_every`` "auto" mean off (measured
  on the H100, PERF.md);
- under ``walk_order="near"`` a ray's children are ordered by its packet's
  summed direction, so ``bvh_walk`` (which walk, and so whether the order
  applies) and ``ray_tile`` (the packets) change a render within the tie
  band, and ``shadow_compact`` / ``queue_resort_every`` "auto" follow the
  JAX package's rules, so the packets are the JAX package's
  (``ops/trace.py``); ``trace_super_rays`` still changes nothing.

``detach_sampling`` only steers gradients, and ``accum_dtype`` is read
nowhere, as in the JAX package (which declares it and never reads it):
every value renders the float32 image.
"""

from __future__ import annotations

import dataclasses

# Ray types, mirroring the reference constants (RayTracingOnCPU/ray.h:5-8)
DIFFUSE = 0
SPECULAR = 1
TRANSMISSION = 2
INVALID = 3
# freshly generated camera rays (the reference's depth-0 shade() call)
CAMERA = 4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render configuration."""

    # sampling
    spp: int = 256
    max_depth: int = 16
    p_rr: float = 0.8
    # intersection
    t_min: float = 5e-4
    n_dot_d_min: float = 1e-5
    intersector: str = "auto"
    tri_chunk: int = 256
    tie_eps: float = 4e-6         # relative t band of the emissive tie-break
    ray_chunk: int = 65536
    bvh_early_out: bool = True
    # BVH build
    leaf_size: int = 8
    aabb_pad: float = 1e-3
    # estimator fidelity switches
    light_sampler: str = "ref"     # ref | uniform
    specular_weight: str = "ref"   # ref | ks
    shadow_test: str = "mtl"       # mtl | tmin
    # queue renderer
    queue_refill: str = "lane"     # lane | row
    queue_resort_every: int = -1   # 0 never, -1 auto (see above)
    queue_resort_key: str = "path"  # path | path_octant | morton
    morton_cells: int = 32
    # TPU packet-kernel knobs (they act only under walk_order="near")
    ray_tile: int = 0
    bvh_walk: str = "auto"         # auto | wide | binary
    shadow_compact: str = "auto"   # auto | on | off
    walk_order: str = "preorder"   # preorder | near
    trace_super_rays: int = 131072
    # differentiation (diff/: detach_sampling holds the sampled bounce
    # directions fixed; accum_dtype is read nowhere, as in the JAX package)
    detach_sampling: bool = True
    accum_dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
