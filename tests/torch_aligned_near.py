"""Run the JAX package's trace kernel under the near-first walk (Pallas
interpret mode) on the cases of tests/test_torch_near.py with XLA's FMA
contraction off, and save the rays and the results:

    XLA_FLAGS=--xla_cpu_max_isa=AVX JAX_PLATFORMS=cpu \\
        python -m tests.torch_aligned_near OUT.npz SCENE

Half the rays start on a surface (the scan renderer's bounce and shadow
rays, and shadow queries): there XLA's contraction of a*b+c into a fused
multiply-add, which PyTorch and the port's --fmad=false kernel never do,
flips a few self-hits across t_min. ``--xla_cpu_max_isa=AVX`` (an ISA
without FMA) turns it off; the flag must be set before XLA starts, hence
a process of its own. The port's side runs in the test process.
"""

from __future__ import annotations

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tinyraytracing_tpu.config import RenderConfig as JConfig  # noqa: E402
from tinyraytracing_tpu.ops.pallas_trace import fused_trace_planes  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    RAYS, SHADOW_RAYS, planes, random_rays, scan_rays, scene_pair,
    shadow_queries)

# several packets per call, each with its own key
NEAR = dict(walk_order="near", bvh_walk="wide", ray_tile=128)
QUERIES = ("closest", "closest_bounded", "occlusion")


def rays(name, query):
    """The case's float32 numpy rays: (org, dir, t_bound, target_mtl).
    "closest": 128 random rays and the scan renderer's camera, bounce and
    shadow rays (64 of each), unbounded; otherwise 320 shadow queries
    toward light 0, bounded at the light, with every fourth lane parked
    (bound 0) for "closest_bounded"."""
    js, ts = scene_pair(name)
    if query == "closest":
        rng = np.random.default_rng(41)
        org, d = random_rays(rng, 128, *RAYS[name])
        so, sd = scan_rays(ts, n_side=8, seed=41)
        org, d = np.concatenate([org, so]), np.concatenate([d, sd])
        return (org, d, np.full(len(org), 3.0e38, np.float32),
                np.full(len(org), -2.0, np.float32))
    rng = np.random.default_rng(42)
    org, d, tb, tg = shadow_queries(js, rng, 320, *SHADOW_RAYS[name])
    if query == "closest_bounded":
        tb[::4] = 0.0
    return org, d, tb, tg


def run(name, query, org, d, tb, tg):
    js, _ = scene_pair(name)
    p = [jnp.asarray(x) for x in (*planes(org), *planes(d))]
    kw = dict(t_bound=jnp.asarray(tb), target_mtl=jnp.asarray(tg))
    if query == "closest":
        kw["return_tri"] = True
    elif query == "closest_bounded":
        kw["attrs"] = False
    else:
        kw["query"] = "occlusion"
    return fused_trace_planes(js, *p, JConfig(**NEAR), force_kernel=True, **kw)


def main(out, name):
    arrays = {}
    for query in QUERIES:
        case = rays(name, query)
        for k, x in zip(("org", "dir", "tb", "tg"), case):
            arrays[f"{query}-{k}"] = x
        for k, x in enumerate(run(name, query, *case)):
            arrays[f"{query}-{k}"] = np.asarray(x)
    np.savez(out, **arrays)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
