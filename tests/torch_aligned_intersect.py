"""Run the JAX package's intersectors on the cases of
tests/test_torch_intersect.py with XLA's FMA contraction off, and save
the rays and the results:

    XLA_FLAGS=--xla_cpu_max_isa=AVX JAX_PLATFORMS=cpu \\
        python -m tests.torch_aligned_intersect OUT.npz

XLA's CPU backend contracts a*b+c into a fused multiply-add; PyTorch's
eager CPU ops and the port's CUDA kernels (built with --fmad=false) never
do. On the scan renderer's bounce and shadow rays, which start on a
surface, the last-ulp difference flips a few self-hits across t_min (13
of 3072 rays on cornell). ``--xla_cpu_max_isa=AVX`` (an ISA without FMA)
turns the contraction off; the flag must be set before XLA starts, hence
a process of its own. The port's side runs in the test process.
"""

from __future__ import annotations

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tinyraytracing_tpu.config import RenderConfig as JConfig  # noqa: E402
from tinyraytracing_tpu.ops import intersect as jisect  # noqa: E402
from tinyraytracing_tpu.ops.pallas_bvh import pallas_bvh_intersect_planes  # noqa: E402
from tinyraytracing_tpu.ops.pallas_intersect import pallas_intersect_planes  # noqa: E402
from tests.torch_port_util import scan_rays, scene_pair  # noqa: E402

# (scene, what): "bvh_pallas" / "pallas" the kernels in interpret mode,
# the others ``intersect`` with that backend ("bvh_noearly": "bvh" with
# bvh_early_out off), "mt" Moller-Trumbore against the first 32 triangles
CASES = ([(n, "bvh_pallas") for n in ("cornell", "grid2000", "grid2000_32")]
         + [(n, "pallas") for n in ("cornell", "grid600")]
         + [(n, b) for n in ("cornell", "grid2000") for b in ("brute", "mxu", "bvh")]
         + [("grid2000", "bvh_noearly"), ("cornell", "mt")])
SEED, SIDE = 7, 32


def rays(name):
    return scan_rays(scene_pair(name)[1], SIDE, seed=SEED)


def run(name, what, org, d):
    js = scene_pair(name)[0]
    planes = [jnp.asarray(np.ascontiguousarray(a[:, k]))
              for a in (org, d) for k in range(3)]
    if what == "bvh_pallas":
        return pallas_bvh_intersect_planes(js, *planes, JConfig())
    if what == "pallas":
        return pallas_intersect_planes(js, *planes, JConfig())
    if what == "mt":
        tri = [getattr(js, f)[:32] for f in ("v0", "v1", "v2", "gn")]
        return jisect.moller_trumbore(jnp.asarray(org[::4]), jnp.asarray(d[::4]),
                                      *tri, JConfig())
    cfg = (JConfig(intersector="bvh", bvh_early_out=False)
           if what == "bvh_noearly" else JConfig(intersector=what))
    h = jisect.intersect(js, jnp.asarray(org), jnp.asarray(d), cfg)
    return h.t, h.idx, h.u, h.v


def main(out):
    arrays = {}
    for name in dict.fromkeys(n for n, _ in CASES):
        arrays[f"{name}-org"], arrays[f"{name}-dir"] = rays(name)
    for name, what in CASES:
        res = run(name, what, arrays[f"{name}-org"], arrays[f"{name}-dir"])
        for k, x in enumerate(res):
            arrays[f"{name}-{what}-{k}"] = np.asarray(x)
    np.savez(out, **arrays)


if __name__ == "__main__":
    main(sys.argv[1])
