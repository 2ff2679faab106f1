"""Shadow queries of the port's trace against the JAX package's Pallas
kernel in interpret mode: the target-material early kill, parked lanes,
the 2-plane occlusion query, and live-lane compaction.

Discrete outputs (material / kill / visibility) must be equal; t within
rtol 1e-5 (the JAX kernel's own tolerance between backends)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.ops.pallas_trace import fused_trace_planes as jtrace
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops import trace as ttrace
from tests.torch_port_util import (
    SHADOW_RAYS, planes, scene_pair, shadow_queries, trace_both)


def _kill_rays():
    """test_shadow_early_kill_target_material's rays: a clear column under
    the cornell light and a column beside the tall block."""
    n = 128
    under_light = np.tile([278.0, 100.0, 280.0], (n, 1))
    off_side = np.tile([400.0, 50.0, 400.0], (n, 1))
    orgs = np.concatenate([under_light, off_side]).astype(np.float32)
    # jitter the targets over the light's middle so lanes differ (the
    # clear column's rays stay in front of the tall block)
    rng = np.random.default_rng(31)
    target = np.stack([rng.uniform(272, 284, 2 * n),
                       np.full(2 * n, 548.8),
                       rng.uniform(272, 284, 2 * n)], 1)
    dirs = target - orgs
    dist = np.linalg.norm(dirs, axis=1)
    return orgs, (dirs / dist[:, None]).astype(np.float32), dist.astype(np.float32)


@pytest.mark.parametrize("walk", ["wide", "binary"])
def test_early_kill_and_park_match_pallas_kernel(walk):
    js, _ = scene_pair("cornell")
    light = float(np.asarray(js.light_mtl)[0])
    org, d, tb = _kill_rays()
    tg = np.full(len(tb), light, np.float32)
    j, t = trace_both("cornell", org, d, cfg=dict(bvh_walk=walk), t_bound=tb,
                      target_mtl=tg, return_tri=True)
    np.testing.assert_array_equal(t[6], j[6])
    np.testing.assert_array_equal(t[7], j[7])
    np.testing.assert_array_equal(t[8], j[8])
    assert (t[6][:128] == light).all()                 # clear column
    killed = t[6] == -3.0
    assert killed.any()
    np.testing.assert_array_equal(t[0][killed], -1.0)
    np.testing.assert_array_equal(t[8][killed], -1.0)
    np.testing.assert_allclose(t[0][~killed], j[0][~killed], rtol=1e-5,
                               atol=1e-6)
    if walk == "wide":
        # parked lanes: bound 0 -> no walk at all, a miss at t = 0
        j0, t0 = trace_both("cornell", org, d, t_bound=np.zeros_like(tb),
                            target_mtl=tg)
        assert (t0[6] == -1.0).all() and (j0[6] == -1.0).all()
        assert (t0[0] == 0.0).all()


@pytest.mark.parametrize("name", ["cornell", "grid", "grid32"])
def test_occlusion_query_matches_pallas_kernel(name):
    """query="occlusion": (bt, seen) equal to the JAX kernel's, and the
    visibility (seen & bt >= 0) equal to the closest-hit material test."""
    js, ts = scene_pair(name)
    rng = np.random.default_rng(32)
    org, d, tb, tg = shadow_queries(js, rng, 384, *SHADOW_RAYS[name])
    j, t = trace_both(name, org, d, t_bound=tb, target_mtl=tg,
                      query="occlusion")
    np.testing.assert_array_equal(t[1], j[1])            # seen
    np.testing.assert_array_equal(t[0] < 0, j[0] < 0)     # killed
    np.testing.assert_array_equal(t[0], j[0])
    vis = (t[1] > 0.5) & (t[0] >= 0.0)
    assert vis.any() and not vis.all()
    closest = ttrace.fused_trace_planes(
        ts, *map(torch.from_numpy, planes(org)),
        *map(torch.from_numpy, planes(d)), RenderConfig(),
        t_bound=torch.from_numpy(tb), target_mtl=torch.from_numpy(tg),
        attrs=False)
    np.testing.assert_array_equal(vis, closest[6].numpy() == tg)


@pytest.mark.parametrize("name", ["grid", "grid32"])
def test_shadow_compact_is_bitwise_uncompacted(name):
    """occlusion_trace_segmented with compaction on equals it off, bit for
    bit, over two light segments with parked lanes mixed in, and both
    equal the JAX kernel's visibility lane for lane."""
    js, ts = scene_pair(name)
    rng = np.random.default_rng(33)
    n = 256
    org, d, tb, tg = shadow_queries(js, rng, 2 * n, *SHADOW_RAYS[name])
    parked = rng.uniform(size=2 * n) < 0.4
    tb = np.where(parked, 0.0, tb).astype(np.float32)
    tg = np.where(parked, -2.0, tg).astype(np.float32)
    org = np.where(parked[:, None], 1e30, org).astype(np.float32)
    args = (*map(torch.from_numpy, planes(org)),
            *map(torch.from_numpy, planes(d)),
            torch.from_numpy(tb), torch.from_numpy(tg))
    on = ttrace.occlusion_trace_segmented(
        ts, *args, RenderConfig(shadow_compact="on"), 2)
    off = ttrace.occlusion_trace_segmented(
        ts, *args, RenderConfig(shadow_compact="off"), 2)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
    assert (on.numpy()[parked] == 0.0).all()
    jbt, jseen = jtrace(js, *map(jnp.asarray, planes(org)),
                        *map(jnp.asarray, planes(d)), JConfig(),
                        force_kernel=True, t_bound=jnp.asarray(tb),
                        target_mtl=jnp.asarray(tg), query="occlusion")
    jvis = ((np.asarray(jseen) > 0.5) & (np.asarray(jbt) >= 0)).astype(np.float32)
    np.testing.assert_array_equal(on.numpy(), jvis)
    assert 0 < jvis.sum() < (~parked).sum()
