"""The port's closest-hit trace (tinyraytracing_tpu_torch.ops.trace, plain
PyTorch walk on the CPU) against the JAX package's Pallas kernel run in
interpret mode (``force_kernel=True``), on the same scene and rays.

Discrete outputs (hit/miss, material, emissive flag, triangle) must be
equal; floats within the tolerances the JAX package holds its own
backends to (tests/test_pallas_trace.py::_check_fused: t rtol 1e-5, shading
normal and texcoord 1e-4). Interpret mode is slow, so calls stay at
<= 512 rays. The JAX kernel has two walks ("wide", "binary"); the port's
single per-ray walk must match both. "grid" is quad_grid(6000) at leaf 8,
"grid32" the same scene at leaf 32, the width the JAX package's CLI picks
for scenes of 10K triangles or more (32-slot leaf blocks, slots 8-31 live).
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops import trace as ttrace
from tests.torch_port_util import (
    RAYS, max_leaf_slots, random_rays, scene_pair, trace_both)


def check_closest(j, t, attrs=True):
    """_check_fused's tolerances, plus exact discrete outputs."""
    hit = j[6] >= 0
    np.testing.assert_array_equal(t[6] >= 0, hit)            # hit set
    np.testing.assert_array_equal(t[6], j[6])                # material
    np.testing.assert_array_equal(t[7], j[7])                # emissive
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-6)
    if attrs:
        for k in range(1, 6):
            np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=1e-4,
                                       atol=1e-4)
    else:   # attrs=False: the attribute planes keep their initial values
        for k, init in ((1, 0.0), (2, 0.0), (3, 1.0), (4, 0.0), (5, 0.0)):
            assert (t[k] == init).all() and (j[k] == init).all()
    if len(j) == 9:
        np.testing.assert_array_equal(t[8], j[8])            # triangle
    return hit


@pytest.mark.parametrize("walk", ["wide", "binary"])
@pytest.mark.parametrize("name", ["cornell", "grid", "grid32"])
def test_closest_hit_matches_pallas_kernel(name, walk):
    rng = np.random.default_rng(21)
    org, d = random_rays(rng, 512, *RAYS[name])
    j, t = trace_both(name, org, d, cfg=dict(bvh_walk=walk), return_tri=True)
    hit = check_closest(j, t)
    assert 0.3 < hit.mean() < 1.0
    assert (t[8][hit] >= 0).all() and (t[8][~hit] == -1).all()
    if name == "grid32":        # 32-slot leaf blocks with slots 8-31 live
        assert max_leaf_slots(scene_pair(name)[1]) == 32


@pytest.mark.parametrize("name", ["cornell", "grid", "grid32"])
def test_closest_hit_without_attrs_matches_pallas_kernel(name):
    rng = np.random.default_rng(22)
    org, d = random_rays(rng, 384, *RAYS[name])
    tb = rng.uniform(100.0, 1200.0, 384).astype(np.float32)
    j, t = trace_both(name, org, d, attrs=False, t_bound=tb)
    hit = check_closest(j, t, attrs=False)
    assert hit.any() and not hit.all()
    # a bounded miss reports its bound
    np.testing.assert_array_equal(t[0][~hit], tb[~hit])


def test_root_leaf_scene_matches_pallas_kernel():
    rng = np.random.default_rng(23)
    js, ts = scene_pair("root_leaf")
    assert ts.bvh.packed.n_wide == 1 and ts.bvh.n_nodes == 1
    n = 256
    org = rng.uniform(-1, 1, (n, 3)) * 150.0 + (278.0, 250.0, 280.0)
    floor = rng.uniform(0, 1, (n, 3)) * (552.0, 0.0, 559.0)
    light = rng.uniform(0, 1, (n, 3)) * (130.0, 0.0, 105.0) + (213, 548.8, 227)
    to = np.where(np.arange(n)[:, None] % 2 == 0, floor, light) - org
    d = to / np.linalg.norm(to, axis=1, keepdims=True)
    j, t = trace_both("root_leaf", org.astype(np.float32),
                      d.astype(np.float32), return_tri=True)
    hit = check_closest(j, t)
    assert hit.mean() > 0.9 and (t[7][hit] > 0.5).any()


def test_walk_order_near_is_not_ported():
    """walk_order="near" (not ported in the first slices) is served now:
    on cornell, whose closest hits the JAX kernel walks on the binary tree
    under bvh_walk="auto", the port walks preorder — bitwise the preorder
    render — and matches the JAX kernel under the same config."""
    rng = np.random.default_rng(25)
    org, d = random_rays(rng, 256, *RAYS["cornell"])
    j, t = trace_both("cornell", org, d, cfg=dict(walk_order="near"),
                      return_tri=True)
    check_closest(j, t)
    _, pre = trace_both("cornell", org, d, cfg={}, return_tri=True)
    for a, b in zip(t, pre):
        np.testing.assert_array_equal(a, b)


def test_plain_walk_counts_what_the_kernel_reads():
    """The stats behind the kernels' bounds: each record of
    ``Scene.trace_records`` counted once, only where the walk reads it —
    the occupied children of the wide nodes it expands, the slots it tests,
    a shading record only where a slot replaces with attributes, else the
    material where a slot may replace or kill, the slot id of each best
    record — equal to what an emulation of the kernel's walk reads
    (``tests/torch_trace_emulate.py``, one leaf at a time), in both walk
    orders, with the near-first occlusion walk counted on its own."""
    from tests.torch_trace_emulate import emulate

    _, ts = scene_pair("grid")
    pk, rec = ts.bvh.packed, ts.trace_records
    rng = np.random.default_rng(24)
    org, d = random_rays(rng, 256, *RAYS["grid"])
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k], np.float32))
              for a in (org, d) for k in range(3)]
    rays = torch.stack([*planes, torch.full((256,), 3.0e38),
                        torch.full((256,), -2.0)]).contiguous()
    got = {}
    for order in ("preorder", "near"):
        cfg = RenderConfig(walk_order=order, bvh_walk="wide", ray_tile=128)
        for attrs, occl in ((True, False), (False, False), (False, True)):
            tile, md = ttrace.walk_packets(pk, rays, cfg, occl)
            stats, reads = {}, {}
            ttrace.trace_plain(pk, rays, cfg, attrs=attrs, occl=occl,
                               tile=tile, md=md, stats=stats)
            emulate(rec, rays, cfg, attrs=attrs, occl=occl, tile=tile, md=md,
                    warp=1, reads=reads)
            assert stats["scene_bytes"] == reads["bytes"], (order, attrs, occl)
            assert stats["slot_tests"] == reads["slot_tests"]
            got[order, attrs, occl] = stats
    full, bare, occlusion = (got["preorder", a, o] for a, o in (
        (True, False), (False, False), (False, True)))
    assert full["node_visits"] == bare["node_visits"] > 256
    assert full["slot_tests"] == bare["slot_tests"] > 256
    assert occlusion == bare              # no target: the same walk and reads
    assert 0 < bare["scene_bytes"] < full["scene_bytes"]
    records = rec.node.nbytes + rec.slot.nbytes + rec.shade.nbytes
    assert full["scene_bytes"] < records / 2
    near = got["near", False, True]       # the near occlusion walk's own
    assert near["near_sorts"] > 0 and 0 < near["scene_bytes"] <= records
