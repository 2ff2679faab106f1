"""The CUDA kernels (csrc/trace.cu in both walk orders, csrc/bvh_intersect.cu,
csrc/slot_intersect.cu) against their plain PyTorch versions on the same
CUDA tensors, at small size, and the fast differentiable path on them.
They need a CUDA device and nvcc, so they skip elsewhere; on the GPU
machine run

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest``: tests/conftest.py imports jax, which that machine lacks.)

Both sides compute the same float32 operations in the same order without
FMA contraction (the kernel is built with --fmad=false), so every output
plane must be bitwise equal.
"""

import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
from tinyraytracing_tpu_torch.ops import bvh_intersect, intersect, slot_intersect, trace
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.utils import spans
# by its own name: the card's machine may have another package named tests
from torch_slot_emulate import (
    extreme_payload, tie_rays, tie_scene, tie_shadow_rays,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(name, device):
    if name == "cornell":
        scene, _ = cornell_box(32, 32, device="cpu")
        scene = attach_bvh(scene, RenderConfig(leaf_size=8))
    else:
        scene, _ = quad_grid(6000, device="cpu")         # leaf 8
        if name == "grid32":   # the JAX CLI's leaf width for big scenes
            scene = attach_bvh(scene, RenderConfig(leaf_size=32))
    return scene.to(device)


def _rays(n, device, shadow_scene=None):
    g = torch.Generator().manual_seed(5)
    org = torch.rand(n, 3, generator=g) * 500.0 + 30.0
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    tb = torch.full((n,), 3.0e38)
    tg = torch.full((n,), -2.0)
    if shadow_scene is not None:           # toward light 0, bounded, parked
        lp = shadow_scene.lt_v0[0, 0].cpu() * 0.4 + shadow_scene.lt_v1[0, 0].cpu() * 0.3 \
            + shadow_scene.lt_v2[0, 0].cpu() * 0.3
        to = lp - org
        tb = to.norm(dim=1)
        d = to / tb[:, None]
        tb[::3] = 0.0
        tg = torch.where(tb > 0, float(shadow_scene.light_mtl[0]), -2.0)
    return torch.cat([org.T, d.T, tb[None], tg[None]]).float().contiguous().to(device)


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", ["cornell", "grid", "grid32"])
def test_kernels_bitwise_equal_plain(name, shadow, device):
    """Both walk orders; the near-first walk in packets of 512 rays, each
    with its packet's direction sum, the same tensor for both sides; and
    the preorder walk at t_min 0, where the kernel holds one leaf at a
    time."""
    scene = _scene(name, device)
    pk = scene.bvh.packed
    rays = _rays(4096, device, scene if shadow else None)
    near = RenderConfig(walk_order="near", bvh_walk="wide", ray_tile=512)
    for cfg in (RenderConfig(), near, RenderConfig(t_min=0.0)):
        for occl, attrs in ((False, True), (False, False), (True, False)):
            tile, md = trace.walk_packets(pk, rays, cfg, occl)
            assert (md is not None) == (cfg is near)
            k = trace.trace_kernel(scene.trace_records, rays, cfg, attrs=attrs,
                                   occl=occl, tile=tile, md=md)
            p = trace.trace_plain(pk, rays, cfg, attrs=attrs, occl=occl,
                                  tile=tile, md=md)
            torch.cuda.synchronize()
            assert torch.equal(k, p), (cfg.walk_order, occl, attrs,
                                       (k != p).sum(dim=1).tolist())


def test_packet_dirs_kernel_bitwise_equal_plain(device):
    """The near-first walk's packet direction sums: the kernel adds in the
    plain version's (XLA's) order, so the sums are bitwise equal, at every
    packet size from 128 to 32768 rays (one band of rows up to 4096; 2, 3,
    4 and 8 bands above), with a padded last packet."""
    R = 2 * 32768 + 300
    rays = _rays(R, device)
    for tile in (128, 384, 1024, 2048, 4096, 8192, 12288, 16384, 32768):
        k = trace.packet_dirs_kernel(rays, tile)
        p = trace.packet_dirs_plain(rays, tile)
        torch.cuda.synchronize()
        assert k.shape == (-(-R // tile), 3) and torch.equal(k, p), tile


def test_wrapper_launches_kernel_on_cuda(device):
    scene = _scene("cornell", device)
    x = torch.zeros(256, device=device)
    with spans.recording() as rec:
        trace.fused_trace_planes(scene, x + 278, x + 273, x - 500, x, x, x + 1,
                                 RenderConfig())
        trace.fused_trace_planes(scene, x + 278, x + 273, x - 500, x, x, x + 1,
                                 RenderConfig(), t_bound=x + 900,
                                 target_mtl=x, query="occlusion")
    assert rec.counts == {"launches.trace_closest": 1, "launches.trace_occlusion": 1}
    # near on cornell: closest hit walks binary (preorder), occlusion wide
    near = RenderConfig(walk_order="near")
    with spans.recording() as rec:
        trace.fused_trace_planes(scene, x + 278, x + 273, x - 500, x, x, x + 1,
                                 near)
        trace.fused_trace_planes(scene, x + 278, x + 273, x - 500, x, x, x + 1,
                                 near, t_bound=x + 900, target_mtl=x,
                                 query="occlusion")
    assert rec.counts == {"launches.trace_closest": 1, "launches.trace_near": 1,
                          "launches.packet_dirs": 1}


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("name", ["cornell", "grid", "grid32", "ties"])
def test_intersect_kernels_bitwise_equal_plain(name, shadow, device):
    """The packet-BVH and slot kernels against their plain versions, on
    4,173 rays (not a multiple of the slot kernel's rays per block); the
    slot kernel also on the payload with w rows off its fast reciprocal's
    range (the slow path; tests/torch_slot_emulate.py
    ``extreme_payload``). "grid" is the 6,000-triangle quad grid (188
    chunks); "ties" the scene of tests/torch_slot_emulate.py (no BVH),
    whose rays aim at its tied layers (the shadow rays at its light's
    triangles)."""
    R = 4096 + 77
    if name == "ties":
        scene, _ = tie_scene(device=device)
        rays = (tie_shadow_rays(scene, R, device=device) if shadow else
                tie_rays(per_region=-(-R // 9), device=device)[:, :R])
    else:
        scene = _scene(name, device)
        rays = _rays(R, device, scene if shadow else None)[:6]
    rays = rays.contiguous()
    assert rays.shape == (6, R)
    cfg = RenderConfig()
    if scene.bvh is not None:
        k = bvh_intersect.bvh_intersect_kernel(scene.bvh_records, rays, cfg)
        p = bvh_intersect.bvh_intersect_plain(scene.bvh.packed, rays, cfg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    P, T = scene.slot_payload[0], scene.num_triangles
    hits = slot_intersect.slot_intersect_plain(P, T, rays, cfg)[0] < 3.0e38
    assert bool(hits.any())
    for P in (P, extreme_payload(P)):
        k = slot_intersect.slot_intersect_kernel(P, T, rays, cfg)
        p = slot_intersect.slot_intersect_plain(P, T, rays, cfg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.parametrize("leaf_size", [1, 4, 8, 32])
def test_bvh_kernel_bitwise_equal_plain_leaf_sizes(leaf_size, device):
    """The packet-BVH kernel (which tests only the occupied slots of the
    scene's bvh_records) against its plain version (every slot of the JAX
    layout) at every leaf width, with partly filled leaves, on random
    rays, shadow rays toward the light and parked rays (origin at 1e30):
    every plane bitwise equal."""
    scene, _ = quad_grid(2000, device="cpu")
    scene = attach_bvh(scene, RenderConfig(leaf_size=leaf_size)).to(device)
    pk = scene.bvh.packed
    counts = pk.node_meta[:, 1][pk.node_meta[:, 1] >= 0] & 63
    assert int(counts.max()) <= leaf_size
    if leaf_size > 1:
        assert int(counts.min()) < leaf_size          # partly filled leaves
    rays = _rays(4096, device)[:6]
    shadow = _rays(4096, device, scene)[:6]
    parked = rays.clone()
    parked[:3, ::2] = 1.0e30
    cfg = RenderConfig()
    for label, r in (("random", rays), ("shadow", shadow), ("parked", parked)):
        r = r.contiguous()
        k = bvh_intersect.bvh_intersect_kernel(scene.bvh_records, r, cfg)
        p = bvh_intersect.bvh_intersect_plain(pk, r, cfg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p)), label
        assert bool((k[0] < 3.0e38).any()), label


def test_auto_intersect_launches_kernels_on_cuda(device):
    """"auto" on CUDA: the packet-BVH kernel with a BVH, the slot kernel
    without; counted once per launch."""
    import dataclasses

    scene = _scene("cornell", device)
    o = torch.tensor([[278.0, 273.0, -500.0]], device=device).expand(256, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(256, 3)
    with spans.recording() as rec:
        a = intersect.intersect(scene, o, d, RenderConfig())
        b = intersect.intersect(dataclasses.replace(scene, bvh=None), o, d,
                                RenderConfig())
    assert rec.counts == {"launches.bvh_intersect": 1, "launches.slot_intersect": 1}
    assert torch.equal(a.t, b.t) and torch.equal(a.idx, b.idx)


def test_fused_trace_diff_on_the_card(device):
    """``render_loss_fast`` on the card: the forward and the backward's
    recompute launch the trace kernel (never the plain walk), and the
    gradients match the CPU's within 1e-2 of their norm (the tolerance
    of chip_smoke.py's phase 6)."""
    from tinyraytracing_tpu_torch.diff import SceneParams, render_loss_fast
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    scene, cam = cornell_box(16, 16, device="cpu")
    scene = attach_bvh(scene, RenderConfig())
    grads = {}
    for dev in ("cpu", device):
        s = scene.to(dev)
        p = SceneParams.init_from(s, cam, "kd", "vertex_offset")
        for t in p.tensors():
            t.requires_grad_(True)
        with spans.recording() as rec:
            loss = render_loss_fast(p, s, cam, master_key_data(1),
                                    torch.zeros(16, 16, 3, device=dev),
                                    RenderConfig(max_depth=3), 2)
        fwd = rec.counts.get("launches.trace_closest", 0)
        with spans.recording() as rec:
            loss.backward()
        bwd = rec.counts.get("launches.trace_closest", 0)
        assert (fwd > 0 and bwd > 0) == (dev == device)
        grads[str(dev)] = [t.grad.cpu() for t in p.tensors()]
    for a, b in zip(grads[str(device)], grads["cpu"]):
        assert float((a - b).norm()) <= 1e-2 * float(b.norm())
