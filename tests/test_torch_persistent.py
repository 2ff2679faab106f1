"""The port's persistent renderer (``integrator/fused.py::render_fused``)
held against itself and against the port's queue renderer on the CPU.
Its agreement with the JAX package's ``render_fused_jit`` is
tests/test_torch_render.py's (the "persistent" cases).

Every draw is path-indexed and a lane writes only its own pixel, so the
image must be bitwise independent of how the slots are split and of the
lane count, and bitwise repeatable."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from tinyraytracing_tpu_torch import cli
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator.fused import (
    pixel_tile_order, render_fused, render_fused_image, render_fused_stats,
)
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.render import render_image

CFG = RenderConfig(max_depth=6)


@pytest.fixture(scope="module")
def cornell():
    scene, cam = cornell_box(16, 16, device="cpu")
    return attach_bvh(scene, CFG), cam


def test_slot_ranges_are_bitwise_the_whole_render(cornell):
    scene, cam = cornell
    key = master_key_data(4)
    whole, rays = render_fused(scene, cam, key, CFG, 2, lanes=128)
    parts = [render_fused(scene, cam, key, CFG, 2, lanes=128, slot_base=b,
                          n_slots=n) for b, n in ((0, 100), (100, 156))]
    got = torch.cat([parts[0][0][:100], parts[1][0][:156]])
    assert torch.equal(got, whole[:256])
    assert float(parts[0][1] + parts[1][1]) == float(rays)


def test_lanes_and_repeat_are_bitwise(cornell):
    scene, cam = cornell
    key = master_key_data(4)
    a, ra = render_fused_stats(scene, cam, key, CFG, 2, lanes=128)
    b, rb = render_fused_stats(scene, cam, key, CFG, 2, lanes=256)
    c, _ = render_fused_stats(scene, cam, key, CFG, 2, lanes=256)
    d, _ = render_fused_stats(scene, cam, master_key_data(5), CFG, 2,
                              lanes=256)
    assert torch.equal(a, b) and torch.equal(b, c) and not torch.equal(c, d)
    assert float(ra) == float(rb) >= 16 * 16 * 2
    # slot order -> pixel order is one gather by the inverse tile order
    slots, _ = render_fused(scene, cam, key, CFG, 2, lanes=256)
    order, _ = pixel_tile_order(16, 16)
    assert torch.equal(a.reshape(-1, 3)[torch.as_tensor(order, dtype=torch.int64)],
                       slots)


def test_queue_matches_persistent(cornell):
    """Both schedulers draw the same per-path randomness, so their images
    agree sample for sample up to the float-add order of the pixel sums:
    test_fused_queue_matches_fused_persistent's bounds."""
    scene, cam = cornell
    key = master_key_data(4)
    a = render_fused_image(scene, cam, key, CFG, 8, lanes=256).numpy()
    b = render_fused_queue(scene, cam, key, CFG, 8, lanes=256)[0]
    b = b.reshape(16, 16, 3).numpy()
    close = np.isclose(a, b, rtol=2e-4, atol=2e-5)
    assert close.mean() > 0.97, f"{(~close).sum()} of {close.size} differ"
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-6)


def test_render_image_auto_and_cli_render_cornell(tmp_path):
    """"auto" picks the persistent renderer under 512 triangles, attaching
    a BVH to a scene built without one; the CLI renders cornell by
    default."""
    scene, cam = cornell_box(8, 8, device="cpu")
    assert scene.bvh is None
    img = render_image(scene, cam, CFG, spp=2, seed=3, renderer="auto")
    want = render_fused_image(attach_bvh(scene, CFG), cam, master_key_data(3),
                              CFG, 2)
    np.testing.assert_array_equal(img, want.numpy())
    out = tmp_path / "cornell.png"
    rc = cli.main(["--scene", "cornell", "--width", "16", "--height", "16",
                   "--spp", "2", "--max-depth", "4", "--out", str(out),
                   "--device", "cpu"])
    assert rc == 0
    with Image.open(out) as im:
        assert im.size == (16, 16) and np.asarray(im).mean() > 0


def test_near_walk_in_the_merged_dispatch():
    """Under walk_order="near" the merged [bounce | shadow] dispatch walks
    near-first in packets that straddle the bounce/shadow boundary (R not
    a multiple of the packet); the image agrees with the preorder render
    (the order moves a lane only inside the tie band)."""
    scene, cam = quad_grid(600, 16, 16, device="cpu")
    cam = dataclasses.replace(cam, width=12, height=12)     # R = 256
    key = master_key_data(6)
    near = CFG.replace(walk_order="near", bvh_walk="wide", ray_tile=384)
    a = render_fused_image(scene, cam, key, near, 2, lanes=256)
    b = render_fused_image(scene, cam, key, CFG, 2, lanes=256)
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)
    assert close.float().mean() >= 0.99 and torch.isfinite(a).all()
