"""The port's fused renderers against the JAX package's on the CPU — the
queue-fed ``render_fused_queue_jit`` (also under the near-first walk) and
the pixel-persistent ``render_fused_jit`` — with the same scene arrays,
seed (hence the same threefry sample streams), lanes and config.

As each package runs by default the renders cannot be bitwise equal: XLA
contracts a*b+c into FMAs, the JAX CPU trace is Moller-Trumbore rather
than the kernel's Woop walk, and XLA's transcendentals differ from
PyTorch's in the last ulp. Each of the three alone flips a few
grazing-angle shadow and bounce decisions. tests/torch_aligned_render.py
renders the cases with all three aligned, in a process of its own (the
FMA switch is an XLA start-up flag); the renders must then agree to the
float rounding of the pixel sums: >= 99% of pixels within rtol 1e-4 /
atol 1e-5, and image means within 1e-4 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch import cli
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.render import render_image
from tests.torch_aligned_render import CASES, SIZE, SPP, run_processes, scenes

_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = scenes(name)
    return _PAIRS[name]


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """Both packages' images of every case, rendered with the arithmetic
    aligned (tests/torch_aligned_render.py), one process per scene, the
    processes side by side."""
    return run_processes(str(tmp_path_factory.mktemp("aligned")),
                         list(dict.fromkeys(n for n, _ in CASES)))


@pytest.mark.parametrize("name,cfg", CASES)
def test_queue_render_matches_jax(name, cfg, aligned):
    want = aligned[f"{name}-{cfg}-jax"]
    got = aligned[f"{name}-{cfg}-port"]
    assert np.isfinite(got).all() and (got >= 0).all()
    assert float(aligned[f"{name}-{cfg}-rays"]) >= SIZE * SIZE * SPP
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()
    # aligned, every pixel agrees to the rounding of its sums (~1e-7)
    assert np.abs(got - want).max() <= 1e-6


def test_queue_render_is_deterministic_and_seeded():
    _, _, ts, tcam = _pair("cornell")
    cfg = RenderConfig(max_depth=4)
    a = render_fused_queue(ts, tcam, master_key_data(1), cfg, 2, lanes=256)[0]
    b = render_fused_queue(ts, tcam, master_key_data(1), cfg, 2, lanes=256)[0]
    c = render_fused_queue(ts, tcam, master_key_data(7), cfg, 2, lanes=256)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    # render_image: the same stream, as an (H, W, 3) host image
    img = render_image(ts, tcam, cfg, spp=2, seed=1, renderer="queue",
                       lanes=256)
    np.testing.assert_array_equal(img, a.reshape(16, 16, 3).numpy())


def test_max_iters_cap_drops_unfinished_paths():
    _, _, ts, tcam = _pair("cornell")
    cfg = RenderConfig(max_depth=6)
    key = master_key_data(3)
    full, rays_full = render_fused_queue(ts, tcam, key, cfg, 2, lanes=128,
                                         max_iters=10_000)
    capped, rays_capped = render_fused_queue(ts, tcam, key, cfg, 2,
                                             lanes=128, max_iters=2)
    assert torch.isfinite(capped).all() and (capped >= 0).all()
    assert float(rays_capped) < float(rays_full)
    assert float(capped.sum()) <= float(full.sum()) + 1e-4


def test_cli_renders_png(tmp_path):
    from PIL import Image

    out = tmp_path / "grid.png"
    rc = cli.main(["--scene", "grid:600", "--width", "16", "--height", "16",
                   "--spp", "2", "--lanes", "512", "--out", str(out),
                   "--no-compile-cache", "--device", "cpu"])
    assert rc == 0
    with Image.open(out) as im:
        assert im.size == (16, 16)
        assert np.asarray(im).mean() > 0


def test_unported_renderers_raise(tmp_path):
    """Every renderer is served now (the persistent one and checkpointed
    queue renders raised in the first slices): "auto" on cornell is the
    persistent renderer, a queue render with a checkpoint path renders
    chunked and removes its snapshot, and the scan renderer renders the
    same small scene."""
    scene, cam = cornell_box(8, 8, device="cpu")
    cam = dataclasses.replace(cam, width=8, height=8)
    cfg = RenderConfig(max_depth=3)
    pers = render_image(scene, cam, cfg, spp=1, renderer="persistent")
    auto = render_image(scene, cam, cfg, spp=1)
    np.testing.assert_array_equal(auto, pers)
    ckpt = tmp_path / "queue.npz"
    queue = render_image(scene, cam, cfg, spp=1, renderer="queue",
                         checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(
        queue, render_image(scene, cam, cfg, spp=1, renderer="queue"))
    assert not ckpt.exists()
    scan = render_image(scene, cam, cfg, spp=1, renderer="scan")
    for img in (pers, queue, scan):
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
        assert img.mean() > 0


# the intersector values, walk_order="near" and accum_dtype were unported
# in the first slices; they are served now (the scan renderer dispatches on
# the intersector, the queue ignores it; near orders the trace's walk;
# accum_dtype is read nowhere, as in the JAX package, so it renders the
# float32 image bitwise)
@pytest.mark.parametrize("field,value", [
    ("walk_order", "near"), ("intersector", "brute"),
    ("intersector", "bvh_pallas"), ("accum_dtype", "bfloat16")])
def test_unported_config_raises(field, value):
    _, _, ts, tcam = _pair("cornell")
    cfg = RenderConfig(**{field: value})
    if field == "accum_dtype":
        base = RenderConfig()
        np.testing.assert_array_equal(
            render_image(ts, tcam, cfg, spp=1, renderer="queue", lanes=128),
            render_image(ts, tcam, base, spp=1, renderer="queue", lanes=128))
        key = master_key_data(0)
        assert torch.equal(
            render_fused_queue(ts, tcam, key, cfg, 1, lanes=128)[0],
            render_fused_queue(ts, tcam, key, base, 1, lanes=128)[0])
        return
    cfg = cfg.replace(max_depth=3)
    key = master_key_data(0)
    base = RenderConfig(max_depth=3)
    got = render_fused_queue(ts, tcam, key, cfg, 1, lanes=128)[0]
    want = render_fused_queue(ts, tcam, key, base, 1, lanes=128)[0]
    if field == "walk_order":
        # the order may move a lane only inside the tie band: here none
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-5).all(dim=-1)
        assert close.float().mean() >= 0.99
    else:
        assert torch.equal(got, want)
    img = render_image(ts, tcam, cfg, spp=1, renderer="scan")
    assert np.isfinite(img).all() and img.mean() > 0


def test_layout_knobs_do_not_change_the_render():
    """The TPU layout and scan-renderer knobs are accepted and change
    nothing (config.py); intersector="bvh" is the queue's own."""
    _, _, ts, tcam = _pair("cornell")
    key = master_key_data(2)
    base = render_fused_queue(ts, tcam, key, RenderConfig(max_depth=3), 1,
                              lanes=256)[0]
    knobs = RenderConfig(max_depth=3, ray_tile=256, bvh_walk="binary",
                         trace_super_rays=1024, tri_chunk=32, ray_chunk=64,
                         bvh_early_out=False, detach_sampling=False,
                         intersector="bvh")
    assert torch.equal(render_fused_queue(ts, tcam, key, knobs, 1,
                                          lanes=256)[0], base)
