"""The port's chunked queue driver and checkpoints
(``render_fused_queue_chunked``, ``utils/checkpoint.py``) on the CPU,
after the JAX package's test_fused_queue_chunked_bitwise_and_resume and
tests/test_utils.py: chunked, interrupted-and-resumed and uninterrupted
renders bitwise equal; a snapshot is removed when the render ends; a
snapshot that does not match the render — another seed, or one written by
the JAX package — starts the render afresh."""

import os

import jax
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.integrator.fused_queue import (
    render_fused_queue_chunked as jax_chunked,
)
from tinyraytracing_tpu_torch import cli
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator.fused_queue import (
    render_fused_queue, render_fused_queue_chunked,
)
from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.utils.checkpoint import render_checkpointed
from tests.torch_aligned_render import scenes

CFG = RenderConfig(max_depth=4)


class Interrupted(Exception):
    pass


def _stop_after(n, seen):
    """A progress callback that records each chunk's iteration count and
    interrupts the render after ``n`` chunks."""
    def progress(it, counter, seconds):
        seen.append(it)
        if len(seen) == n:
            raise Interrupted
    return progress


@pytest.fixture(scope="module")
def grid():
    return quad_grid(600, 16, 16, device="cpu")


def test_chunked_is_bitwise_one_shot(grid):
    scene, cam = grid
    key = master_key_data(2)
    one, rays = render_fused_queue(scene, cam, key, CFG, 4, lanes=256)
    seen = []
    got, rays2 = render_fused_queue_chunked(
        scene, cam, key, CFG, 4, lanes=256, target_chunk_s=1e-9,
        progress=lambda it, counter, seconds: seen.append(it))
    assert torch.equal(got, one) and float(rays2) == float(rays)
    assert len(seen) > 3                # tiny target: many small chunks


def test_resume_is_bitwise_and_clears_the_snapshot(grid, tmp_path):
    scene, cam = grid
    key = master_key_data(2)
    one, _ = render_fused_queue(scene, cam, key, CFG, 4, lanes=256)
    path = str(tmp_path / "queue.npz")
    kw = dict(lanes=256, target_chunk_s=1e-9, checkpoint_path=path,
              checkpoint_every_s=0.0)
    seen = []
    with pytest.raises(Interrupted):
        render_fused_queue_chunked(scene, cam, key, CFG, 4,
                                   progress=_stop_after(3, seen), **kw)
    assert os.path.exists(path)          # snapshots of chunks 1 and 2
    resumed = []
    got, _ = render_fused_queue_chunked(
        scene, cam, key, CFG, 4, resume=True,
        progress=lambda it, counter, seconds: resumed.append(it), **kw)
    assert resumed[0] > seen[1]          # went on from chunk 2's state
    assert torch.equal(got, one)
    assert not os.path.exists(path)


def test_incompatible_snapshot_restarts(grid, tmp_path):
    """A snapshot of another seed, or of the JAX package's render of the
    same scene, key and config, is not resumed: the render starts afresh
    (its first chunk ends at iteration 4) and equals the one-shot one."""
    scene, cam = grid
    path = str(tmp_path / "queue.npz")
    kw = dict(lanes=256, target_chunk_s=1e-9, checkpoint_path=path,
              checkpoint_every_s=0.0)
    with pytest.raises(Interrupted):
        render_fused_queue_chunked(scene, cam, master_key_data(9), CFG, 4,
                                   progress=_stop_after(3, []), **kw)
    js, jcam, ts, tcam = scenes("grid600")
    with pytest.raises(Interrupted):
        jax_chunked(js, jcam, jax.random.PRNGKey(2), JConfig(max_depth=4), 2,
                    lanes=256, target_chunk_s=1e-9,
                    checkpoint_path=str(tmp_path / "jax.npz"),
                    checkpoint_every_s=0.0, progress=_stop_after(3, []))
    for snap, s, c in ((path, scene, cam),
                       (str(tmp_path / "jax.npz"), ts, tcam)):
        assert os.path.exists(snap)
        key = master_key_data(2)
        spp = 4 if snap == path else 2
        want, _ = render_fused_queue(s, c, key, CFG, spp, lanes=256)
        seen = []
        got, _ = render_fused_queue_chunked(
            s, c, key, CFG, spp, lanes=256, target_chunk_s=1e-9,
            checkpoint_path=snap, checkpoint_every_s=0.0, resume=True,
            progress=lambda it, counter, seconds: seen.append(it))
        assert seen[0] == 4 and torch.equal(got, want)


def test_cli_checkpoint_and_resume(tmp_path):
    from PIL import Image

    out, snap = tmp_path / "grid.png", tmp_path / "grid.npz"
    argv = ["--scene", "grid:600", "--width", "16", "--height", "16",
            "--spp", "2", "--lanes", "512", "--device", "cpu",
            "--checkpoint", str(snap), "--resume", "--out", str(out)]
    assert cli.main(argv) == 0
    assert not snap.exists()
    with Image.open(out) as im:
        assert im.size == (16, 16) and np.asarray(im).mean() > 0


SCAN = RenderConfig(intersector="mxu", max_depth=2, ray_chunk=1024,
                    tri_chunk=64)


def test_render_checkpointed_resume_bitwise(tmp_path):
    scene, cam = cornell_box(width=12, height=12, device="cpu")
    full = render_checkpointed(scene, cam, SCAN, spp=6,
                               ckpt_path=str(tmp_path / "a.npz"), chunk=6)
    p = str(tmp_path / "b.npz")

    def stop(done, spp):
        raise Interrupted

    with pytest.raises(Interrupted):
        render_checkpointed(scene, cam, SCAN, spp=6, ckpt_path=p, chunk=3,
                            progress=stop)
    assert os.path.exists(p)
    resumed = render_checkpointed(scene, cam, SCAN, spp=6, ckpt_path=p,
                                  chunk=3)
    np.testing.assert_array_equal(resumed, full)
    # another seed ignores the stale checkpoint instead of blending into it
    other = render_checkpointed(scene, cam, SCAN, spp=6, ckpt_path=p,
                                seed=9, chunk=6)
    assert np.isfinite(other).all() and not np.array_equal(other, full)
