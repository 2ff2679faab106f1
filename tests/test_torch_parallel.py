"""The port's multi-rank renderers (``tinyraytracing_tpu_torch/parallel``)
and the two repairs they stand on, on the CPU.

- Against the JAX package, aligned (``tests/torch_aligned_render.py
  sharded:cornell``, in a process of its own with FMA contraction off):
  JAX's ``render_sharded``, ``render_fused_sharded`` and
  ``render_queue_sharded`` on a 2x2 mesh of virtual CPU devices beside the
  port's per-rank shares run serially and combined as the collectives
  combine them; ``render_fused_queue`` on slices of the path queue
  (``path_lo`` / ``n_paths``). The render tests' bounds: >= 99% of pixels
  within rtol 1e-4 / atol 1e-5 and means within 1e-4 (aligned, every
  pixel agrees to ~1e-7).
- The collective layer, port against port: four gloo ranks
  (``tests/torch_parallel_ranks.py``), spawned once for the module, run
  every case; each test waits for its own case under a timeout of its
  own. The single-process references are computed here meanwhile.
- ``generate_rays_for_pixels`` and ``generate_rays_np`` against the JAX
  camera's.

JAX's ``render_queue_sharded_chunked`` is not called here: after other
sharded programs it deadlocks on the virtual CPU devices
(tests/test_parallel.py says so); the port's chunked driver is held to the
port's one-shot render instead.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks_mod
from tests.torch_aligned_render import (
    SHARDED_CASES, SLICE_SPP, SLICES, run_processes,
)
from tinyraytracing_tpu.models import camera as jcamera
from tinyraytracing_tpu.models.procedural import cornell_box as jcornell
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff.fast import render_loss_fast
from tinyraytracing_tpu_torch.diff.inverse import SceneParams
from tinyraytracing_tpu_torch.integrator.fused import render_fused_stats
from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue
from tinyraytracing_tpu_torch.models.camera import (
    Camera, generate_rays_for_pixels, generate_rays_np,
)
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.parallel import mesh as pmesh

CASE_TIMEOUT_S = 180


def _close(got, want):
    """The render tests' bounds."""
    assert np.isfinite(got).all() and (got >= 0).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


# ---------------------------------------------------------------------------
# against the JAX package, aligned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aligned(tmp_path_factory, ranks):
    # the gloo ranks (``ranks``) start first and work meanwhile
    return run_processes(str(tmp_path_factory.mktemp("aligned_sharded")),
                         [f"sharded:cornell:{k}"
                          for k in ("scan", "fused", "queue", "slices")])


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_matches_jax(case, aligned):
    want = aligned[f"sharded-{case}-jax"]
    got = aligned[f"sharded-{case}-port"]
    assert got.shape == want.shape
    _close(got, want)
    # aligned, every pixel agrees to the rounding of its sums (the queue's
    # ranks add in another order than JAX's psum: tests/test_parallel.py's
    # bound)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if f"sharded-{case}-rays-jax" in aligned:
        assert aligned[f"sharded-{case}-rays-port"] == aligned[f"sharded-{case}-rays-jax"]


@pytest.mark.parametrize("lo,n", SLICES)
def test_queue_slice_matches_jax(lo, n, aligned):
    """``render_fused_queue(path_lo=lo, n_paths=n)``: n is no multiple of
    128, and the last slice reaches past the path count."""
    want = aligned[f"slice-{lo}-jax"]
    got = aligned[f"slice-{lo}-port"]
    _close(got, want)
    assert np.abs(got - want).max() <= 1e-6
    assert aligned[f"slice-{lo}-rays-port"] == aligned[f"slice-{lo}-rays-jax"]


def test_queue_slices_sum_to_the_full_render(aligned):
    """The slices cover every path once: their images add up to the
    whole render's (to the rounding of the pixel sums) and their ray
    counts to its count."""
    full = aligned["slice-full-port"]
    parts = sum(aligned[f"slice-{lo}-port"] for lo, _ in SLICES)
    np.testing.assert_allclose(parts, full, rtol=1e-5, atol=1e-6)
    rays = sum(float(aligned[f"slice-{lo}-rays-port"]) for lo, _ in SLICES)
    assert rays == float(aligned["slice-full-rays-port"])
    assert full.shape[0] * SLICE_SPP <= rays


# ---------------------------------------------------------------------------
# the collective layer: four gloo ranks
# ---------------------------------------------------------------------------

class _Ranks:
    """The four rank processes and their results, case by case."""

    def __init__(self, out):
        self.out = out
        self.ctx = torch.multiprocessing.start_processes(
            ranks_mod.run_rank, args=(f"file://{out}/rendezvous", str(out)),
            nprocs=ranks_mod.WORLD, join=False, start_method="spawn")

    def result(self, case):
        """Every rank's results of ``case``, in rank order; fails if a
        rank died, raised, or the case took longer than CASE_TIMEOUT_S."""
        files = [os.path.join(self.out, f"{case}.rank{r}.pt")
                 for r in range(ranks_mod.WORLD)]
        t0 = time.monotonic()
        while not all(os.path.exists(f) for f in files):
            codes = [p.exitcode for p in self.ctx.processes]
            assert all(c in (None, 0) for c in codes), f"rank exit codes {codes}"
            assert time.monotonic() - t0 < CASE_TIMEOUT_S, f"{case}: timed out"
            time.sleep(0.05)
        res = [torch.load(f, weights_only=False) for f in files]
        for r, x in enumerate(res):
            assert not (isinstance(x, dict) and "error" in x), \
                f"rank {r}:\n{x['error']}"
        return res

    def close(self):
        for p in self.ctx.processes:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.close()


def test_make_mesh_shapes_and_collectives(ranks):
    res = ranks.result("mesh")
    for r, got in enumerate(res):
        assert got[(None, None)] == (4, 1, r, (r, 0))
        assert got[(2, None)] == (2, 2, r, (r // 2, r % 2))
        assert got[(None, 4)] == (1, 4, r, (0, r))
        assert got[(2, 2)] == (2, 2, r, (r // 2, r % 2))
        assert got[(4, 1)] == (4, 1, r, (r, 0))
        assert got[(3, None)] == "ValueError: mesh 3x1 != 4 ranks"
        assert got[(2, 3)] == "ValueError: mesh 2x3 != 4 ranks"
        assert got[(None, 3)] == "ValueError: mesh 1x3 != 4 ranks"
        # ranks 0..3 at (r // 2, r % 2): the tile axis joins r and r ^ 2,
        # the spp axis r and r ^ 1
        assert got["reduce"] == [6.0, float(r + (r ^ 2)), float(r + (r ^ 1))]
        assert got["gather"] == [[0.0, 1.0, 2.0, 3.0],
                                 [float(r % 2), float(r % 2 + 2)],
                                 [float(r // 2 * 2), float(r // 2 * 2 + 1)]]
        assert got["bcast"] == 7.0
    for r in (0, 1):
        assert res[r]["sub"] == (2, 1, r, 3.0)
        assert res[r]["sub 1x2"] == (1, 2, (0, r))
    assert "sub" not in res[2] and "sub" not in res[3]


def test_mesh_without_process_group_is_one_rank():
    """No process group: the 1x1 mesh, whose collectives are identities;
    the sharded entry points are then the single-process renders."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = pmesh.make_mesh()
    assert (m.n_tile, m.n_spp, m.rank, m.size, m.group) == (1, 1, 0, 1, None)
    x = torch.arange(3.0)
    assert torch.equal(m.all_reduce(x), x) and torch.equal(m.all_gather(x), x)
    with pytest.raises(ValueError, match="mesh 2x0 != 1 ranks"):
        pmesh.make_mesh(2)
    scene, cam = ranks_mod.cornell(16, 16)
    cfg, key = RenderConfig(**ranks_mod.QUEUE_CFG), master_key_data(2)
    img, rays = pmesh.render_queue_sharded(scene, cam, key, cfg, 2, lanes=256)
    want, want_rays = render_fused_queue(scene, cam, key, cfg, 2, lanes=256)
    assert torch.equal(img, want.reshape(16, 16, 3)) and torch.equal(rays, want_rays)


@pytest.mark.parametrize("w,h,shape", [(32, 32, (4, 1)), (32, 32, (2, 2)),
                                       (20, 13, (4, 1)), (20, 13, (2, 2))])
def test_fused_sharded_bitwise(w, h, shape, ranks):
    """Four ranks give render_fused's image bit for bit, on every rank;
    the ray count within float32 rounding of the total."""
    scene, cam = ranks_mod.cornell(w, h)
    want, want_rays = render_fused_stats(
        scene, cam, master_key_data(5), RenderConfig(**ranks_mod.FUSED_CFG), 2,
        lanes=512)
    for img, rays in (res[(w, h, shape)] for res in ranks.result("fused")):
        assert torch.equal(img, want)
        assert abs(float(rays) - float(want_rays)) <= 4 * np.spacing(
            np.float32(want_rays))


def test_queue_sharded_within_rounding(ranks):
    scene, cam = ranks_mod.cornell(19, 11)
    want, want_rays = render_fused_queue(
        scene, cam, master_key_data(12), RenderConfig(**ranks_mod.QUEUE_CFG),
        3, lanes=256)
    res = ranks.result("queue")
    for img, rays in res:
        assert torch.equal(img, res[0][0]) and torch.equal(rays, res[0][1])
        np.testing.assert_allclose(img.reshape(-1, 3).numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert float(rays) == float(want_rays)      # small counts: exact


def test_loss_sharded_gradients(ranks):
    """Loss and gradients of four ranks: equal on every rank and to
    render_loss_fast's within the JAX test's bounds
    (tests/test_parallel.py)."""
    scene, cam = ranks_mod.cornell(16, 16)
    params = SceneParams.init_from(scene, cam, *ranks_mod.LOSS_FIELDS)
    for t in params.tensors():
        t.requires_grad_(True)
    loss = render_loss_fast(params, scene, cam, master_key_data(7),
                            torch.zeros(16, 16, 3),
                            RenderConfig(**ranks_mod.LOSS_CFG), 2)
    loss.backward()
    res = ranks.result("loss")
    for got in res:
        np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-5)
        for f in ranks_mod.LOSS_FIELDS:
            assert torch.equal(got[f], res[0][f]), f
            np.testing.assert_allclose(got[f].numpy(),
                                       getattr(params, f).grad.numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=f)
    assert sum(float(res[0][f].abs().sum()) for f in ranks_mod.LOSS_FIELDS) > 0


def test_chunked_preempt_resume_bitwise(ranks):
    """The chunked driver, through and after a preemption and a resume,
    bit for bit the one-shot render_queue_sharded; the resume starts past
    the preempted iteration; the snapshots are kept on preemption and
    removed at the end."""
    res = ranks.result("chunked")
    for got in res:
        for k in ("whole", "resumed"):
            assert torch.equal(got[k][0], got["one"][0]), k
            assert torch.equal(got[k][1], got["one"][1]), k
        assert got["kept"] and got["cleared"]
        assert len(got["part"]) == 1 and got["half"][0] > got["part"][-1]
        assert got["one"][0].mean() > 0
    assert all(torch.equal(g["one"][0], res[0]["one"][0]) for g in res)


def test_render_sharded_is_its_shares(ranks):
    """render_sharded on a 2x2 mesh (15x13 px, spp 5) equals its four
    shares run serially here and combined as the collectives combine
    them, on every rank."""
    scene, cam = ranks_mod.cornell(15, 13)
    key, cfg = master_key_data(4), RenderConfig(**ranks_mod.SCAN_CFG)
    want = ranks_mod.serial_render_sharded(scene, cam, key, cfg, 5, 2, 2)
    for img in ranks.result("scan"):
        assert torch.equal(img, want)
    assert want.shape == (13, 15, 3) and float(want.mean()) > 0


# ---------------------------------------------------------------------------
# the camera repair
# ---------------------------------------------------------------------------

def _cams(width=15, height=13):
    jcam = jcornell(width, height)[1]
    tcam = Camera.create(np.array(jcam.eye), np.array(jcam.lookat),
                         np.array(jcam.up), float(jcam.fovy), width, height)
    return jcam, tcam


def test_generate_rays_for_pixels_matches_jax():
    """The same pixels (a padded, clamped tile) and key: equal origins,
    directions within float32 rounding (the uniform draws are bitwise)."""
    jcam, tcam = _cams()
    pix = np.minimum(np.arange(40, 140), 15 * 13 - 1).astype(np.int32)
    jo, jd = jcamera.generate_rays_for_pixels(
        jcam, jnp.asarray(pix), jax.random.PRNGKey(9))
    to, td = generate_rays_for_pixels(tcam, torch.from_numpy(pix),
                                      master_key_data(9), device="cpu")
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-7)
    # whole image in row-major order: generate_rays' rays
    from tinyraytracing_tpu_torch.models.camera import generate_rays

    _, d_all = generate_rays(tcam, master_key_data(9), "cpu")
    _, d_pix = generate_rays_for_pixels(tcam, torch.arange(15 * 13),
                                        master_key_data(9), device="cpu")
    assert torch.equal(d_all, d_pix)


def test_generate_rays_np_matches_jax():
    jcam, tcam = _cams()
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.1, 1.1, 50), rng.uniform(-0.1, 1.1, 50)
    jo, jd = jcamera.generate_rays_np(jcam, x, y)
    to, td = generate_rays_np(tcam, x, y)
    assert to.dtype == np.float64 and td.dtype == np.float64
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(td, jd)
