"""The regeneration oracles (``tinyraytracing_tpu_torch/integrator/regen.py``)
on the CPU.

- Against the JAX package's ``render_regen`` / ``render_persistent`` with
  the same key, lanes and config (cornell 16x16, 2 spp, "mxu", depth 4),
  the arithmetic aligned in a process of its own
  (tests/torch_aligned_render.py ``regen:cornell``): every pixel within
  rtol 1e-6 / atol 1e-6, and the traced-ray counts equal; cases with lanes that do not divide the paths
  and multi-epoch persistent renders (64 and 100 lanes over 256 pixels).
- tests/test_integrator.py's checks of the JAX oracles, on the port: the
  same estimator as the port's scan renderer (means within 10%,
  correlation > 0.9), bitwise determinism per key (also through the
  ``_stats`` / ``_image`` entry points), and other lane counts within 30%.
- The loop condition read every ``CHECK_EVERY`` iterations gives the
  image and ray count of reading it every iteration, bit for bit.
"""

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator import regen
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.render import render
from tests.torch_aligned_render import REGEN_CASES, SIZE, run_processes

RENDERERS = {"regen": regen.render_regen, "persistent": regen.render_persistent}


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    return run_processes(str(tmp_path_factory.mktemp("aligned_regen")),
                         ["regen:cornell"])


@pytest.mark.parametrize("case", list(REGEN_CASES))
def test_oracle_matches_jax(aligned, case):
    want = aligned[f"regen-cornell-{case}-jax"]
    got = aligned[f"regen-cornell-{case}-port"]
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and (got >= 0).all() and got.mean() > 0
    # aligned, the port reproduces the JAX oracles to ~1e-7 in every pixel
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (aligned[f"regen-cornell-{case}-rays-port"]
            == aligned[f"regen-cornell-{case}-rays-jax"])


@pytest.fixture(scope="module")
def cornell24():
    scene, cam = cornell_box(24, 24, device="cpu")
    cfg = RenderConfig(intersector="mxu", max_depth=8, tri_chunk=64)
    return scene, cam, cfg, render(scene, cam, master_key_data(3), cfg, 16).numpy()


@pytest.mark.parametrize("kind", list(RENDERERS))
def test_oracle_matches_scan_statistically(cornell24, kind):
    """The same estimator as the fixed-depth scan (another schedule and
    RNG mapping): tests/test_integrator.py's criteria."""
    scene, cam, cfg, a = cornell24
    b, _ = RENDERERS[kind](scene, cam, master_key_data(3), cfg, 16, lanes=4096)
    b = b.numpy()
    assert np.isfinite(b).all() and (b >= 0).all()
    assert abs(a.mean() - b.mean()) / a.mean() < 0.1
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr > 0.9, corr


@pytest.mark.parametrize("kind,lanes,other", [("regen", 512, 2048),
                                              ("persistent", 256, 64)])
def test_oracle_deterministic(kind, lanes, other):
    """Bitwise per key; another lane count (for persistent, 64 lanes: 4
    dense epoch writes) is another valid estimate of the same image."""
    scene, cam = cornell_box(16, 16, device="cpu")
    cfg = RenderConfig(intersector="mxu", max_depth=4, tri_chunk=64)
    fn = RENDERERS[kind]
    a, ra = fn(scene, cam, master_key_data(1), cfg, 4, lanes=lanes)
    b, rb = fn(scene, cam, master_key_data(1), cfg, 4, lanes=lanes)
    assert torch.equal(a, b) and torch.equal(ra, rb)
    # the entry points named after the JAX package's jitted wrappers
    b, rb = getattr(regen, f"render_{kind}_stats")(
        scene, cam, master_key_data(1), cfg, 4, lanes=lanes)
    assert torch.equal(a, b) and torch.equal(ra, rb)
    assert torch.equal(a, getattr(regen, f"render_{kind}_image")(
        scene, cam, master_key_data(1), cfg, 4, lanes=lanes))
    c, _ = fn(scene, cam, master_key_data(1), cfg, 4, lanes=other)
    assert torch.isfinite(c).all() and (c >= 0).all()
    assert abs(float(a.mean()) - float(c.mean())) / float(a.mean()) < 0.3


@pytest.mark.parametrize("kind,lanes", [("regen", 300), ("persistent", 100)])
def test_termination_cadence_is_exact(monkeypatch, kind, lanes):
    """Reading the loop condition every CHECK_EVERY iterations runs up to
    CHECK_EVERY - 1 iterations past the last path: the image and the ray
    counts are those of reading it every iteration, bit for bit."""
    scene, cam = cornell_box(16, 16, device="cpu")
    cfg = RenderConfig(intersector="mxu", max_depth=4, tri_chunk=64)
    out = {}
    for every in (1, 4, 7):
        monkeypatch.setattr(regen, "CHECK_EVERY", every)
        stats = {}
        img, rays = RENDERERS[kind](scene, cam, master_key_data(2), cfg, 3,
                                    lanes=lanes, stats=stats)
        out[every] = (img, rays, stats)
    img, rays, stats = out[1]
    assert stats["rays"] == int(rays) > 0
    for every in (4, 7):
        assert torch.equal(out[every][0], img)
        assert torch.equal(out[every][1], rays)
        assert out[every][2]["rays"] == stats["rays"]
        assert out[every][2]["iterations"] >= stats["iterations"]
    # the cadences did run past the last path
    assert max(out[e][2]["iterations"] for e in (4, 7)) > stats["iterations"]
