"""The port's scan renderer (``render.render``: fixed-depth wavefront over
``ops/intersect.py``) against the JAX package's ``render`` on the CPU: same
scene arrays, same seed (hence the same ``jax.random`` streams, chunk keys
included), every intersector backend.

The renders run with the arithmetic of the two packages aligned, in a
process of its own (tests/torch_aligned_render.py ``scan:<scene>``:
XLA's FMA contraction off, XLA's transcendentals in the port); the JAX
package's "bvh_pallas" and "pallas" backends run their Pallas kernels in
interpret mode, the port's the kernels' plain versions. Held as the
queue's render test holds: >= 99% of pixels within rtol 1e-4 / atol 1e-5
and image means within 1e-4 relative. This file holds the cornell cases,
tests/test_torch_scan_render_grid.py the grid600 ones (one process each,
so each file stays within about two minutes on one core).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tinyraytracing_tpu_torch import cli
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.render import render, render_image
from tests.torch_aligned_render import SCAN_CASES, SIZE, run_processes, scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """Both packages' scan images of the cornell cases (one process)."""
    return run_processes(str(tmp_path_factory.mktemp("aligned_scan")),
                         ["scan:cornell"])


def check_scan_case(images, name, cfg):
    """>= 99% of pixels within rtol 1e-4 / atol 1e-5, means within 1e-4."""
    want = images[f"scan-{name}-{cfg}-jax"]
    got = images[f"scan-{name}-{cfg}-port"]
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and (got >= 0).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


@pytest.mark.parametrize("cfg", [c for n, c in SCAN_CASES if n == "cornell"])
def test_scan_render_matches_jax(cfg, aligned):
    check_scan_case(aligned, "cornell", cfg)


def test_render_image_scan_is_render_and_seeded():
    _, _, ts, tcam = scenes("cornell")
    cfg = RenderConfig(max_depth=4, intersector="bvh_pallas")
    img = render_image(ts, tcam, cfg, spp=2, seed=5, renderer="scan")
    again = render(ts, tcam, master_key_data(5), cfg, 2).numpy()
    np.testing.assert_array_equal(img, again)
    other = render_image(ts, tcam, cfg, spp=2, seed=6, renderer="scan")
    assert img.shape == (SIZE, SIZE, 3) and not np.array_equal(img, other)


def test_cli_scan_renders_png_on_cpu(tmp_path):
    out = tmp_path / "cornell.png"
    rc = cli.main(["--scene", "cornell", "--renderer", "scan", "--width",
                   "12", "--height", "10", "--spp", "1", "--max-depth", "3",
                   "--intersector", "pallas", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    with Image.open(out) as im:
        assert im.size == (12, 10)
        assert np.asarray(im).mean() > 0


def test_cli_without_cuda_needs_device_cpu():
    """No silent CPU fallback: without a CUDA device the default --device
    cuda exits with a message naming --device cpu."""
    res = subprocess.run(
        [sys.executable, "-m", "tinyraytracing_tpu_torch.cli", "--scene",
         "cornell", "--renderer", "scan", "--width", "4", "--height", "4",
         "--spp", "1", "--out", os.devnull],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
