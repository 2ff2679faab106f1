"""The port's ``utils/`` reports, timer and logger against the JAX
package's, and the CLI's log lines through them, on the CPU."""

import dataclasses
import inspect
import json
import logging
import os

import numpy as np
import pytest

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.models.procedural import quad_grid as jquad_grid
from tinyraytracing_tpu.ops.bvh import attach_bvh as jattach
from tinyraytracing_tpu.utils import logging as jlogging
from tinyraytracing_tpu.utils import report as jreport
from tinyraytracing_tpu_torch import cli
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator.wavefront import trace
from tinyraytracing_tpu_torch.models.camera import generate_rays
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import fold_in, master_key_data, split
from tinyraytracing_tpu_torch.utils import get_logger, Timer
from tinyraytracing_tpu_torch.utils import report
from tests.torch_port_util import port_scene

CFG = RenderConfig(intersector="bvh", max_depth=3)


@pytest.mark.parametrize("skip", [[3, 2, 3], [1], [], [7, 4, 3, 4, 7, 6, 7]])
def test_bvh_depth_hand_trees(skip):
    skip = np.asarray(skip, np.int32)
    assert report.bvh_depth(skip) == jreport.bvh_depth(skip)


@pytest.mark.parametrize("leaf", [4, 8])
def test_bvh_depth_matches_jax_on_the_same_tree(leaf):
    js, _ = jquad_grid(600, 8, 8)
    js = jattach(js, JConfig(leaf_size=leaf))
    ts = port_scene(js)
    got = report.bvh_depth(ts.bvh.skip.numpy())
    assert got == jreport.bvh_depth(np.asarray(js.bvh.skip)) and got > 3


def test_render_report_json_has_the_jax_keys():
    names = [f.name for f in dataclasses.fields(report.RenderReport)]
    assert names == [f.name for f in dataclasses.fields(jreport.RenderReport)]
    rep = report.RenderReport(*range(len(names)))
    assert list(json.loads(rep.to_json())) == names


def _scene(w=16, h=16):
    scene, cam = cornell_box(w, h, device="cpu")
    return attach_bvh(scene, RenderConfig()), cam


def test_profiled_render_counts_the_scan_stats(tmp_path):
    """rays_traced is the sum of wavefront.trace's stats over the passes,
    the image their mean; with trace_dir the profiler's trace is
    written."""
    scene, cam = _scene()
    img, rep = report.profiled_render(scene, cam, CFG, spp=2, seed=3,
                                      trace_dir=str(tmp_path / "prof"))
    key, rays, acc = master_key_data(3), 0, 0.0
    for s in range(2):
        k1, k2 = split(fold_in(key, s))
        o, d = generate_rays(cam, k1, "cpu")
        rad, stats = trace(scene, o, d, k2, CFG, return_stats=True)
        rays += int(stats["primary"].sum() + stats["shadow"].sum())
        acc = acc + rad.reshape(16, 16, 3).double().numpy()
    assert rep.rays_traced == rays > 16 * 16 * 2
    np.testing.assert_allclose(img, acc / 2, rtol=1e-6, atol=1e-7)
    assert img.dtype == np.float32 and img.shape == (16, 16, 3)
    assert (rep.num_triangles, rep.num_materials, rep.num_lights) == (
        scene.num_triangles, scene.num_materials, scene.num_lights)
    assert rep.bvh_nodes == scene.bvh.n_nodes
    assert rep.bvh_depth == report.bvh_depth(scene.bvh.skip.numpy())
    assert rep.rays_per_s > 0 and rep.seconds > 0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_timer_waits_for_sync():
    calls = []
    with Timer(sync=lambda: calls.append(1)) as t:
        pass
    assert calls == [1] and t.elapsed >= 0
    with Timer() as t2:
        pass
    assert t2.elapsed >= 0


def test_logger_is_the_jax_packages():
    """Same default name, level and format as tinyraytracing_tpu's."""
    assert (inspect.signature(get_logger).parameters["name"].default
            == inspect.signature(jlogging.get_logger).parameters["name"].default
            == "tinypt")
    a, b = get_logger("tinypt-port-test"), jlogging.get_logger("tinypt-jax-test")
    assert a.level == b.level == logging.INFO
    assert [h.formatter._fmt for h in a.handlers] == [
        h.formatter._fmt for h in b.handlers]


def test_cli_log_lines(tmp_path, caplog):
    """The CLI logs its lines through get_logger ("tinypt")."""
    out = tmp_path / "c.png"
    with caplog.at_level(logging.INFO, logger="tinypt"):
        rc = cli.main(["--scene", "cornell", "--width", "12", "--height", "10",
                       "--spp", "1", "--max-depth", "2", "--device", "cpu",
                       "--out", str(out)])
    assert rc == 0 and out.exists()
    msgs = [r.getMessage() for r in caplog.records if r.name == "tinypt"]
    assert msgs[0] == ("scene: 32 triangles, 4 materials, 1 lights; image "
                       "12x10 @ 1 spp on cpu"), msgs
    assert msgs[1].startswith("BVH: ") and msgs[1].endswith(" wide nodes")
    assert msgs[-1].startswith(f"rendered {out} in ")
    assert msgs[-1].endswith(" camera rays/s)")
