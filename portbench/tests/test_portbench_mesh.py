"""The mesh cell ``hfield100k.vertex-inverse`` at a tiny size on the CPU,
through the harness, against the plain reference of
``core/reference_mesh.py``: a sound run comes out correct, the control and
both faults planted under the timed path do not; its readers of device
time by span and its per-layer metrics on synthetic events; and a program
without the per-vertex leaf fails at once."""

import copy
import dataclasses

import pytest
import torch
from conftest import tiny_run
from core import harness, port_mesh, span_profile

import faults_mesh

CELL = "hfield100k.vertex-inverse"
TINY = ({"scene": {"kind": "height_grid", "cells": 8, "grid_seed": 0, "bumps": 16}},
        {"width": 24, "height": 24, "spp": 2})


def tiny_spec(bench):
    spec = copy.deepcopy(harness.cell_spec(bench, CELL))
    spec["config"].update(copy.deepcopy(TINY[0]))
    spec["traffic"].update(TINY[1])
    return spec


def test_the_cell_finds_its_files(bench):
    spec = harness.cell_spec(bench, CELL)
    assert spec["config"]["scene"]["kind"] == "height_grid"
    assert spec["traffic"]["driver"] == "mesh_inverse_steps"
    assert set(spec["limits"]) == {"loss_gap", "grad_gap", "change_gap", "vertex_grad_gap",
                                   "vertex_change_gap"}
    raw = harness.load_module(harness.BENCH_DIR / "scenes" / "height_grid.py",
                              "height_grid").build(8, 8, cells=224)
    lo, hi = raw["mesh_range"]
    assert hi - lo == len(raw["vertex_index"]) == 100_352
    assert len(raw["vertex_positions"]) == 50_625


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(bench, trace):
    spec = tiny_spec(bench)
    res = harness.execute(spec, tiny_run(spec, CELL, trace=trace), bench)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in harness.metrics_for(bench, "per_layer" if trace else "end_to_end",
                                                   CELL)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want


def test_control_is_not_correct(bench):
    spec = tiny_spec(bench)
    checks = harness.driver("mesh_inverse_steps").control(tiny_run(spec, CELL))
    assert not harness.judge(checks, spec["limits"])[0], checks


# the number each fault must fail: a wrong vertex gradient, or a sound
# gradient whose update never reaches the vertices
CAUGHT_BY = {"stale_normals": "vertex_grad_gap", "shuffled_vertex": "vertex_grad_gap",
             "unchanged_vertex": "vertex_change_gap"}


@pytest.mark.parametrize("fault", sorted(faults_mesh.FAULTS))
def test_fault_is_not_correct(bench, fault):
    spec = tiny_spec(bench)
    res = faults_mesh.run_with_fault(spec, tiny_run(spec, CELL), bench, fault)
    assert not res["correct"], (fault, res["checks"])
    check = res["checks"][CAUGHT_BY[fault]]
    assert check["value"] > check["limit"], (fault, res["checks"])


def test_a_program_without_the_leaf_fails_at_once(monkeypatch):
    from tinyraytracing_tpu_torch.diff import inverse

    @dataclasses.dataclass
    class Old:
        kd: torch.Tensor | None = None
        vertex_offset: torch.Tensor | None = None

    monkeypatch.setattr(inverse, "SceneParams", Old)
    with pytest.raises(RuntimeError, match="shared_vertex_offset"):
        port_mesh.require_mesh_leaf()


def test_device_time_goes_to_the_innermost_span_at_launch():
    spans = [("diff.refit", 0, 100, -1, 1), ("diff.mesh", 10, 40, 0, 1),
             ("diff.backward", 200, 400, -1, 1), ("diff.mesh.scatter", 300, 320, -1, 2)]
    kernels = [("a", 1.0, 2.0), ("b", 2.0, 2.5), ("c", 3.0, 3.25), ("d", 4.0, 4.5),
               ("e", 5.0, 6.0)]
    launched = [5e-9, 20e-9, 50e-9, 310e-9, None]     # seconds on the spans' clock
    got = span_profile.device_s_by_span(kernels, launched, spans,
                                        ("diff.mesh", "diff.refit", "diff.mesh.scatter"))
    assert got == {"diff.mesh": 0.5, "diff.refit": 1.25, "diff.mesh.scatter": 0.5}


def test_mesh_readers():
    sub = dict(wall_s=1.0, kernels=[("void trace_kernel<false>", 0.0, 0.2),
                                    ("void scatter_kernel", 0.3, 0.4)],
               steps=2, span_s={"diff.mesh": 0.004, "diff.refit": 0.006,
                                "diff.mesh.scatter": 0.002},
               trace_s=0.2, trace_launches=24, rays=1e6, triangles=1000, vertices=600)
    obs = {"mesh_sub": sub, "step_times": [0.3] * 9 + [0.5]}
    read = lambda name: harness.read_layer_metric(name, obs)
    assert read("mesh.apply_ms") == pytest.approx(2.0)
    assert read("mesh.refit_ms") == pytest.approx(3.0)
    assert read("mesh.scatter_ms") == pytest.approx(1.0)
    assert read("device.idle_pct.mesh") == pytest.approx(70.0)
    assert read("diff.step_ms_p90.mesh") == pytest.approx(480.0)
    need = 2 * 1e6 * 28 + 24 * 1000 * 36 + 2 * (3 * 1000 * 16 + 600 * 24)
    assert read("mesh_kernels_roofline") == pytest.approx(100 * need / 3.35e12 / 0.202)
    # nothing to read: no metric, never a 0
    sub["span_s"] = {}
    assert read("mesh.apply_ms") is None and read("mesh_kernels_roofline") is None
    for name in ("mesh.apply_ms", "mesh.refit_ms", "mesh.scatter_ms", "device.idle_pct.mesh",
                 "diff.step_ms_p90.mesh", "mesh_kernels_roofline"):
        assert harness.read_layer_metric(name, {}) is None
