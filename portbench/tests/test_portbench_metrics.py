"""The reduction from device traces and spans to per-layer metrics, on
synthetic events, and the window's arithmetic: a stall inside the window
lowers the rate."""

import time

import pytest
import torch
from conftest import tiny_run, tiny_spec
from core import harness, port, profiling

# (name, start s, end s): two overlapping trace launches, a scatter, and an
# NCCL kernel after a gap
KERNELS = [
    ("void trace_kernel<false, true, false, true>(TraceParams)", 0.0, 0.4),
    ("void trace_kernel<true, false, false, true>(TraceParams)", 0.2, 0.5),
    ("void scatter_kernel(Job)", 0.6, 0.7),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.9, 1.0),
]


def test_union_busy_idle():
    spans = profiling.union(KERNELS)
    assert [(s, e) for s, e, _ in spans] == [(0.0, 0.5), (0.6, 0.7), (0.9, 1.0)]
    assert profiling.busy_s(KERNELS) == pytest.approx(0.7)
    assert profiling.idle_pct(KERNELS, 2.0) == pytest.approx(65.0)
    assert profiling.idle_pct([], 2.0) is None


def test_breakdown_names_ops_and_gaps():
    b = profiling.breakdown(KERNELS)
    assert b["device_ops"][0][1] == pytest.approx(0.4)
    assert b["idle_gaps"][0][0].startswith("after_void_scatter_kernel")
    assert b["idle_gaps"][0][1] == pytest.approx(0.2)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("unit", ["render", "queue"])
def test_render_readers(unit):
    sub = dict(wall_s=2.0, kernels=KERNELS, rays=1e6, paths=2e5, pixels=1000,
               triangles=100, scatter=True)
    obs = {"render_sub": sub, "scene_build_s": 1.5}
    assert harness.read_layer_metric(f"loop.iter_ms.{unit}", obs) == pytest.approx(2000.0)
    assert harness.read_layer_metric(f"device.idle_pct.{unit}", obs) == pytest.approx(65.0)
    assert harness.read_layer_metric("scene_build_s", obs) == 1.5
    need = 1e6 * 28 + 2 * 100 * 36 + 2e5 * 16 + 1000 * 24
    want = 100 * need / 3.35e12 / (0.4 + 0.3 + 0.1)
    roofline = f"{unit}_kernels_roofline"
    assert harness.read_layer_metric(roofline, obs) == pytest.approx(want)
    sub["scatter"] = False
    assert harness.read_layer_metric(roofline, obs) < want
    # nothing to read: no metric, never a 0
    assert harness.read_layer_metric(roofline, {"render_sub": dict(sub, kernels=[])}) is None


def test_inverse_and_mesh_readers():
    obs = {"steps": [(0.1, 0.3, 0.1), (0.1, 0.3, 0.1)],
           "inverse_sub": dict(wall_s=1.0, kernels=KERNELS)}
    assert harness.read_layer_metric("diff.backward_pct", obs) == pytest.approx(60.0)
    assert harness.read_layer_metric("device.idle_pct.inverse", obs) == pytest.approx(30.0)
    obs["step_times"] = [0.3] * 9 + [0.5]
    assert harness.read_layer_metric("diff.step_ms_p90", obs) == pytest.approx(480.0)
    assert harness.read_layer_metric("diff.step_ms_p90", {"step_times": []}) is None
    ranks = [dict(wall_s=1.0, kernels=KERNELS, passes=1),
             dict(wall_s=2.0, kernels=KERNELS[:1], passes=1)]
    obs = {"rank_subs": ranks}
    assert harness.read_layer_metric("mesh.allreduce_ms", obs) == pytest.approx(100.0)
    assert harness.read_layer_metric("device.idle_pct.x4", obs) == pytest.approx(80.0)


def _fake_render(stall_at=None, stall_s=0.0):
    """A stand-in for the queue slice: a fixed count in a fixed time, and one
    stall on the bucket ``stall_at``."""
    calls = []

    def fake(real):
        def f(scene, cam, key, config, spp, lanes, path_lo, n_paths):
            calls.append(path_lo)
            time.sleep(stall_s if len(calls) == stall_at else 0.02)
            return torch.zeros((cam.width * cam.height, 3)), torch.tensor(1000.0)
        return f
    return fake


def test_a_stall_lowers_rays_per_s(bench, monkeypatch):
    cell = "grid100k.bucket512"
    spec = tiny_spec(bench, cell)
    rates = []
    for stall in (0.0, 0.5):
        monkeypatch.setattr(port, "render_queue_slice",
                            _fake_render(stall_at=3, stall_s=stall)(port.render_queue_slice))
        out = harness.driver("queue_buckets").run(tiny_run(spec, cell, seconds=0.3))
        rates.append(out["e2e"]["rays_per_s_queue"])
        monkeypatch.undo()
    assert rates[1] < 0.7 * rates[0]
