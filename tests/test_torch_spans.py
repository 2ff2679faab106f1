"""The port's spans and counters (``utils/spans.py``): recording changes no
result and issues no other op, the loops' counters count what the loops
did, spans nest as the code does, and a span shares its clock with the
profiler's events. 16x16 Cornell box on the CPU; the ``cuda`` tests hold
the clock and the kernel list on the card (``--noconftest``: this file
imports no JAX)."""

import collections

import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator import fused_queue
from tinyraytracing_tpu_torch.integrator.fused import render_fused
from tinyraytracing_tpu_torch.models.procedural import cornell_box
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.utils import spans

SPP, LANES = 1, 128
CONFIG = RenderConfig(max_depth=1)


def _profiled(fn, cuda=False):
    """(``fn()``, [(name, start ns, end ns)] of the profile's events: host
    ops, or with ``cuda`` the device's)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU]) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA") == cuda]
    return out, events


def _queue(scene, cam, on, monkeypatch):
    """The queue render, recording ``on`` or off: (image, rays, body calls,
    recording or None)."""
    calls = []
    setup = fused_queue._queue_setup

    def counted_setup(*args, **kwargs):
        max_iters, init, more, body = setup(*args, **kwargs)
        return max_iters, init, more, lambda s: calls.append(1) or body(s)

    monkeypatch.setattr(fused_queue, "_queue_setup", counted_setup)
    run = lambda: fused_queue.render_fused_queue(scene, cam, master_key_data(5),
                                                 CONFIG, SPP, lanes=LANES)
    rec = None
    if on:
        with spans.recording() as rec:
            img, rays = run()
    else:
        img, rays = run()
    return img, rays, len(calls), rec


@pytest.fixture(scope="module")
def cornell():
    scene, cam = cornell_box(16, 16, device="cpu")
    return attach_bvh(scene, RenderConfig()), cam


@pytest.fixture(scope="module")
def queue_runs(cornell):
    with pytest.MonkeyPatch.context() as mp:
        off = _queue(*cornell, False, mp)
        with spans.recording() as after_off:
            pass
        on = _queue(*cornell, True, mp)
    return off, on, after_off


@pytest.fixture(scope="module")
def profiled_iterations(cornell):
    """The queue loop's first iteration under the profiler, recording off
    and on, each from a fresh state: (aten op counts off, on, the
    recording, the profile's events with recording on)."""
    _, init, _, body = fused_queue._queue_setup(*cornell, master_key_data(5), CONFIG, SPP,
                                                LANES)
    aten = lambda ev: collections.Counter(n for n, _, _ in ev if n.startswith("aten::"))
    _, off = _profiled(lambda: body(init()))
    with spans.recording() as rec:
        _, on = _profiled(lambda: body(init()))
    return aten(off), aten(on), rec, on


def _by_name(rec, name):
    return [(i, s) for i, s in enumerate(rec.spans) if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_recording_off_records_nothing_and_returns_no_op():
    assert spans.span("queue.iter") is spans.span("fused.iter")
    with spans.span("queue.iter"):
        pass
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_queue_render_does_not_change_with_recording(queue_runs):
    (img0, rays0, n0, _), (img1, rays1, n1, rec), after_off = queue_runs
    assert after_off.spans == [] and after_off.counts == {}
    assert torch.equal(img0, img1) and torch.equal(rays0, rays1) and n0 == n1
    assert rec.spans and all(s is not None for s in rec.spans)


def test_recording_issues_the_same_ops(profiled_iterations):
    off, on, rec, _ = profiled_iterations
    assert off == on and sum(off.values()) > 0
    assert {s[0] for s in rec.spans} >= {"queue.iter", "queue.refill.sync"}


def test_queue_counters(queue_runs):
    _, (_, _, n_body, rec), _ = queue_runs
    c = rec.counts
    assert c["queue.iterations"] == n_body > 0
    assert c["queue.paths_started"] == 16 * 16 * SPP
    assert c["queue.lanes"] == n_body * LANES
    assert c["queue.paths_started"] <= c["queue.lanes_active"] <= c["queue.lanes"]
    assert len(_by_name(rec, "queue.iter")) == n_body


def test_queue_spans_nest(queue_runs):
    _, (_, _, n_body, rec), _ = queue_runs
    sync = _by_name(rec, "queue.refill.sync")
    assert len(sync) == n_body
    for _, s in sync:
        refill = rec.spans[s[3]]
        assert refill[0] == "queue.refill" and _inside(s, refill)
        it = rec.spans[refill[3]]
        assert it[0] == "queue.iter" and it[3] == -1 and _inside(refill, it)
    for name in ("queue.trace", "queue.rng", "queue.shadow", "queue.scatter"):
        assert all(rec.spans[s[3]][0] == "queue.iter" for _, s in _by_name(rec, name))


def test_a_span_and_the_profilers_ops_share_a_clock(profiled_iterations):
    """The refill read's ``aten::sum`` lies inside its span."""
    _, _, rec, events = profiled_iterations
    sums = [e for e in events if e[0] == "aten::sum"]
    (_, sync), = _by_name(rec, "queue.refill.sync")
    assert any(_inside(e, sync) for e in sums)


def test_persistent_render_does_not_change_with_recording(cornell):
    scene, cam = cornell
    run = lambda: render_fused(scene, cam, master_key_data(6), CONFIG, SPP,
                               lanes=256)
    img0, rays0 = run()
    with spans.recording() as rec:
        img1, rays1 = run()
    assert torch.equal(img0, img1) and torch.equal(rays0, rays1)
    assert rec.counts["fused.epochs"] == 1
    assert rec.counts["fused.iterations"] == len(_by_name(rec, "fused.iter")) > 0
    assert len(_by_name(rec, "fused.more.sync")) >= rec.counts["fused.iterations"]


def test_train_step_spans(cornell):
    from tinyraytracing_tpu_torch.diff import SceneParams, render_loss_fast
    from tinyraytracing_tpu_torch.diff.inverse import make_train_step

    scene, cam = cornell
    step, init = make_train_step(scene, cam, torch.zeros(16, 16, 3), CONFIG, SPP,
                                 loss_fn=render_loss_fast)
    state = init(SceneParams(kd=scene.kd.clone(),
                             vertex_offset=torch.zeros_like(scene.v0)))
    with spans.recording() as rec:
        step(state, master_key_data(7))
    (i, whole), = _by_name(rec, "diff.step")
    parts = {}
    for name in ("diff.loss", "diff.backward", "diff.update"):
        (_, parts[name]), = _by_name(rec, name)
        assert parts[name][3] == i and _inside(parts[name], whole)
    bounces = [s for _, s in _by_name(rec, "diff.bounce")]
    assert any(_inside(b, parts["diff.loss"]) for b in bounces)
    assert any(_inside(b, parts["diff.backward"]) for b in bounces)
    assert any(_inside(s, parts["diff.loss"]) for _, s in _by_name(rec, "diff.refit"))


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_encloses_its_kernel_on_the_card(device):
    x = torch.ones(1 << 24, device=device)
    torch.cuda.synchronize()

    def launch():
        with spans.recording() as rec:
            with spans.span("probe"):
                x.mul_(2.0)
                torch.cuda.synchronize()
        return rec

    rec, kernels = _profiled(launch, cuda=True)
    (_, probe), = _by_name(rec, "probe")
    assert len(kernels) == 1 and _inside(kernels[0], probe)


@pytest.mark.cuda
def test_recording_issues_the_same_kernels_on_the_card(cornell, device):
    """Kernel names in order between the first and the last closest-hit
    launch (the profiler can lose records at a profile's ends)."""
    scene, cam = cornell
    scene = scene.to(device)
    run = lambda: fused_queue.render_fused_queue(scene, cam, master_key_data(5),
                                                 RenderConfig(max_depth=4), SPP, lanes=LANES)

    def names(kernels):
        seq = [n for n, _, _ in sorted(kernels, key=lambda k: k[1])]
        closest = [i for i, n in enumerate(seq) if "trace_kernel<false" in n]
        return seq[closest[0]:closest[-1] + 1]

    run()
    (img0, rays0), k0 = _profiled(run, cuda=True)
    with spans.recording():
        (img1, rays1), k1 = _profiled(run, cuda=True)
    assert torch.equal(img0, img1) and torch.equal(rays0, rays1)
    assert names(k0) == names(k1)
    assert sum("trace_kernel<false" in n for n in names(k0)) > 2
