"""Driver kind ``mesh_inverse_steps``: inverse rendering of a mesh's shared
vertex positions on the port's fast gradient path (the mesh refinement of
Nicolet et al., with plain Adam): Adam at ``learning_rate`` on the albedos
(from ``kd_start``) and the mesh's shared vertex offsets (from a smooth
y-perturbation of amplitude ``offset_amplitude``, a sum of
``offset_bumps`` Gaussian bumps drawn from the seed), each step one
``render_loss_fast`` against a target rendered in set-up with the loaded
albedos and the unmoved mesh, then ``backward()`` and the update; step i
draws from the key fold_in(master, i).

Set-up builds the training object and takes its first ``checked_steps``
steps; the window runs steps until ``seconds`` have passed, each ended by
a synchronisation, inside the program's span recording, whose device
count ``diff.rays`` (the forward's closest-hit and shadow rays, summed on
the device and read once, after the window) gives ``rays_per_s`` over the
window's wall. ``peak_mem_mib`` and ``setup_s`` are the other end-to-end
metrics. A traced run times steps split by synchronisations into the loss
call, ``backward()`` and the update (``obs["steps"]``, as
``inverse_steps`` does), then profiles ``TRACED_STEPS`` more steps under
the recording, for the per-layer metrics (``obs["mesh_sub"]``: the device
time inside ``diff.mesh``, ``diff.refit`` and ``diff.mesh.scatter``, the
trace kernels' and the vertex scatter's).

The check compares the first step with ``core/reference_mesh.py`` from the
same start: ``inverse_steps.gaps``' loss, gradient-norm and change gaps,
``vertex_grad_gap``, the relative L2 norm of the difference of the
first vertex gradients, which also sees cotangents summed into the wrong
vertices, and ``vertex_change_gap``, the relative gap of the vertex
offsets' change after the first step.

Traffic keys: ``width``, ``height``, ``spp``, ``max_depth``,
``learning_rate``, ``kd_start``, ``checked_steps``, ``offset_amplitude``,
``offset_bumps``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from core import common, harness, port_mesh, profiling, reference_mesh, rng, scenes, span_profile

inverse_steps = harness.driver("inverse_steps")

TARGET_UNIT = inverse_steps.TARGET_UNIT
TRACED_STEPS = 3
OFFSET_TAG = 0x0FF5E7
SPANS = ("diff.mesh", "diff.refit", "diff.mesh.scatter")
VERTEX_LEAF = "shared_vertex_offset"


def start_offsets(raw: dict, seed: int, tr: dict) -> torch.Tensor:
    """The shared vertex offsets' start (V, 3) float32: y only, amplitude
    times (2 s - 1) for a smooth field s in [0, 1] of the vertices' x, z
    drawn from the seed."""
    pos = np.asarray(raw["vertex_positions"], np.float64)
    s = scenes.kind("height_grid").field(pos[:, 0], pos[:, 2], common.sampler(seed, OFFSET_TAG),
                                         int(tr["offset_bumps"]))
    out = np.zeros_like(pos)
    out[:, 1] = float(tr["offset_amplitude"]) * (2.0 * s - 1.0)
    return torch.as_tensor(out, dtype=torch.float32)


def run(r):
    port_mesh.require_mesh_leaf()
    dev, tr = r.device, r.traffic
    cfg = dict(r.config, max_depth=int(tr["max_depth"]))
    spp, n0 = int(tr["spp"]), int(tr["checked_steps"])
    raw = scenes.build(cfg, tr["width"], tr["height"])
    scene, cam, rc, scene_build_s = port_mesh.set_up(raw, cfg, dev)
    master = rng.master_key(r.seed)
    offset0 = start_offsets(raw, r.seed, tr)
    step, state, loss_of = port_mesh.inverse_problem(
        scene, cam, rng.unit_key(master, TARGET_UNIT), rc, spp, float(tr["learning_rate"]),
        float(tr["kd_start"]), offset0)
    start = {k: v.detach().clone() for k, v in port_mesh.parameters(state).items()}
    losses, grads, change, vgrad = [], None, [], None
    for i in range(n0):
        state, loss = step(state, rng.unit_key(master, i))
        losses.append(float(loss))
        if i == 0:
            g = port_mesh.gradients(state)
            grads = {k: float(x.norm()) for k, x in g.items()}
            vgrad = g[VERTEX_LEAF].cpu()
        if i in (0, n0 - 1):
            change.append({k: float((v.detach() - start[k]).norm())
                           for k, v in port_mesh.parameters(state).items()})
    pre_peak = common.peak_bytes(dev)
    common.settle(dev)
    setup_s = r.elapsed()
    times, i = [], n0
    with port_mesh.recording() as rec:
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            state, loss = step(state, rng.unit_key(master, i))
            common.sync(dev)
            times.append(time.perf_counter() - s)
            i += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        window_s = time.perf_counter() - t0
    win_peak = common.peak_bytes(dev)
    rays = rec.counts.get("diff.rays", 0)
    obs, traced, brk = {"scene_build_s": scene_build_s, "step_times": times}, None, None
    print(f"mesh inverse window: steps {len(times)} window_s {window_s!r} rays {rays} "
          f"mean_ms {1e3 * window_s / len(times)!r} "
          f"p90_ms {harness.read_layer_metric('diff.step_ms_p90', obs)!r}", file=sys.stderr)
    if r.trace:
        obs["steps"] = inverse_steps._spans(loss_of, state, master, i, dev)
        i += inverse_steps.TRACED_STEPS
        prof = span_profile.profile_spans(
            lambda: [step(state, rng.unit_key(master, i + j)) for j in range(TRACED_STEPS)],
            lambda: common.sync(dev), port_mesh.recording)
        obs["mesh_sub"] = _traced(prof, scene)
        traced = dict(busy_s=profiling.busy_s(prof["kernels"]), window_s=prof["wall_s"])
        brk = profiling.breakdown(prof["kernels"])
        del prof
    peak = max(pre_peak, win_peak, common.peak_bytes(dev))
    del state, step, loss_of, scene
    if common.is_cuda(dev):
        torch.cuda.empty_cache()
    checks = _check(r, raw, cfg, tr, master, offset0, losses, grads, change, vgrad)
    return dict(attempted=len(times), failed=0, checks=checks, obs=obs, breakdown=brk,
                e2e={"setup_s": setup_s, "peak_mem_mib": win_peak / 2**20,
                     "rays_per_s": rays / window_s},
                device=common.device_entry(dev, r.chips, peak, traced))


def _traced(prof, scene) -> dict:
    """What the per-layer metrics read of the traced steps: the wall and
    the kernels (for the idle share), the device seconds inside each span
    of ``SPANS``, the trace kernels' seconds and launches, and the work:
    the forward's rays, the triangles and the shared vertices."""
    kernels = prof["kernels"]
    by_span = span_profile.device_s_by_span(kernels, prof["launched"], prof["spans"], SPANS)
    trace = [(s, e) for n, s, e in kernels if "trace_kernel" in n]
    return dict(wall_s=prof["wall_s"], kernels=kernels, steps=TRACED_STEPS,
                span_s=by_span if any(by_span.values()) else {},
                trace_s=sum(e - s for s, e in trace), trace_launches=len(trace),
                rays=prof["counts"].get("diff.rays", 0),
                triangles=scene.num_triangles, vertices=port_mesh.num_vertices(scene))


def reference_steps(raw, cfg, tr, master, offset0, n_steps, dev, dtype=torch.float32,
                    block_pixels=1 << 18):
    """The reference's losses, first gradients' norms, each leaf's change
    after the first step and after ``n_steps`` Adam steps, and the first
    vertex gradient, from the program's start, in ``dtype``."""
    cam = raw["camera"]
    spp = int(tr["spp"])
    scn = reference_mesh.MeshRefScene(raw, dev, dtype)
    opts = common.ref_opts(cfg)
    n_pix = cam["width"] * cam["height"]
    blocks = [torch.arange(s, min(n_pix, s + block_pixels)) for s in range(0, n_pix, block_pixels)]

    def image(key, pix, kd):
        pids = (pix[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference_mesh.trace_paths(scn, cam, key, pids, pids // spp, opts, kd)
        return rad.reshape(-1, spp, 3).sum(1) / spp

    tkey = rng.unit_key(master, TARGET_UNIT)
    with torch.no_grad():
        scn.move(None)
        target = [image(tkey, pix, None) for pix in blocks]
    params = {"kd": torch.full_like(scn.kd0, float(tr["kd_start"])).requires_grad_(True),
              VERTEX_LEAF: offset0.to(dev).clone().requires_grad_(True)}
    start = {k: p.detach().clone() for k, p in params.items()}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p)) for k, p in params.items()}
    losses, grads, change, vgrad = [], None, [], None
    for i in range(n_steps):
        key = rng.unit_key(master, i)
        loss = 0.0
        for pix, tgt in zip(blocks, target):
            scn.move(params[VERTEX_LEAF])
            part = ((image(key, pix, params["kd"]) - tgt) ** 2).sum() / (3 * n_pix)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            if i == 0:
                grads = {k: float(p.grad.norm()) for k, p in params.items()}
                vgrad = params[VERTEX_LEAF].grad.float().cpu()
            for k, p in params.items():
                inverse_steps.adam(p, p.grad.float(), *state[k], i + 1,
                                   float(tr["learning_rate"]))
                p.grad = None
            if i in (0, n_steps - 1):
                change.append({k: float((p.detach() - start[k]).norm())
                               for k, p in params.items()})
    return losses, grads, change, vgrad


def gaps(prog, ref) -> dict:
    """``inverse_steps.gaps`` of the training numbers; ``vertex_grad_gap``:
    |g - g_ref| / |g_ref| of the first vertex gradients (L2 over every
    vertex and axis); and ``vertex_change_gap``: |c - c_ref| / c_ref of the
    norms of the vertex offsets' change after the first step, compared
    always, since ``change_gap`` leaves out a leaf whose gradient is under
    a thousandth of the median leaf's, where this cell's vertex leaf sits."""
    out = inverse_steps.gaps(prog[:3], ref[:3])
    g, g_ref = prog[3].double(), ref[3].double()
    out["vertex_grad_gap"] = float((g - g_ref).norm() / g_ref.norm().clamp_min(1e-300))
    c, c_ref = prog[2][0][VERTEX_LEAF], ref[2][0][VERTEX_LEAF]
    out["vertex_change_gap"] = abs(c - c_ref) / max(c_ref, 1e-300)
    return out


def control(r, n_units: int = 0, dtype=torch.bfloat16):
    """The check's numbers with the reference in ``dtype`` put in the
    program's place for the checked steps."""
    tr = r.traffic
    cfg = dict(r.config, max_depth=int(tr["max_depth"]))
    raw = scenes.build(cfg, tr["width"], tr["height"])
    master = rng.master_key(r.seed)
    offset0 = start_offsets(raw, r.seed, tr)
    n = int(tr["checked_steps"])
    low = reference_steps(raw, cfg, tr, master, offset0, n, r.device, dtype)
    return gaps(low, reference_steps(raw, cfg, tr, master, offset0, n, r.device))


def _check(r, raw, cfg, tr, master, offset0, losses, grads, change, vgrad):
    t = time.perf_counter()
    ref = reference_steps(raw, cfg, tr, master, offset0, len(losses), r.device)
    out = gaps((losses, grads, change, vgrad), ref)
    print(f"mesh inverse: program losses {losses} first gradient norms {grads} changes {change}; "
          f"reference losses {ref[0]} first gradient norms {ref[1]} changes {ref[2]}; "
          f"check_s {time.perf_counter() - t!r}", file=sys.stderr)
    return out
