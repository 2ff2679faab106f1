"""Driver kind ``inverse_steps``: inverse rendering on the port's fast
gradient path, the loop of its ``examples/inverse_demo.py``: Adam at
``learning_rate`` on the albedos (starting at ``kd_start``) and the
per-triangle vertex offsets (starting at zero), each step one
``render_loss_fast`` against a target rendered in set-up with the true
parameters, then ``backward()`` and the update; step i draws from the key
fold_in(master, i).

Set-up builds the one training object, drives it through its first
``checked_steps`` steps (the window's own call, a new key each) and hands
it to the window, which runs steps until ``seconds`` have passed; a step
ends with a synchronisation. The window's step times go to ``obs`` for
the per-layer ``diff.step_ms_p90``; the cell's end-to-end metrics are
``peak_mem_mib`` and ``setup_s`` (PERF.md says why the step time is not
one of them). The plain reference follows the checked steps
from the same start; the check compares the first step's loss, the first
gradient's norm per leaf (the program's read from its Adam state) and
each leaf's change after the first step, and logs the later steps'
losses and changes (``gaps`` says why they are not compared).

Traffic keys: ``width``, ``height``, ``spp``, ``max_depth``,
``learning_rate``, ``kd_start``, ``checked_steps``.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from core import common, harness, port, profiling, reference, rng, scenes

TARGET_UNIT = 0xFFFFFFFF
BETAS, EPS = (0.9, 0.999), 1e-8          # torch.optim.Adam's defaults
TRACED_STEPS = 3


def run(r):
    dev, tr = r.device, r.traffic
    cfg = dict(r.config, max_depth=int(tr["max_depth"]))
    spp, n0 = int(tr["spp"]), int(tr["checked_steps"])
    raw = scenes.build(cfg, tr["width"], tr["height"])
    scene, cam, rc, scene_build_s = port.set_up(raw, cfg, dev)
    master = rng.master_key(r.seed)
    step, state, loss_of = port.inverse_problem(scene, cam, rng.unit_key(master, TARGET_UNIT), rc,
                                          spp, float(tr["learning_rate"]), float(tr["kd_start"]))
    start = {k: v.detach().clone() for k, v in port.parameters(state).items()}
    losses, grads, change = [], None, []
    for i in range(n0):
        state, loss = step(state, rng.unit_key(master, i))
        losses.append(float(loss))
        if i == 0:
            grads = {k: float(g.norm()) for k, g in port.first_gradients(state).items()}
        if i in (0, n0 - 1):
            change.append({k: float((v.detach() - start[k]).norm())
                           for k, v in port.parameters(state).items()})
    pre_peak = common.peak_bytes(dev)
    common.settle(dev)
    setup_s = r.elapsed()
    times, i = [], n0
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
    obs, traced, brk = {"scene_build_s": scene_build_s, "step_times": times}, None, None
    print(f"inverse window: steps {len(times)} window_s {window_s!r} "
          f"mean_ms {1e3 * window_s / len(times)!r} "
          f"p90_ms {harness.read_layer_metric('diff.step_ms_p90', obs)!r}", file=sys.stderr)
    if r.trace:
        obs["steps"] = _spans(loss_of, state, master, i, dev)
        prof = profiling.profile_window(
            lambda: [step(state, rng.unit_key(master, i + TRACED_STEPS + j))
                     for j in range(TRACED_STEPS)], lambda: common.sync(dev))
        obs["inverse_sub"] = dict(wall_s=prof["wall_s"], kernels=prof["kernels"])
        traced = dict(busy_s=profiling.busy_s(prof["kernels"]), window_s=prof["wall_s"])
        brk = profiling.breakdown(prof["kernels"])
        del prof
    peak = max(pre_peak, win_peak, common.peak_bytes(dev))
    del state, step, loss_of, scene
    if common.is_cuda(dev):
        torch.cuda.empty_cache()
    checks = _check(r, raw, cfg, tr, master, losses, grads, change)
    return dict(attempted=len(times), failed=0, checks=checks, obs=obs, breakdown=brk,
                e2e={"setup_s": setup_s, "peak_mem_mib": win_peak / 2**20},
                device=common.device_entry(dev, r.chips, peak, traced))


def _spans(loss_of, state, master, i0, dev):
    """Steps split by synchronisations into the loss call, ``backward()``
    and the update: [(loss s, backward s, update s)]."""
    params, opt = state
    out = []
    for j in range(TRACED_STEPS):
        key = rng.unit_key(master, i0 + j)
        opt.zero_grad(set_to_none=True)
        common.sync(dev)
        t0 = time.perf_counter()
        loss = loss_of(state, key)
        common.sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        common.sync(dev)
        t2 = time.perf_counter()
        opt.step()
        common.sync(dev)
        out.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    return out


def adam(p, g, m, v, t, lr):
    """One Adam update of ``p`` in place (torch.optim.Adam's rule)."""
    m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
    v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
    mhat = m / (1 - BETAS[0] ** t)
    vhat = v / (1 - BETAS[1] ** t)
    p.sub_(lr * mhat / (vhat.sqrt() + EPS))


def reference_steps(raw, cfg, tr, master, n_steps, dev, dtype=torch.float32,
                    block_pixels=1 << 18):
    """The reference's losses, first gradients' norms, and each leaf's
    change after the first step and after ``n_steps`` Adam steps from the
    program's start, in ``dtype``."""
    cam = raw["camera"]
    spp = int(tr["spp"])
    scn = reference.RefScene(raw, dev, dtype)
    opts = common.ref_opts(cfg)
    n_pix = cam["width"] * cam["height"]
    blocks = [torch.arange(s, min(n_pix, s + block_pixels)) for s in range(0, n_pix, block_pixels)]

    def image(key, pix, params):
        pids = (pix[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference.trace_paths(scn, cam, key, pids, pids // spp, opts, params)
        return rad.reshape(-1, spp, 3).sum(1) / spp

    tkey = rng.unit_key(master, TARGET_UNIT)
    with torch.no_grad():
        target = [image(tkey, pix, None) for pix in blocks]
        scn.set_geometry(scn.v64)
    params = {"kd": torch.full_like(scn.kd0, float(tr["kd_start"])).requires_grad_(True),
              "vertex_offset": torch.zeros((scn.T, 3), device=dev).requires_grad_(True)}
    start = {k: p.detach().clone() for k, p in params.items()}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p)) for k, p in params.items()}
    losses, grads, change = [], None, []
    for i in range(n_steps):
        key = rng.unit_key(master, i)
        loss = 0.0
        for pix, tgt in zip(blocks, target):
            part = ((image(key, pix, params) - tgt) ** 2).sum() / (3 * n_pix)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            if i == 0:
                grads = {k: float(p.grad.norm()) for k, p in params.items()}
            for k, p in params.items():
                adam(p, p.grad.float(), *state[k], i + 1, float(tr["learning_rate"]))
                p.grad = None
            if i in (0, n_steps - 1):
                change.append({k: float((p.detach() - start[k]).norm())
                               for k, p in params.items()})
    return losses, grads, change


def gaps(prog, ref) -> dict:
    """The training numbers, each leaf's gap taken against the larger of
    that leaf's and the median leaf's reference norm: the first step's
    relative loss gap; the worst leaf's gap of the first gradient's norm;
    and the worst leaf's gap of the norm of its change after the first
    step. A leaf whose reference gradient is under a thousandth of the
    median leaf's moves by round-off alone and is left out of the change.
    The later steps' losses and changes are logged, not compared: once the
    vertex offsets move the light off the ceiling's plane, ceiling points
    beside it take next-event samples whose 1/r^2 term grows without bound
    as they near it, and either side may meet one the other misses
    (PERF.md)."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    med_g = statistics.median(rg.values())
    first, ref_first = pc[0], rc[0]
    med_c = statistics.median(ref_first.values())
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    return {"loss_gap": abs(pl[0] - rl[0]) / abs(rl[0]),
            "grad_gap": max(abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg),
            "change_gap": max(abs(first[k] - ref_first[k]) / max(ref_first[k], med_c)
                              for k in moved)}


def control(r, n_units: int = 0, dtype=torch.bfloat16):
    """The training numbers with the reference in ``dtype`` put in the
    program's place for the checked steps."""
    tr = r.traffic
    cfg = dict(r.config, max_depth=int(tr["max_depth"]))
    raw = scenes.build(cfg, tr["width"], tr["height"])
    master = rng.master_key(r.seed)
    n = int(tr["checked_steps"])
    low = reference_steps(raw, cfg, tr, master, n, r.device, dtype)
    return gaps(low, reference_steps(raw, cfg, tr, master, n, r.device))


def _check(r, raw, cfg, tr, master, losses, grads, change):
    ref = reference_steps(raw, cfg, tr, master, len(losses), r.device)
    print(f"inverse: program losses {losses} first gradient norms {grads} changes {change}; "
          f"reference losses {ref[0]} first gradient norms {ref[1]} changes {ref[2]}",
          file=sys.stderr)
    return gaps((losses, grads, change), ref)
