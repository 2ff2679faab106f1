"""Driver kind ``progressive``: progressive passes of the renderer that
``pick_renderer`` chooses for a scene of under 512 triangles, the
pixel-persistent ``render_fused``, over the whole image; pass p draws
from the key fold_in(master, p) and is summed into one image.

The window runs whole passes until ``seconds`` have passed and ends at
the end of a pass; the rate (reported as the mix's ``rate_metric``) is
the traced rays of its passes over its wall time. After the window the plain reference traces every path of
every pass at a sample of pixels drawn from the seed, against the summed
image there (the image check), and a sample of the paths of a few passes
(the traced-ray count).

Traffic keys: ``rate_metric``, ``width``, ``height``, ``spp``, ``lanes``,
``check`` {pixels, count_passes, count_paths_per_pass}.
"""

from __future__ import annotations

import time

import torch

from core import common, port, profiling, reference, rng, scenes

WARM_UNIT = 0xFFFFFFFF


def run(r):
    dev, cfg, tr = r.device, r.config, r.traffic
    spp, lanes = int(tr["spp"]), int(tr["lanes"])
    raw = scenes.build(cfg, tr["width"], tr["height"])
    scene, cam, rc, scene_build_s = port.set_up(raw, cfg, dev)
    n_pix = cam.width * cam.height
    master = rng.master_key(r.seed)
    ck = tr["check"]
    slots = _slots(r.seed, n_pix, ck)
    render = lambda p: port.render_persistent(scene, cam, rng.unit_key(master, p), rc, spp, lanes)

    img, rays = render(WARM_UNIT)
    float(rays)
    acc = torch.zeros_like(img)
    del img, rays
    pre_peak = common.peak_bytes(dev)
    common.settle(dev)
    setup_s = r.elapsed()
    pass_rays, p = [], 0
    t0 = time.perf_counter()
    while True:
        img, rays = render(p)
        acc += img
        pass_rays.append(float(rays))
        p += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    del img, rays
    win_peak = common.peak_bytes(dev)
    obs, traced, brk = {"scene_build_s": scene_build_s}, None, None
    if r.trace:
        prof = profiling.profile_window(lambda: render(p), lambda: common.sync(dev))
        img, rays = prof["result"]
        acc += img
        pass_rays.append(float(rays))
        del img, rays, prof["result"]
        obs["render_sub"] = dict(wall_s=prof["wall_s"], kernels=prof["kernels"],
                                 rays=pass_rays[-1], paths=n_pix * spp, pixels=n_pix,
                                 triangles=scene.num_triangles, scatter=False)
        traced = dict(busy_s=profiling.busy_s(prof["kernels"]), window_s=prof["wall_s"])
        brk = profiling.breakdown(prof["kernels"])
    kept = acc[slots.to(dev)].cpu()
    peak = max(pre_peak, win_peak, common.peak_bytes(dev))
    n_win = len(pass_rays) - (1 if r.trace else 0)
    del scene, acc
    if common.is_cuda(dev):
        torch.cuda.empty_cache()
    checks = _check(r, raw, cfg, master, kept, slots, pass_rays, spp, ck)
    return dict(attempted=n_win, failed=0, checks=checks, obs=obs, breakdown=brk,
                e2e={tr["rate_metric"]: sum(pass_rays[:n_win]) / window_s, "setup_s": setup_s,
                     "peak_mem_mib": win_peak / 2**20},
                device=common.device_entry(dev, r.chips, peak, traced))


def _slots(seed, n_pix, ck):
    """The tile-order slots of the pixels the check compares."""
    return torch.as_tensor(common.sampler(seed, 1).choice(n_pix, ck["pixels"], replace=False))


def control(r, n_units: int, dtype=torch.bfloat16):
    """The numbers the check compares, with the reference in ``dtype`` put
    in the program's place for ``n_units`` passes: its summed values at the
    sampled pixels, and its rays per path over an independent sample of
    each pass's paths times the pass's paths."""
    cfg, tr, dev = r.config, r.traffic, r.device
    spp, ck = int(tr["spp"]), tr["check"]
    raw = scenes.build(cfg, tr["width"], tr["height"])
    cam = raw["camera"]
    n_pix = cam["width"] * cam["height"]
    scn = reference.RefScene(raw, dev, dtype)
    opts = common.ref_opts(cfg)
    master = rng.master_key(r.seed)
    slots = _slots(r.seed, n_pix, ck)
    pix = torch.as_tensor(common.tile_order(cam["width"], cam["height"]))[slots]
    pids = (pix[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
    kept = torch.zeros((len(slots), 3), dtype=torch.float64)
    pass_rays = []
    for p in range(n_units):
        key = rng.unit_key(master, p)
        rad, _ = reference.trace_paths(scn, cam, key, pids, pids // spp, opts)
        kept += rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp
        ids = torch.as_tensor(common.sampler(r.seed, 3, p).choice(
            n_pix * spp, ck["count_paths_per_pass"], replace=False))
        _, rr = reference.trace_paths(scn, cam, key, ids, ids // spp, opts)
        pass_rays.append(float(rr.double().mean()) * n_pix * spp)
    return _check(r, raw, cfg, master, kept, slots, pass_rays, spp, ck)


def _check(r, raw, cfg, master, kept, slots, pass_rays, spp, ck):
    """The summed image at the sampled pixels against the reference's sum
    over every pass, and the traced rays per path of a few passes."""
    cam = raw["camera"]
    scn = reference.RefScene(raw, r.device)
    opts = common.ref_opts(cfg)
    pix = torch.as_tensor(common.tile_order(cam["width"], cam["height"]))[slots]
    pids = (pix[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
    ref = torch.zeros((len(slots), 3), dtype=torch.float64)
    for p in range(len(pass_rays)):
        rad, _ = reference.trace_paths(scn, cam, rng.unit_key(master, p), pids,
                                       pids // spp, opts)
        ref += rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp
    gen = common.sampler(r.seed, 2)
    n_paths = cam["width"] * cam["height"] * spp
    ref_rays, prog_rays = [], 0.0
    count = gen.choice(len(pass_rays), min(ck["count_passes"], len(pass_rays)), replace=False)
    for p in count:
        ids = torch.as_tensor(gen.choice(n_paths, ck["count_paths_per_pass"], replace=False))
        _, rr = reference.trace_paths(scn, cam, rng.unit_key(master, int(p)), ids,
                                      ids // spp, opts)
        ref_rays.append(rr.cpu())
        prog_rays += pass_rays[p]
    return {"image_gap": common.image_gap(kept, ref),
            "rays_gap": common.count_gap(prog_rays, n_paths * len(count), torch.cat(ref_rays))}
