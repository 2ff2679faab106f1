"""Driver kind ``queue_buckets``: the queue renderer on the CLI's route on
the card (``render_fused_queue_chunked`` with a path slice), one bucket of
``bucket_pixels`` pixels x ``spp`` paths at a time, the image's buckets
taken in order and wrapping round; bucket b draws from the key
fold_in(master, b).

The window runs whole buckets until ``seconds`` have passed and ends at
the end of a bucket; the rate (reported as the mix's ``rate_metric``) is
the traced rays of the window's buckets over its wall time. Each bucket keeps the values of a few of its
pixels, drawn from the seed; after the window the plain reference traces
every path of the pixels of a few buckets drawn from the seed (the image
check) and a sample of paths of a few buckets (the traced-ray count).

Traffic keys: ``rate_metric``, ``spp``, ``lanes``, ``bucket_pixels``,
``check`` {buckets, pixels_per_bucket, count_buckets, count_paths_per_bucket}.
"""

from __future__ import annotations

import time

import torch

from core import common, port, profiling, reference, rng, scenes

WARM_UNIT = 0xFFFFFFFF          # the warm-up bucket's key index


def run(r):
    dev, cfg, tr = r.device, r.config, r.traffic
    spp, lanes, bpix = int(tr["spp"]), int(tr["lanes"]), int(tr["bucket_pixels"])
    raw = scenes.build(cfg)
    scene, cam, rc, scene_build_s = port.set_up(raw, cfg, dev)
    W, H = cam.width, cam.height
    n_buckets = (W * H) // bpix
    paths = bpix * spp
    order = torch.as_tensor(common.tile_order(W, H), device=dev)
    master = rng.master_key(r.seed)
    ck = tr["check"]

    def bucket(b):
        pos = b % n_buckets
        return port.render_queue_slice(scene, cam, rng.unit_key(master, b), rc, spp, lanes,
                                       path_lo=pos * paths, n_paths=paths)

    def keep(b, img):
        """(slots, values) of a few of the bucket's pixels."""
        slots = _slots(r.seed, b, n_buckets, bpix, ck)
        return slots, img[order[slots.to(dev)]].clone()

    img, rays = port.render_queue_slice(scene, cam, rng.unit_key(master, WARM_UNIT), rc, spp,
                                        lanes, path_lo=0, n_paths=paths)
    float(rays)
    del img, rays
    pre_peak = common.peak_bytes(dev)
    common.settle(dev)
    setup_s = r.elapsed()
    units, b = [], 0
    t0 = time.perf_counter()
    while True:
        img, rays = bucket(b)
        units.append((b, float(rays), *keep(b, img)))
        b += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    del img, rays
    win_peak = common.peak_bytes(dev)
    obs, traced, brk = {"scene_build_s": scene_build_s}, None, None
    if r.trace:
        prof = profiling.profile_window(lambda: bucket(b), lambda: common.sync(dev))
        img, rays = prof["result"]
        units.append((b, float(rays), *keep(b, img)))
        del img, rays, prof["result"]
        obs["render_sub"] = dict(wall_s=prof["wall_s"], kernels=prof["kernels"],
                                 rays=units[-1][1], paths=paths, pixels=bpix,
                                 triangles=scene.num_triangles, scatter=True)
        traced = dict(busy_s=profiling.busy_s(prof["kernels"]), window_s=prof["wall_s"])
        brk = profiling.breakdown(prof["kernels"])
    peak = max(pre_peak, win_peak, common.peak_bytes(dev))
    n_win = len(units) - (1 if r.trace else 0)
    rays_win = sum(u[1] for u in units[:n_win])
    del scene, order
    if common.is_cuda(dev):
        torch.cuda.empty_cache()
    checks = _check(r, raw, cfg, master, units, spp, paths, n_buckets, bpix, ck)
    return dict(attempted=n_win, failed=0, checks=checks, obs=obs, breakdown=brk,
                e2e={tr["rate_metric"]: rays_win / window_s, "setup_s": setup_s,
                     "peak_mem_mib": win_peak / 2**20},
                device=common.device_entry(dev, r.chips, peak, traced))


def _slots(seed, b, n_buckets, bpix, ck):
    """The tile-order slots of the pixels bucket b keeps for the check."""
    return (b % n_buckets) * bpix + torch.as_tensor(
        common.sampler(seed, 1, b).choice(bpix, ck["pixels_per_bucket"], replace=False))


def control(r, n_units: int, dtype=torch.bfloat16):
    """The numbers the check compares, with the reference in ``dtype`` put
    in the program's place for ``n_units`` buckets: its values at the kept
    pixels, and its rays per path over an independent sample of each
    bucket's paths times the bucket's paths."""
    cfg, tr, dev = r.config, r.traffic, r.device
    spp, bpix, ck = int(tr["spp"]), int(tr["bucket_pixels"]), tr["check"]
    raw = scenes.build(cfg)
    cam = raw["camera"]
    n_buckets = cam["width"] * cam["height"] // bpix
    paths = bpix * spp
    scn = reference.RefScene(raw, dev, dtype)
    opts = common.ref_opts(cfg)
    order = torch.as_tensor(common.tile_order(cam["width"], cam["height"]))
    master = rng.master_key(r.seed)
    units = []
    for b in range(n_units):
        key = rng.unit_key(master, b)
        slots = _slots(r.seed, b, n_buckets, bpix, ck)
        pids = (slots[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference.trace_paths(scn, cam, key, pids, order[pids // spp], opts)
        ids = (b % n_buckets) * paths + torch.as_tensor(common.sampler(r.seed, 3, b).choice(
            paths, ck["count_paths_per_bucket"], replace=False))
        _, rr = reference.trace_paths(scn, cam, key, ids, order[ids // spp], opts)
        units.append((b, float(rr.double().mean()) * paths, slots,
                      rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp))
    return _check(r, raw, cfg, master, units, spp, paths, n_buckets, bpix, ck)


def _check(r, raw, cfg, master, units, spp, paths, n_buckets, bpix, ck):
    """The image gap over the kept pixels of a few buckets and the traced
    rays per path against the reference's."""
    dev = r.device
    scn = reference.RefScene(raw, dev)
    opts = common.ref_opts(cfg)
    gen = common.sampler(r.seed, 2)
    order = torch.as_tensor(common.tile_order(raw["camera"]["width"], raw["camera"]["height"]))
    prog, ref = [], []
    for i in gen.choice(len(units), min(ck["buckets"], len(units)), replace=False):
        b, _, slots, vals = units[i]
        pids = (slots[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference.trace_paths(scn, raw["camera"], rng.unit_key(master, b), pids,
                                       order[pids // spp], opts)
        ref.append(rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp)
        prog.append(vals.cpu())
    ref_rays, prog_rays, prog_paths = [], 0.0, 0
    for i in gen.choice(len(units), min(ck["count_buckets"], len(units)), replace=False):
        b, rays_b = units[i][0], units[i][1]
        local = torch.as_tensor(gen.choice(paths, ck["count_paths_per_bucket"], replace=False))
        pids = (b % n_buckets) * paths + local
        _, rr = reference.trace_paths(scn, raw["camera"], rng.unit_key(master, b), pids,
                                      order[pids // spp], opts)
        ref_rays.append(rr.cpu())
        prog_rays, prog_paths = prog_rays + rays_b, prog_paths + paths
    return {"image_gap": common.image_gap(torch.cat(prog), torch.cat(ref)),
            "rays_gap": common.count_gap(prog_rays, prog_paths, torch.cat(ref_rays))}
