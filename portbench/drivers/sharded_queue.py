"""Driver kind ``sharded_queue``: the queue renderer sharded over the
cell's devices (``parallel/mesh.py::render_queue_sharded``), one process
and one rank each (NCCL on the card, gloo on the CPU). A pass renders the
whole image at ``spp`` paths a pixel, each rank a quarter of the path
queue at ``lanes`` lanes, and sums the image over the ranks; pass p draws
from the key fold_in(master, p).

Rank 0 starts the other ranks (``core/rank.py``), waits for each at the
end, times the window and prints the result. The window runs whole passes
until ``seconds`` have passed on rank 0's clock (rank 0 tells the others
after each pass whether another follows), from the first pass's start to
the last all-reduce's end; the rate (reported as the mix's
``rate_metric``) is the traced rays of all ranks over it. Rank 0 keeps a
few summed pixels and the summed ray count of each pass; after the window
the plain reference traces every path of the pixels of a few passes (the
image check) and a sample of the paths of a few passes (the traced-ray
count, summed over the ranks).

Traffic keys: ``rate_metric``, ``spp``, ``lanes``, ``check`` {passes,
pixels_per_pass, count_passes, count_paths_per_pass}.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from core import common, harness, port, profiling, reference, rng, scenes

WARM_UNIT = 0xFFFFFFFF


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(r):
    fields = {f.name: getattr(r, f.name) for f in dataclasses.fields(r) if f.name != "t0"}
    procs = []
    for rank in range(1, r.world):
        args = dict(fields, rank=rank, device=f"cuda:{rank}" if common.is_cuda(r.device) else "cpu")
        procs.append(subprocess.Popen(
            [sys.executable, str(harness.BENCH_DIR / "core" / "rank.py"), json.dumps(args)],
            stdout=subprocess.DEVNULL))
    return procs


def run(r):
    cuda = common.is_cuda(r.device)
    if r.rank == 0:
        r = dataclasses.replace(r, port=r.port or _free_port())
        procs = _start_workers(r)
    try:
        out = _run(r, cuda)
    except BaseException:
        if r.rank == 0:
            for p in procs:
                p.kill()
        raise
    finally:
        if r.rank == 0:
            for p in procs:
                p.wait()
    if r.rank == 0 and any(p.returncode for p in procs):
        raise RuntimeError(f"a worker rank failed: {[p.returncode for p in procs]}")
    return out


def _run(r, cuda):
    dev = r.device
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{r.port}",
                            rank=r.rank, world_size=r.world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        return _render(r, cuda, dev)
    finally:
        dist.destroy_process_group()


def _render(r, cuda, dev):
    cfg, tr = r.config, r.traffic
    spp, lanes, ck = int(tr["spp"]), int(tr["lanes"]), tr["check"]
    raw = scenes.build(cfg)
    scene, cam, rc, scene_build_s = port.set_up(raw, cfg, dev)
    mesh = port.make_mesh()
    n_pix = cam.width * cam.height
    order = torch.as_tensor(common.tile_order(cam.width, cam.height), device=dev)
    master = rng.master_key(r.seed)
    render = lambda p: port.render_sharded_queue(scene, cam, rng.unit_key(master, p), rc, spp,
                                                 mesh, lanes)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def another(go: bool) -> bool:
        flag.fill_(int(go))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def keep(p, img):
        slots = _slots(r.seed, p, n_pix, ck)
        return slots, img.reshape(-1, 3)[order[slots.to(dev)]].cpu()

    img, rays = render(WARM_UNIT)
    float(rays)
    del img, rays
    pre_peak = common.peak_bytes(dev)
    common.settle(dev)
    dist.barrier()
    setup_s = r.elapsed()
    units, p = [], 0
    t0 = time.perf_counter()
    while True:
        img, rays = render(p)
        units.append((p, float(rays), *keep(p, img)))
        p += 1
        if not another(time.perf_counter() - t0 < r.seconds):
            break
    window_s = time.perf_counter() - t0
    del img, rays
    win_peak = common.peak_bytes(dev)
    obs, traced, brk = {"scene_build_s": scene_build_s}, None, None
    if r.trace:
        prof = profiling.profile_window(lambda: render(p), lambda: common.sync(dev))
        img, rays = prof["result"]
        units.append((p, float(rays), *keep(p, img)))
        del img, rays, prof["result"]
        mine = dict(wall_s=prof["wall_s"], kernels=prof["kernels"], passes=1)
        subs = [None] * r.world
        dist.all_gather_object(subs, mine)
        obs["rank_subs"] = subs
        busy = [profiling.busy_s(s["kernels"]) for s in subs]
        traced = dict(busy_s=sum(busy) / len(busy),
                      window_s=sum(s["wall_s"] for s in subs) / len(subs))
        brk = profiling.breakdown(prof["kernels"])
    peaks = torch.tensor([win_peak, max(pre_peak, win_peak, common.peak_bytes(dev))],
                         dtype=torch.float64, device=dev)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    n_win = len(units) - (1 if r.trace else 0)
    del scene, order
    if cuda:
        torch.cuda.empty_cache()
    if r.rank != 0:
        return None
    checks = _check(r, raw, cfg, master, units, spp, ck)
    return dict(attempted=n_win, failed=0, checks=checks, obs=obs, breakdown=brk,
                e2e={tr["rate_metric"]: sum(u[1] for u in units[:n_win]) / window_s,
                     "setup_s": setup_s, "peak_mem_mib": float(peaks[0]) / 2**20},
                device=common.device_entry(dev, r.chips, int(peaks[1]), traced))


def _slots(seed, p, n_pix, ck):
    """The tile-order slots of the pixels pass p keeps for the check."""
    return torch.as_tensor(common.sampler(seed, 1, p).choice(
        n_pix, ck["pixels_per_pass"], replace=False))


def control(r, n_units: int, dtype=torch.bfloat16):
    """The numbers the check compares, with the reference in ``dtype`` put
    in the program's place for ``n_units`` passes (one process: the
    reference has no shards): its values at the kept pixels, and its rays
    per path over an independent sample of each pass's paths times the
    pass's paths."""
    cfg, tr, dev = r.config, r.traffic, r.device
    spp, ck = int(tr["spp"]), tr["check"]
    raw = scenes.build(cfg)
    cam = raw["camera"]
    n_pix = cam["width"] * cam["height"]
    scn = reference.RefScene(raw, dev, dtype)
    opts = common.ref_opts(cfg)
    order = torch.as_tensor(common.tile_order(cam["width"], cam["height"]))
    master = rng.master_key(r.seed)
    units = []
    for p in range(n_units):
        key = rng.unit_key(master, p)
        slots = _slots(r.seed, p, n_pix, ck)
        pids = (slots[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference.trace_paths(scn, cam, key, pids, order[pids // spp], opts)
        ids = torch.as_tensor(common.sampler(r.seed, 3, p).choice(
            n_pix * spp, ck["count_paths_per_pass"], replace=False))
        _, rr = reference.trace_paths(scn, cam, key, ids, order[ids // spp], opts)
        units.append((p, float(rr.double().mean()) * n_pix * spp, slots,
                      rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp))
    return _check(r, raw, cfg, master, units, spp, ck)


def _check(r, raw, cfg, master, units, spp, ck):
    """The summed image at the kept pixels of a few passes against every
    one of their paths, and the traced rays per path, summed over the
    ranks, of a few passes against the reference's over a sample of their
    paths."""
    cam = raw["camera"]
    scn = reference.RefScene(raw, r.device)
    opts = common.ref_opts(cfg)
    gen = common.sampler(r.seed, 2)
    order = torch.as_tensor(common.tile_order(cam["width"], cam["height"]))
    prog, ref = [], []
    for i in gen.choice(len(units), min(ck["passes"], len(units)), replace=False):
        p, _, slots, vals = units[i]
        pids = (slots[:, None] * spp + torch.arange(spp)[None, :]).reshape(-1)
        rad, _ = reference.trace_paths(scn, cam, rng.unit_key(master, p), pids,
                                       order[pids // spp], opts)
        ref.append(rad.double().reshape(-1, spp, 3).sum(1).cpu() / spp)
        prog.append(vals)
    n_paths = cam["width"] * cam["height"] * spp
    ref_rays, prog_rays, prog_paths = [], 0.0, 0
    for i in gen.choice(len(units), min(ck["count_passes"], len(units)), replace=False):
        p, rays_p = units[i][0], units[i][1]
        ids = torch.as_tensor(gen.choice(n_paths, ck["count_paths_per_pass"], replace=False))
        _, rr = reference.trace_paths(scn, cam, rng.unit_key(master, p), ids,
                                      order[ids // spp], opts)
        ref_rays.append(rr.cpu())
        prog_rays, prog_paths = prog_rays + rays_p, prog_paths + n_paths
    return {"image_gap": common.image_gap(torch.cat(prog), torch.cat(ref)),
            "rays_gap": common.count_gap(prog_rays, prog_paths, torch.cat(ref_rays))}
