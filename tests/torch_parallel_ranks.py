"""The rank side of tests/test_torch_parallel.py: four processes join a
gloo process group on the CPU and run the cases of ``CASES`` in order,
each rank saving each case's results to ``<out>/<case>.rank<r>.pt`` as
soon as the case ends (so the test of each case waits for its own
files). Imports torch and the port only: the ranks are started with the
spawn method and never load JAX."""

from __future__ import annotations

import datetime
import os
import traceback

import torch
import torch.distributed as dist

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff.inverse import SceneParams
from tinyraytracing_tpu_torch.models.procedural import cornell_box, quad_grid
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.parallel import mesh as pmesh

WORLD = 4
# a collective that waits longer than this raises in every rank
COLLECTIVE_TIMEOUT_S = 120

FUSED_CFG = dict(intersector="bvh", max_depth=3)
QUEUE_CFG = dict(intersector="bvh", max_depth=3)
LOSS_CFG = dict(intersector="bvh", max_depth=2)
LOSS_FIELDS = ("kd", "vertex_offset", "eye")
CHUNK_CFG = dict(intersector="brute", max_depth=2, tri_chunk=64)
SCAN_CFG = dict(intersector="bvh", max_depth=3)


def cornell(width, height):
    """Cornell box with its BVH, on the CPU."""
    scene, cam = cornell_box(width, height, device="cpu")
    return attach_bvh(scene, RenderConfig()), cam


def grid(width, height):
    return quad_grid(1024, width, height, device="cpu")


def serial_render_sharded(scene, cam, key, cfg, spp, n_tile, n_spp):
    """``render_sharded``'s shares run in one process and combined as its
    collectives combine them (the spp sum, the division, the tiles in
    order)."""
    n_pix = cam.width * cam.height
    tiles = []
    for t in range(n_tile):
        acc = pmesh._render_share(scene, cam, key, cfg, spp, n_tile, n_spp, t, 0)
        for s in range(1, n_spp):
            acc = acc + pmesh._render_share(scene, cam, key, cfg, spp, n_tile,
                                            n_spp, t, s)
        tiles.append(acc / torch.tensor(float(spp), device=acc.device))
    return torch.cat(tiles)[:n_pix].reshape(cam.height, cam.width, 3)


def case_mesh(r, out):
    """make_mesh's shapes, coordinates and errors, and a 1-D mesh over a
    subgroup of two ranks."""
    res = {}
    for args in ((None, None), (2, None), (None, 4), (2, 2), (4, 1)):
        m = pmesh.make_mesh(*args)
        res[args] = (m.n_tile, m.n_spp, m.rank, m.coords)
    for args in ((3, None), (2, 3), (None, 3)):
        try:
            pmesh.make_mesh(*args)
            res[args] = "no error"
        except ValueError as e:
            res[args] = f"ValueError: {e}"
    sub = dist.new_group([0, 1])
    if r < 2:
        m = pmesh.make_mesh(group=sub)
        res["sub"] = (m.n_tile, m.n_spp, m.rank,
                      float(m.all_reduce(torch.tensor(float(r + 1)))))
        m = pmesh.make_mesh(1, 2, group=sub)
        res["sub 1x2"] = (m.n_tile, m.n_spp, m.coords)
    m = pmesh.make_mesh(2, 2)
    x = torch.tensor([float(r)])
    res["reduce"] = [float(m.all_reduce(x, a)) for a in (None, "tile", "spp")]
    res["gather"] = [m.all_gather(x, a).tolist() for a in (None, "tile", "spp")]
    res["bcast"] = float(m.broadcast(x + 7))
    return res


def case_fused(r, out):
    """render_fused_sharded on meshes 4x1 and 2x2, two image sizes."""
    res = {}
    for w, h in ((32, 32), (20, 13)):
        scene, cam = cornell(w, h)
        for shape in ((4, 1), (2, 2)):
            img, rays = pmesh.render_fused_sharded(
                scene, cam, master_key_data(5), RenderConfig(**FUSED_CFG), 2,
                pmesh.make_mesh(*shape), lanes=512)
            res[(w, h, shape)] = (img, rays)
    return res


def case_queue(r, out):
    """render_queue_sharded with a path count that 4 does not divide
    into 128-lane multiples (19x11 px x 3 spp = 627 paths)."""
    scene, cam = cornell(19, 11)
    return pmesh.render_queue_sharded(scene, cam, master_key_data(12),
                                      RenderConfig(**QUEUE_CFG), 3,
                                      pmesh.make_mesh(), lanes=256)


def case_loss(r, out):
    """render_loss_fast_sharded's loss and every parameter's gradient."""
    scene, cam = cornell(16, 16)
    params = SceneParams.init_from(scene, cam, *LOSS_FIELDS)
    for t in params.tensors():
        t.requires_grad_(True)
    target = torch.zeros(16, 16, 3)
    loss = pmesh.render_loss_fast_sharded(
        params, scene, cam, master_key_data(7), target,
        RenderConfig(**LOSS_CFG), 2, pmesh.make_mesh())
    loss.backward()
    return {"loss": loss.detach(),
            **{f: getattr(params, f).grad for f in LOSS_FIELDS}}


def case_chunked(r, out):
    """The chunked driver run through, then preempted after one chunk
    and resumed, and the one-shot render_queue_sharded."""
    scene, cam = grid(16, 16)
    scene = attach_bvh(scene, RenderConfig(**CHUNK_CFG))
    cfg, key, mesh = RenderConfig(**CHUNK_CFG), master_key_data(3), pmesh.make_mesh()
    kw = dict(spp=8, mesh=mesh, lanes=128, target_chunk_s=1e-3)
    ck = os.path.join(out, "chunked.npz")
    whole = pmesh.render_queue_sharded_chunked(scene, cam, key, cfg, **kw)
    part, half = [], []
    pmesh.render_queue_sharded_chunked(
        scene, cam, key, cfg, **kw, checkpoint_path=ck, stop_after_chunks=1,
        progress=lambda **p: part.append(p["it"]))
    kept = os.path.exists(f"{ck}.rank{r}-of-{WORLD}")
    resumed = pmesh.render_queue_sharded_chunked(
        scene, cam, key, cfg, **kw, checkpoint_path=ck, resume=True,
        progress=lambda **p: half.append(p["it"]))
    one = pmesh.render_queue_sharded(scene, cam, key, cfg, 8, mesh, lanes=128)
    return dict(whole=whole, resumed=resumed, one=one, part=part, half=half,
                kept=kept, cleared=not os.path.exists(f"{ck}.rank{r}-of-{WORLD}"))


def case_scan(r, out):
    """render_sharded on a 2x2 mesh (15x13 px, spp 5: neither divides)."""
    scene, cam = cornell(15, 13)
    return pmesh.render_sharded(scene, cam, master_key_data(4),
                                RenderConfig(**SCAN_CFG),
                                pmesh.make_mesh(2, 2), spp=5)


CASES = {"mesh": case_mesh, "fused": case_fused, "queue": case_queue,
         "loss": case_loss, "chunked": case_chunked, "scan": case_scan}


def run_rank(r, init, out):
    """Rank r: join the group, run every case, save each one's results
    (or its traceback under "error")."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, world_size=WORLD, rank=r,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        for name, fn in CASES.items():
            try:
                res = fn(r, out)
            except Exception:
                res = {"error": traceback.format_exc()}
            torch.save(res, os.path.join(out, f"{name}.rank{r}.pt.tmp"))
            os.replace(os.path.join(out, f"{name}.rank{r}.pt.tmp"),
                       os.path.join(out, f"{name}.rank{r}.pt"))
    finally:
        dist.destroy_process_group()
