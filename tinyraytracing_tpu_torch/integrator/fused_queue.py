"""Queue-fed fused wavefront — the flagship renderer for scenes of 512 or
more triangles, ported from ``tinyraytracing_tpu/integrator/fused_queue.py``.

A global path queue feeds R lanes: a dead lane immediately starts the next
(pixel, sample) of the 32x32-tile pixel order, so occupancy stays ~100%.
Each iteration traces the bounce rays with the closest-hit trace (one
kernel launch), then this bounce's L shadow-ray groups with the occlusion
trace (or the closest-hit trace without attributes under
``shadow_test="tmin"``), and finished paths scatter-add their radiance into
the image by pixel id. Every random draw is the path-indexed threefry of
``ops/rng.py``, so the sample streams are bitwise the JAX package's.

The JAX loop body is a ``lax.while_loop``; here it is a Python ``while``
with the same stop condition and ``max_iters`` cap. The XLA pieces become
stock tensor ops: the MXU prefix sum ``torch.cumsum`` and the
broadcast-key plane sort a stable ``torch.sort`` plus gathers. The
drop-mode scatter-add into an ``n_pix + 1`` buffer is
``ops.scatter.scatter_add_rows``: on the card a kernel that adds each
pixel's finished paths in lane order, bitwise what ``index_add_`` adds on
the CPU, so the same key gives the same image on either device, run after
run (the JAX package's "Same key => same image"); the drop column is
never added into.

``render_fused_queue_chunked`` runs the same loop in chunks of iterations
sized to a wall-time target, carrying the whole lane state between them,
and can snapshot that state to disk and resume from it
(``utils/checkpoint.py``). A chunk boundary changes no arithmetic, so a
chunked or resumed render is bitwise the one-shot render, on the CPU and
on the card.

Each iteration records the spans ``queue.*`` (``utils/spans.py``): the
iteration and its refill, trace, draws, shadow and scatter stretches, and
the two host reads that wait on the device (``queue.refill.sync``,
``queue.more.sync``); it counts iterations, paths started and, under
``queue_refill="lane"``, lanes and lanes active after the refill.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import (
    CAMERA,
    INVALID,
    SPECULAR,
    TRANSMISSION,
    RenderConfig,
)
from tinyraytracing_tpu_torch.integrator.fused import (
    _FAR,
    _material_planes,
    _nee_geometry,
    _tex_kd,
    camera_rays,
    pixel_tile_order,
    sample_bsdf_planar,
)
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.ops import vec
from tinyraytracing_tpu_torch.ops.rng import bounce_uniforms
from tinyraytracing_tpu_torch.ops.scatter import scatter_add_rows
from tinyraytracing_tpu_torch.ops.trace import (
    fused_trace_planes,
    occlusion_trace_segmented,
)
from tinyraytracing_tpu_torch.utils.spans import count, span

_INF = 3.0e38
_KEY_MAX = 2**31 - 1
# the lane state's fields, in the order a snapshot stores them (a tuple
# field stores one array per component)
STATE_LAYOUT = ("it", "counter", "active", "path_id", "pix", "bounce",
                ("o", 3), ("d", 3), "ray_type", ("thr", 3), ("rad", 3),
                ("pkd", 2), "img", "ray_count")


def _morton_key(o, aabb_lo, aabb_inv, cells: int):
    """15-bit morton code of the ray origin over the scene AABB."""
    def q(k):
        x = (o[k] - aabb_lo[k]) * aabb_inv[k]
        # clamp before the int cast: truncation of in-range values equals
        # the JAX int32 cast + clip, and out-of-range values stay defined
        return torch.clamp(torch.clamp(x * cells, -1.0, float(cells))
                           .to(torch.int64), 0, cells - 1)

    def spread(b):
        b = (b | (b << 16)) & 0x30000FF
        b = (b | (b << 8)) & 0x300F00F
        b = (b | (b << 4)) & 0x30C30C3
        b = (b | (b << 2)) & 0x9249249
        return b

    return spread(q(0)) | (spread(q(1)) << 1) | (spread(q(2)) << 2)


def _queue_setup(scene, cam: Camera, key, config: RenderConfig, spp: int,
                 lanes: int, path_lo: int = 0, n_paths: int | None = None,
                 max_iters: int | None = None):
    """The queue loop of one render: returns (max_iters, init_state,
    more, body) — the initial lane state (a dict of tensors, plus the
    iteration and queue counters as ints), the loop's condition and one
    iteration. Shared by the one-shot and the chunked renderer, so both
    run the same body. An explicit ``max_iters`` replaces the default.

    ``path_lo`` and ``n_paths`` (default: all W*H*spp paths) select the
    slice [path_lo, path_lo + n_paths) of the global path queue; the lane
    count and ``max_iters`` follow ``n_paths``, and ids past the global
    path count never start (the last slice of a sharded render may reach
    past it)."""
    dev = scene.device
    f32, i64 = torch.float32, torch.int64
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    n_pix = W * H
    total_all = n_pix * spp
    if n_paths is None:
        n_paths = total_all
    R = min(lanes, n_paths)
    R = -(-R // 128) * 128
    if max_iters is None:
        max_iters = int(
            n_paths / R * (1.0 / (1.0 - config.p_rr)) * 3
        ) + config.max_depth + 9

    order = torch.as_tensor(pixel_tile_order(W, H)[0], dtype=i64, device=dev)
    start_ray = camera_rays(cam, key, dev)
    inv_spp = c(1.0 / spp)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].to(f32) for l in range(L)]
    # auto (-1) never resorts under preorder: on an H100 the every-iteration
    # morton resort that the JAX package picks for big trees left the
    # closest-hit kernel's time on grid:100000 unchanged and added ~100
    # launches per iteration (PERF.md, Findings). Under the near-first walk
    # the packets are part of the result, so auto is the JAX package's
    # rule (its fused_queue._queue_setup).
    resort_every = config.queue_resort_every
    resort_key = config.queue_resort_key
    if resort_every < 0:
        resort_every = 0
        if config.walk_order == "near" and scene.num_triangles >= 10_000:
            resort_key = "morton"
            resort_every = 1 if scene.bvh.packed.n_wide > 512 else 2
    aabb_lo = scene.bvh.nmin[0]
    aabb_inv = 1.0 / torch.clamp_min(scene.bvh.nmax[0] - scene.bvh.nmin[0],
                                     1e-6)

    def camera_ray(path_id):
        pix = order[torch.clamp(path_id // spp, 0, n_pix - 1)]
        return (*start_ray(pix, path_id), pix)

    zero = torch.zeros(R, dtype=f32, device=dev)
    one = torch.ones(R, dtype=f32, device=dev)
    up = vec.splat((0.0, 0.0, 1.0), zero)
    far3 = vec.splat((_FAR, _FAR, _FAR), zero)

    def init_state():
        """The lane state before the first iteration (JAX init_state)."""
        return dict(
            it=0, counter=0,
            active=torch.zeros(R, dtype=torch.bool, device=dev),
            path_id=torch.zeros(R, dtype=i64, device=dev),
            pix=torch.zeros(R, dtype=i64, device=dev),
            bounce=torch.zeros(R, dtype=i64, device=dev),
            o=(zero, zero, zero), d=up,
            ray_type=torch.full((R,), CAMERA, dtype=i64, device=dev),
            thr=(one, one, one), rad=(zero, zero, zero),
            pkd=(torch.zeros(R, dtype=i64, device=dev),) * 2,
            img=torch.zeros((3, n_pix + 1), dtype=f32, device=dev),  # +1: drop
            ray_count=zero,
        )

    def more(s):
        if s["it"] >= max_iters:
            return False
        if s["counter"] < n_paths:
            return True
        with span("queue.more.sync"):
            return bool(s["active"].any())

    def body(s):
        """One iteration: the lane state after it (``img`` is updated in
        place)."""
        with span("queue.iter"):
            count("queue.iterations")
            it, counter, active = s["it"], s["counter"], s["active"]
            path_id, pix, bounce = s["path_id"], s["pix"], s["bounce"]
            o, d, ray_type = s["o"], s["d"], s["ray_type"]
            thr, rad, pkd = s["thr"], s["rad"], s["pkd"]
            img, ray_count = s["img"], s["ray_count"]
            # --- optional periodic resort (config.queue_resort_every)
            if resort_every > 0 and it % resort_every == 0:
                if resort_key == "morton":
                    key_ = _morton_key(o, aabb_lo, aabb_inv, config.morton_cells)
                elif resort_key == "path_octant":
                    octant = ((d[0] < 0).to(i64) + 2 * (d[1] < 0).to(i64)
                              + 4 * (d[2] < 0).to(i64))
                    base = torch.min(torch.where(
                        active, path_id, torch.full_like(path_id, _KEY_MAX)))
                    rel = torch.clamp_min(path_id - base, 0)
                    key_ = ((rel >> 13) << 16) + (octant << 13) + (rel & 8191)
                else:
                    key_ = path_id
                key_ = torch.where(active, key_, torch.full_like(key_, _KEY_MAX))
                _, perm = torch.sort(key_, stable=True)
                p = lambda x: x[perm]
                active, path_id, pix, bounce = p(active), p(path_id), p(pix), p(bounce)
                o, d = tuple(map(p, o)), tuple(map(p, d))
                ray_type, ray_count = p(ray_type), p(ray_count)
                thr, rad, pkd = tuple(map(p, thr)), tuple(map(p, rad)), tuple(map(p, pkd))

            with span("queue.refill"):
                # --- regenerate dead lanes from the global queue (tile order)
                dead = ~active
                if config.queue_refill == "row":
                    row_dead = torch.all(dead.reshape(-1, 128), dim=1)
                    elig = row_dead[:, None].expand(R // 128, 128).reshape(-1)
                else:
                    elig = dead
                rank = torch.cumsum(elig.to(i64), 0) - 1
                new_id = counter + rank
                can = elig & (new_id < n_paths) & (path_lo + new_id < total_all)
                path_id = torch.where(can, new_id, path_id)
                norg, nd, npk, npix = camera_ray(path_lo + torch.clamp_min(path_id, 0))
                o = vec.where(can, norg, o)
                d = vec.where(can, nd, d)
                pkd = (torch.where(can, npk[0], pkd[0]), torch.where(can, npk[1], pkd[1]))
                pix = torch.where(can, npix, pix)
                ray_type = torch.where(can, CAMERA, ray_type)
                thr = vec.where(can, (one, one, one), thr)
                rad = vec.where(can, (zero, zero, zero), rad)
                bounce = torch.where(can, 0, bounce)
                active = active | can
                with span("queue.refill.sync"):
                    n_elig = int(elig.sum())
                # paths started: ids below both the slice end and the global count
                started = max(0, min(counter + n_elig, n_paths, total_all - path_lo)
                              - counter)
                count("queue.paths_started", started)
                if config.queue_refill == "lane":
                    # lanes active after the refill (under "row" the host does
                    # not know how many of the dead lanes were eligible)
                    count("queue.lanes", R)
                    count("queue.lanes_active", R - n_elig + started)
                counter = min(counter + n_elig, n_paths)

            with span("queue.trace"):
                o = vec.where(active, o, far3)

                # --- dispatch 1: bounce rays (dead lanes bound at 0: instant prune)
                t, pnx, pny, pnz, tcu, tcv, mtl, em = fused_trace_planes(
                    scene, o[0], o[1], o[2], d[0], d[1], d[2], config,
                    t_bound=torch.where(active, c(_INF), c(0.0)),
                )
                hit = mtl >= 0.0
                ray_count = ray_count + active.to(f32)

                point = vec.add(o, vec.scale(d, t))
                pn = vec.normalize((pnx, pny, pnz))

                hit_emissive = hit & (em > 0.5)
                include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
                emit = active & hit_emissive & include
                mat = _material_planes(scene, mtl)
                mrad = mat["rad"]
                rad = tuple(rad[k] + torch.where(emit, thr[k] * mrad[k], zero)
                            for k in range(3))
                shade_mask = active & hit & ~hit_emissive

                kd_val = _tex_kd(scene, mat, tcu, tcv, mat["kd"])
                ks = mat["ks"]
                ns = mat["ns"]
                wi = vec.neg(d)

            with span("queue.rng"):
                # --- per-(path, bounce) uniforms (path-indexed counter RNG)
                draws = bounce_uniforms(pkd[0], pkd[1], bounce, 4 * L + 5)

            with span("queue.shadow"):
                # --- dispatch 2: this bounce's L shadow-ray groups, immediate NEE
                pend, sh_o, sh_d = [], [], []
                for l in range(L):
                    wo, contrib, distl, okl = _nee_geometry(
                        scene, config, l, point, pn, wi, kd_val, ks, ns,
                        draws[4 * l + 0], draws[4 * l + 1],
                        draws[4 * l + 2], draws[4 * l + 3],
                        shade_mask,
                    )
                    pend.append((okl, contrib, distl))
                    sh_o.append(vec.where(okl, point, far3))
                    sh_d.append(vec.where(okl, wo, up))
                cat = torch.cat
                shadow = (
                    cat([s[0] for s in sh_o]), cat([s[1] for s in sh_o]),
                    cat([s[2] for s in sh_o]),
                    cat([s[0] for s in sh_d]), cat([s[1] for s in sh_d]),
                    cat([s[2] for s in sh_d]),
                )
                # shadow t-bound = the light distance; bound 0 parks the lane
                s_tb = cat([torch.where(okl, distl, zero) for (okl, _, distl) in pend])
                s_tg = cat([torch.where(okl, light_mtl_f[l], c(-2.0))
                            for l, (okl, _, _) in enumerate(pend)])
                occl_q = config.shadow_test == "mtl"
                if occl_q:
                    svis = occlusion_trace_segmented(scene, *shadow, s_tb, s_tg,
                                                     config, L)
                else:
                    st, _, _, _, _, _, smtl, _ = fused_trace_planes(
                        scene, *shadow, config, t_bound=s_tb, target_mtl=s_tg,
                        attrs=False,
                    )
                for l, (okl, contrib, distl) in enumerate(pend):
                    sl = slice(l * R, (l + 1) * R)
                    if occl_q:
                        vis = svis[sl] > 0.5
                    else:
                        occ = (smtl[sl] == -3.0) | (
                            (smtl[sl] >= 0.0) & (st[sl] < distl - c(1e-3))
                        )
                        vis = ~occ
                    add = okl & vis
                    rad = tuple(rad[k] + torch.where(add, thr[k] * contrib[k], zero)
                                for k in range(3))
                    ray_count = ray_count + okl.to(f32)

            with span("queue.scatter"):
                # --- Russian roulette + BSDF continuation
                u = [draws[4 * L + i] for i in range(5)]
                survive = (shade_mask & (u[0] < c(config.p_rr))
                           & (bounce + 1 < config.max_depth))
                new_dir, new_type = sample_bsdf_planar(
                    d, pn, mat["kd"], ks, ns, mat["ni"], u[1], u[2], u[3], u[4],
                )
                alive_next = survive & (new_type != INVALID)

                if config.specular_weight == "ref":
                    ds_weight = kd_val
                else:
                    ds_weight = vec.where(new_type == SPECULAR, ks, kd_val)
                weight = vec.where(new_type == TRANSMISSION, mat["tr"], ds_weight)
                inv_prr = c(1.0 / config.p_rr)
                thr = vec.where(
                    alive_next,
                    tuple(thr[k] * weight[k] * inv_prr for k in range(3)),
                    thr,
                )
                o = vec.where(alive_next, point, o)
                d = vec.where(alive_next, new_dir, up)
                ray_type = torch.where(alive_next, new_type, ray_type)
                bounce = bounce + 1

                # --- finished paths scatter into the image by pixel id
                finished = active & ~alive_next
                spix = torch.where(finished, pix, n_pix)     # n_pix = dropped
                scatter_add_rows(img, 1, spix, torch.stack(
                    [torch.where(finished, rad[k] * inv_spp, zero) for k in range(3)]),
                    keep=n_pix)
                active = alive_next
            return dict(it=it + 1, counter=counter, active=active,
                        path_id=path_id, pix=pix, bounce=bounce, o=o, d=d,
                        ray_type=ray_type, thr=thr, rad=rad, pkd=pkd, img=img,
                        ray_count=ray_count)

    return max_iters, init_state, more, body


def _result(s, n_pix: int):
    """((n_pix, 3) image in pixel order, traced-ray count) of a state."""
    return s["img"][:, :n_pix].T.contiguous(), torch.sum(s["ray_count"])


def render_fused_queue(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 262144,
                       max_iters: int | None = None, path_lo: int = 0,
                       n_paths: int | None = None):
    """Render with the queue-fed fused wavefront on ``scene``'s device.

    ``key`` is the (2,) master key words (``ops.rng.master_key_data``).
    Returns ((n_pix, 3) float32 linear image in PIXEL order, traced-ray
    count as a float32 0-d tensor). ``path_lo`` and ``n_paths`` select a
    slice of the global path queue [0, W*H*spp) (``parallel/mesh.py``
    renders one per rank); path id p is sample p % spp of pixel
    ``order[p // spp]``. Requires scene.bvh with packed leaves.
    """
    _, init_state, more, body = _queue_setup(scene, cam, key, config, spp,
                                             lanes, path_lo, n_paths,
                                             max_iters)
    s = init_state()
    while more(s):
        s = body(s)
    return _result(s, cam.width * cam.height)


def _snapshot_meta(scene, cam, key, config, spp, lanes, path_lo=0,
                   n_paths=None):
    """What a snapshot is bound to: any difference starts afresh."""
    from tinyraytracing_tpu_torch.utils import checkpoint as ckpt

    return dict(spp=spp, lanes=lanes, path_lo=path_lo,
                n_paths=n_paths if n_paths is not None else -1,
                W=cam.width, H=cam.height,
                key=np.asarray(key, dtype=np.int64), config=repr(config),
                scene_tris=scene.num_triangles,
                scene_vsum=ckpt.scene_checksum(scene),
                state_version=ckpt.QUEUE_STATE_VERSION,
                state_layout=repr(STATE_LAYOUT))


def render_fused_queue_chunked(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 262144,
    target_chunk_s: float = 8.0,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 120.0,
    resume: bool = False,
    progress=None,
    path_lo: int = 0,
    n_paths: int | None = None,
):
    """The queue render in chunks of iterations, each sized to take about
    ``target_chunk_s`` (the JAX package's ``render_fused_queue_chunked``).
    Returns what ``render_fused_queue`` returns for the same ``path_lo`` /
    ``n_paths``, bitwise.

    With ``checkpoint_path`` the lane state is saved every
    ``checkpoint_every_s`` (between chunks) and removed when the render
    ends; ``resume=True`` starts from the snapshot there, if any. The
    snapshot is bound to the key, the whole config, the scene (triangle
    count and checksum), spp, lanes, the path slice, the image size and
    the state layout:
    any difference, or a snapshot of another layout (the JAX package's
    included), starts the render afresh. ``progress(it=, counter=,
    seconds=)`` is called after every chunk.
    """
    from tinyraytracing_tpu_torch.utils import checkpoint as ckpt

    max_iters, init_state, more, body = _queue_setup(scene, cam, key, config,
                                                     spp, lanes, path_lo,
                                                     n_paths)
    s = init_state()
    meta = _snapshot_meta(scene, cam, key, config, spp, lanes, path_lo,
                          n_paths)
    if resume and checkpoint_path:
        leaves = ckpt.load_queue_state(checkpoint_path, meta)
        if leaves is not None:
            s = _unflatten(leaves, s)
    chunk = 4
    last_ckpt = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        it0 = s["it"]
        while more(s) and s["it"] < it0 + chunk:
            s = body(s)
        did = s["it"] - it0
        dt = time.perf_counter() - t0
        if progress is not None:
            progress(it=s["it"], counter=s["counter"], seconds=dt)
        if did < chunk or s["it"] >= max_iters:
            break
        # the next chunk sized to the wall-time target, growth-capped so a
        # slow first chunk (kernel builds) cannot overshoot
        per = dt / max(did, 1)
        chunk = max(1, min(chunk * 4, int(target_chunk_s / max(per, 1e-4))))
        if checkpoint_path and (time.perf_counter() - last_ckpt
                                >= checkpoint_every_s):
            ckpt.save_queue_state(checkpoint_path, _flatten(s), meta)
            last_ckpt = time.perf_counter()
    if checkpoint_path:
        ckpt.clear_queue_state(checkpoint_path)
    return _result(s, cam.width * cam.height)


def _flatten(s):
    """The state as numpy arrays in STATE_LAYOUT order."""
    out = []
    for field in STATE_LAYOUT:
        if isinstance(field, tuple):
            out += [x.cpu().numpy() for x in s[field[0]]]
        elif isinstance(s[field], int):
            out.append(np.int64(s[field]))
        else:
            out.append(s[field].cpu().numpy())
    return out


def _unflatten(leaves, like):
    """A state from ``_flatten``'s arrays, on ``like``'s devices, or
    ``like`` itself when the arrays do not fit its layout."""
    n = sum(f[1] if isinstance(f, tuple) else 1 for f in STATE_LAYOUT)
    if len(leaves) != n:
        return like
    s, k = {}, 0
    for field in STATE_LAYOUT:
        if isinstance(field, tuple):
            name, m = field
            ref = like[name]
            vals = leaves[k:k + m]
            k += m
            if any(v.shape != r.shape for v, r in zip(vals, ref)):
                return like
            s[name] = tuple(torch.from_numpy(v).to(r.device)
                            for v, r in zip(vals, ref))
            continue
        v = leaves[k]
        k += 1
        if isinstance(like[field], int):
            s[field] = int(v)
        elif v.shape != tuple(like[field].shape):
            return like
        else:
            s[field] = torch.from_numpy(v).to(like[field].device)
    return s


def render_fused_queue_image(scene, cam: Camera, key, config: RenderConfig,
                             spp: int, lanes: int = 262144) -> torch.Tensor:
    """``render_fused_queue`` reshaped to the (H, W, 3) image (the JAX
    package's ``render_fused_queue_jit``)."""
    img, _ = render_fused_queue(scene, cam, key, config, spp, lanes)
    return img.reshape(cam.height, cam.width, 3)
