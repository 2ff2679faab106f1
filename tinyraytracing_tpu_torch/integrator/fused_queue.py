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
stock tensor ops: the MXU prefix sum ``torch.cumsum``, the broadcast-key
plane sort a stable ``torch.sort`` plus gathers, and the drop-mode
scatter-add an ``index_add_`` into an ``n_pix + 1`` buffer (CUDA atomics:
pixel sums may differ from a CPU run in float-add order only).
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import (
    CAMERA,
    INVALID,
    SPECULAR,
    TRANSMISSION,
    RenderConfig,
    check_ported,
)
from tinyraytracing_tpu_torch.integrator.fused import (
    _FAR,
    _material_planes,
    _nee_geometry,
    _tex_kd,
    pixel_tile_order,
    sample_bsdf_planar,
)
from tinyraytracing_tpu_torch.models.camera import Camera, camera_basis
from tinyraytracing_tpu_torch.ops import vec
from tinyraytracing_tpu_torch.ops.rng import bits_to_uniform, bounce_uniforms, path_keys
from tinyraytracing_tpu_torch.ops.trace import (
    fused_trace_planes,
    occlusion_trace_segmented,
)

_INF = 3.0e38
_KEY_MAX = 2**31 - 1


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


def render_fused_queue(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 262144,
                       max_iters: int | None = None):
    """Render with the queue-fed fused wavefront on ``scene``'s device.

    ``key`` is the (2,) master key words (``ops.rng.master_key_data``).
    Returns ((n_pix, 3) float32 linear image in PIXEL order, traced-ray
    count as a float32 0-d tensor). Requires scene.bvh with packed leaves.
    """
    check_ported(config)
    dev = scene.device
    f32, i64 = torch.float32, torch.int64
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    n_pix = W * H
    n_paths = n_pix * spp
    R = min(lanes, n_paths)
    R = -(-R // 128) * 128
    if max_iters is None:
        max_iters = int(
            n_paths / R * (1.0 / (1.0 - config.p_rr)) * 3
        ) + config.max_depth + 9

    order = torch.as_tensor(pixel_tile_order(W, H)[0], dtype=i64, device=dev)
    eye, horizontal, vertical, llc = (
        tuple(float(x) for x in v.tolist()) for v in camera_basis(cam))
    inv_spp = c(1.0 / spp)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].to(f32) for l in range(L)]
    # auto (-1) never resorts: on an H100 the every-iteration morton resort
    # that the JAX package picks for big trees left the closest-hit kernel's
    # time on grid:100000 unchanged and added ~100 launches per iteration
    # (PERF.md, Findings)
    resort_every = max(config.queue_resort_every, 0)
    resort_key = config.queue_resort_key
    aabb_lo = scene.bvh.nmin[0]
    aabb_inv = 1.0 / torch.clamp_min(scene.bvh.nmax[0] - scene.bvh.nmin[0],
                                     1e-6)

    c_w1, c_w, c_h1, c_h = c(W - 1.0), c(float(W)), c(H - 1.0), c(float(H))

    def camera_ray(path_id):
        pix = order[torch.clamp(path_id // spp, 0, n_pix - 1)]
        i = (pix // W).to(f32)
        j = (pix % W).to(f32)
        pk0, pk1 = path_keys(key, path_id)
        h1 = bits_to_uniform(pk0)
        h2 = bits_to_uniform(pk1)
        x = j / c_w1 + (h1 - 0.5) / c_w
        y = (H - i) / c_h1 + (h2 - 0.5) / c_h
        d = tuple(llc[k] + x * horizontal[k] + y * vertical[k] - eye[k]
                  for k in range(3))
        d = vec.normalize(d)
        return vec.splat(eye, d[0]), d, (pk0, pk1), pix

    zero = torch.zeros(R, dtype=f32, device=dev)
    one = torch.ones(R, dtype=f32, device=dev)
    up = vec.splat((0.0, 0.0, 1.0), zero)
    far3 = vec.splat((_FAR, _FAR, _FAR), zero)
    # lane state (the JAX init_state)
    it, counter = 0, 0
    active = torch.zeros(R, dtype=torch.bool, device=dev)
    path_id = torch.zeros(R, dtype=i64, device=dev)
    pix = torch.zeros(R, dtype=i64, device=dev)
    bounce = torch.zeros(R, dtype=i64, device=dev)
    o = (zero, zero, zero)
    d = up
    ray_type = torch.full((R,), CAMERA, dtype=i64, device=dev)
    thr = (one, one, one)
    rad = (zero, zero, zero)
    pkd = (torch.zeros(R, dtype=i64, device=dev),) * 2
    img = torch.zeros((3, n_pix + 1), dtype=f32, device=dev)  # +1: drop slot
    ray_count = zero

    while it < max_iters and (counter < n_paths or bool(active.any())):
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

        # --- regenerate dead lanes from the global queue (tile order)
        dead = ~active
        if config.queue_refill == "row":
            row_dead = torch.all(dead.reshape(-1, 128), dim=1)
            elig = row_dead[:, None].expand(R // 128, 128).reshape(-1)
        else:
            elig = dead
        rank = torch.cumsum(elig.to(i64), 0) - 1
        new_id = counter + rank
        can = elig & (new_id < n_paths)
        path_id = torch.where(can, new_id, path_id)
        norg, nd, npk, npix = camera_ray(torch.clamp_min(path_id, 0))
        o = vec.where(can, norg, o)
        d = vec.where(can, nd, d)
        pkd = (torch.where(can, npk[0], pkd[0]), torch.where(can, npk[1], pkd[1]))
        pix = torch.where(can, npix, pix)
        ray_type = torch.where(can, CAMERA, ray_type)
        thr = vec.where(can, (one, one, one), thr)
        rad = vec.where(can, (zero, zero, zero), rad)
        bounce = torch.where(can, 0, bounce)
        active = active | can
        counter = min(counter + int(elig.sum()), n_paths)

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

        # --- per-(path, bounce) uniforms (path-indexed counter RNG)
        draws = bounce_uniforms(pkd[0], pkd[1], bounce, 4 * L + 5)

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
        img.index_add_(1, spix, torch.stack(
            [torch.where(finished, rad[k] * inv_spp, zero) for k in range(3)]))
        active = alive_next
        it += 1

    return img[:, :n_pix].T.contiguous(), torch.sum(ray_count)


def render_fused_queue_image(scene, cam: Camera, key, config: RenderConfig,
                             spp: int, lanes: int = 262144) -> torch.Tensor:
    """``render_fused_queue`` reshaped to the (H, W, 3) image (the JAX
    package's ``render_fused_queue_jit``)."""
    img, _ = render_fused_queue(scene, cam, key, config, spp, lanes)
    return img.reshape(cam.height, cam.width, 3)
