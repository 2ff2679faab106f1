"""The regeneration oracles, the counterpart of
``tinyraytracing_tpu/integrator/regen.py``: two schedulings of the scan
renderer's estimator (``integrator/wavefront.bounce``: the same NEE,
Russian roulette and BSDF math per bounce) that share no code with the
fused renderers, kept as statistical cross-checks of them.

- ``render_regen``: a pool of R lanes over the global queue of
  (pixel, sample) paths; a lane whose path ends takes the next path id
  (its rank among the dead lanes past a counter clamped to the queue's
  length). Finished paths add their radiance into the image by pixel.
- ``render_persistent``: lane l of epoch e serves pixel e*R + l and runs
  its ``spp`` paths back to back into a lane-local accumulator, written
  densely into the image per epoch (no scatter).

Both return (image, traced rays): the rays alive at each closest-hit
trace plus L shadow rays per shading lane, summed as float32 as in the
JAX package. The streams are the JAX package's: a path's camera jitter
is the two words of ``fold_in(key, path_id)`` (``>> 8`` over 2^24), and
bounce iteration it draws from ``fold_in(fold_in(key, 2), it)`` (render
_persistent: ``e * max_iters + it``), with ``max_iters`` from the same
float formula, so the image depends on it.

The loop runs on the host: its condition (a lane active, or paths left)
is read back from the device every ``CHECK_EVERY`` iterations. An
iteration after the last path ended changes nothing (no lane is active
or regenerated, and every count adds 0), so the image and ray count are
those of testing every iteration. In ``render_regen`` only finished
lanes add into the image: the others point at rows of their own past
it, which are dropped (``ops.scatter.scatter_add_rows`` with ``keep``
skips them). A pixel's finished paths add in lane order, on the card as
on the CPU, so the image repeats bitwise from run to run.
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import CAMERA, RenderConfig
from tinyraytracing_tpu_torch.integrator.wavefront import bounce as bounce_wave
from tinyraytracing_tpu_torch.models.camera import Camera, camera_basis
from tinyraytracing_tpu_torch.ops.linalg import normalize
from tinyraytracing_tpu_torch.ops.rng import bits_to_uniform, fold_in, fold_in_planes
from tinyraytracing_tpu_torch.ops.scatter import scatter_add_rows

# iterations between two reads of the loop condition from the device
CHECK_EVERY = 4


def _camera_rays(cam: Camera, key, spp: int, dev):
    """path ids (R,) -> (org, dir) (R, 3), jittered from the bits of
    ``fold_in(key, path_id)``."""
    f32 = torch.float32
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    eye, horizontal, vertical, llc = (v.to(dev) for v in camera_basis(cam))
    c_w1, c_w, c_h1, c_h = c(W - 1.0), c(float(W)), c(H - 1.0), c(float(H))

    def ray(path_id):
        pix = path_id // spp
        i = (pix // W).to(f32)
        j = (pix % W).to(f32)
        b0, b1 = fold_in_planes(key, path_id)
        x = j / c_w1 + (bits_to_uniform(b0) - 0.5) / c_w
        y = (H - i) / c_h1 + (bits_to_uniform(b1) - 0.5) / c_h
        d = (llc[None, :] + x[:, None] * horizontal[None, :]
             + y[:, None] * vertical[None, :] - eye[None, :])
        d = normalize(d)
        return eye.expand(d.shape), d

    return ray


def _lanes(R, dev):
    """Initial lane state: (active, bounce, org, dir, ray type, throughput,
    radiance)."""
    f32 = torch.float32
    return (torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros(R, dtype=torch.int64, device=dev),
            torch.zeros((R, 3), dtype=f32, device=dev),
            torch.tensor([[0.0, 0.0, 1.0]], dtype=f32, device=dev).repeat(R, 1),
            torch.full((R,), CAMERA, dtype=torch.int32, device=dev),
            torch.ones((R, 3), dtype=f32, device=dev),
            torch.zeros((R, 3), dtype=f32, device=dev))


def _restart(can, ray, path_id, bounce, org, d, ray_type, throughput, radiance):
    """Start a camera path on the lanes ``can``."""
    norg, nd = ray(path_id)
    c = can[:, None]
    return (torch.where(can, 0, bounce), torch.where(c, norg, org),
            torch.where(c, nd, d), torch.where(can, CAMERA, ray_type),
            torch.where(c, 1.0, throughput), torch.where(c, 0.0, radiance))


def render_regen(scene, cam: Camera, key, config: RenderConfig, spp: int,
                 lanes: int = 131072, max_iters: int | None = None,
                 stats: dict | None = None):
    """Render (H, W, 3) with the regeneration wavefront on the scene's
    device; returns (image, traced rays as float32 0-d). ``key``: (k0, k1)
    key words. ``lanes``: the path pool; ``max_iters`` bounds the loop
    (default from the expected path length, 3x slack). With ``stats`` (a
    dict), records "iterations" and the exact int "rays"."""
    dev = scene.device
    f32, i64 = torch.float32, torch.int64
    W, H = cam.width, cam.height
    n_pix = W * H
    total = n_pix * spp
    R = min(lanes, total)
    if max_iters is None:
        max_iters = int(total / R * (1.0 / (1.0 - config.p_rr)) * 3) + config.max_depth + 8
    ray = _camera_rays(cam, key, spp, dev)
    inv_spp = torch.tensor(1.0 / spp, dtype=f32, device=dev)
    L = scene.light_mtl.shape[0]
    k_bounce = fold_in(key, 2)
    lane = torch.arange(R, dtype=i64, device=dev)

    active, bounce, org, d, ray_type, throughput, radiance = _lanes(R, dev)
    path_id = torch.zeros(R, dtype=i64, device=dev)
    counter = torch.zeros((), dtype=i64, device=dev)
    img = torch.zeros((n_pix + R, 3), dtype=f32, device=dev)
    rays_traced = torch.zeros((), dtype=f32, device=dev)
    exact = torch.zeros((), dtype=i64, device=dev)
    it = 0
    while it < max_iters:
        if it % CHECK_EVERY == 0 and not bool(active.any() | (counter < total)):
            break
        # --- regenerate dead lanes from the queue
        dead = ~active
        rank = torch.cumsum(dead.to(i64), 0) - 1
        new_id = counter + rank
        can = dead & (new_id < total)
        path_id = torch.where(can, new_id, path_id)
        bounce, org, d, ray_type, throughput, radiance = _restart(
            can, ray, path_id, bounce, org, d, ray_type, throughput, radiance)
        active = active | can
        counter = torch.clamp_max(counter + dead.sum(), total)

        # --- one bounce (wavefront.trace's math)
        radiance, throughput, org, d, ray_type, alive_next, shade_mask = bounce_wave(
            scene, config, org, d, ray_type, throughput, radiance, active,
            fold_in(k_bounce, it), last=bounce + 1 >= config.max_depth)
        bounce = bounce + 1

        # --- finished paths add into their pixels
        finished = active & ~alive_next
        rows = torch.where(finished, path_id // spp, n_pix + lane)
        scatter_add_rows(img, 0, rows, radiance * inv_spp, keep=n_pix)
        n = active.sum() + L * shade_mask.sum()
        rays_traced = rays_traced + n.to(f32)
        if stats is not None:
            exact = exact + n
        active = alive_next
        it += 1
    if stats is not None:
        stats.update(iterations=it, rays=int(exact))
    return img[:n_pix].reshape(H, W, 3), rays_traced


def render_regen_stats(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 131072):
    """(image, traced rays): the JAX package's ``render_regen_stats_jit``."""
    return render_regen(scene, cam, key, config, spp, lanes)


def render_regen_image(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 131072) -> torch.Tensor:
    """The image alone: the JAX package's ``render_regen_jit``."""
    return render_regen(scene, cam, key, config, spp, lanes)[0]


def render_persistent(scene, cam: Camera, key, config: RenderConfig, spp: int,
                      lanes: int = 262144, max_iters: int | None = None,
                      stats: dict | None = None):
    """Render (H, W, 3) with the pixel-persistent wavefront on the scene's
    device; returns (image, traced rays as float32 0-d). Lane l of epoch e
    serves pixel e*R + l; each epoch's accumulators are one dense write
    into an image padded to n_epochs * R rows. ``max_iters`` bounds each
    epoch's loop. ``stats`` as ``render_regen``'s."""
    dev = scene.device
    f32, i64 = torch.float32, torch.int64
    W, H = cam.width, cam.height
    n_pix = W * H
    R = min(lanes, n_pix)
    n_epochs = -(-n_pix // R)
    if max_iters is None:
        max_iters = int(spp * (1.0 / (1.0 - config.p_rr)) * 3) + config.max_depth + 8
    ray = _camera_rays(cam, key, spp, dev)
    inv_spp = torch.tensor(1.0 / spp, dtype=f32, device=dev)
    L = scene.light_mtl.shape[0]
    k_bounce = fold_in(key, 2)
    lane = torch.arange(R, dtype=i64, device=dev)
    img = torch.zeros((n_epochs * R, 3), dtype=f32, device=dev)
    rays_traced = torch.zeros((), dtype=f32, device=dev)
    exact = torch.zeros((), dtype=i64, device=dev)
    iterations = 0

    for e in range(n_epochs):
        pixel = e * R + lane
        in_range = pixel < n_pix
        active, bounce, org, d, ray_type, throughput, radiance = _lanes(R, dev)
        samples_done = torch.zeros(R, dtype=i64, device=dev)
        accum = torch.zeros((R, 3), dtype=f32, device=dev)
        it = 0
        while it < max_iters:
            if it % CHECK_EVERY == 0 and not bool(
                    (active | (in_range & (samples_done < spp))).any()):
                break
            # start the next sample on lanes whose path has ended
            can = ~active & in_range & (samples_done < spp)
            path_id = torch.where(can, pixel * spp + samples_done, 0)
            bounce, org, d, ray_type, throughput, radiance = _restart(
                can, ray, path_id, bounce, org, d, ray_type, throughput,
                radiance)
            samples_done = samples_done + can.to(i64)
            active = active | can

            radiance, throughput, org, d, ray_type, alive_next, shade_mask = bounce_wave(
                scene, config, org, d, ray_type, throughput, radiance, active,
                fold_in(k_bounce, e * max_iters + it),
                last=bounce + 1 >= config.max_depth)
            bounce = bounce + 1

            finished = active & ~alive_next
            accum = accum + torch.where(finished[:, None], radiance * inv_spp, 0.0)
            n = active.sum() + L * shade_mask.sum()
            rays_traced = rays_traced + n.to(f32)
            if stats is not None:
                exact = exact + n
            active = alive_next
            it += 1
        img[e * R:(e + 1) * R] = accum
        iterations += it
    if stats is not None:
        stats.update(iterations=iterations, rays=int(exact))
    return img[:n_pix].reshape(H, W, 3), rays_traced


def render_persistent_stats(scene, cam: Camera, key, config: RenderConfig,
                            spp: int, lanes: int = 262144):
    """(image, traced rays): the JAX package's ``render_persistent_stats_jit``."""
    return render_persistent(scene, cam, key, config, spp, lanes)


def render_persistent_image(scene, cam: Camera, key, config: RenderConfig,
                            spp: int, lanes: int = 262144) -> torch.Tensor:
    """The image alone: the JAX package's ``render_persistent_jit``."""
    return render_persistent(scene, cam, key, config, spp, lanes)[0]
