"""Pinhole camera (reference RayTracingOnCPU/camera.cpp:3-28), the
counterpart of ``tinyraytracing_tpu/models/camera.py``.

    h          = tan(radians(fovy) / 2)
    viewport   = (2h * aspect, 2h) at focal distance 1
    w          = normalize(eye - lookat)
    u          = normalize(cross(up, w));  v = cross(w, u)
    horizontal = viewport_w * u;  vertical = viewport_h * v
    llc        = eye - horizontal/2 - vertical/2 - w

computed in float32 on (3,) tensors, in the JAX package's operation order.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor       # (3,) float32
    lookat: torch.Tensor    # (3,)
    up: torch.Tensor        # (3,)
    fovy: torch.Tensor      # () degrees
    width: int
    height: int

    @staticmethod
    def create(eye, lookat, up, fovy, width, height) -> "Camera":
        return Camera(eye=_f32(eye), lookat=_f32(lookat), up=_f32(up),
                      fovy=_f32(fovy), width=int(width), height=int(height))

    @property
    def aspect(self):
        return self.width / self.height


def _normalize(a):
    # ops/linalg.normalize: a * 1/max(|a|, 1e-20)
    n = torch.sqrt(torch.clamp_min(torch.sum(a * a, dim=-1), 0.0))
    return a * torch.reciprocal(torch.clamp_min(n, 1e-20))


def camera_basis(cam: Camera):
    """(origin, horizontal, vertical, lower_left_corner), each (3,) float32."""
    theta = torch.deg2rad(cam.fovy)
    h = torch.tan(theta / 2.0)
    viewport_h = 2.0 * h
    viewport_w = cam.aspect * viewport_h
    w = _normalize(cam.eye - cam.lookat)
    u = _normalize(torch.linalg.cross(cam.up, w))
    v = torch.linalg.cross(w, u)
    horizontal = viewport_w * u
    vertical = viewport_h * v
    llc = cam.eye - horizontal / 2.0 - vertical / 2.0 - w
    return cam.eye, horizontal, vertical, llc


def generate_rays(cam: Camera, key, device="cuda"):
    """One jittered camera ray per pixel, row-major (top row first), on
    ``device`` (the card unless the caller asks for the CPU; ``key``:
    (k0, k1) key words, as ``ops.rng``). Returns
    (origins (N, 3), directions (N, 3)) with N = W*H; the jitter is
    ``uniform(key, (2, N)) - 0.5`` and
    ``x = j/(W-1) + jit[0]/W``, ``y = (H-i)/(H-1) + jit[1]/H``
    (reference main.cpp:88-93)."""
    from tinyraytracing_tpu_torch.ops.linalg import normalize
    from tinyraytracing_tpu_torch.ops.rng import uniform

    W, H = cam.width, cam.height
    eye, horizontal, vertical, llc = (
        v.to(device) for v in camera_basis(cam))
    # divisors as float32 tensors: CUDA turns a division by a Python scalar
    # into a multiplication by its reciprocal
    c = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    j = torch.arange(W, dtype=torch.float32, device=device).repeat(H)
    i = torch.arange(H, dtype=torch.float32, device=device).repeat_interleave(W)
    jit = uniform(key, (2, W * H), device) - 0.5
    x = j / c(W - 1.0) + jit[0] / c(float(W))
    y = (H - i) / c(H - 1.0) + jit[1] / c(float(H))
    d = (llc[None, :] + x[:, None] * horizontal[None, :]
         + y[:, None] * vertical[None, :] - eye[None, :])
    d = normalize(d)
    return eye.expand(d.shape), d


def generate_rays_for_pixels(cam: Camera, pix, key, device="cuda"):
    """Jittered rays for an arbitrary set of pixels, on ``device`` (the
    card unless the caller asks for the CPU). ``pix``: (N,) global
    row-major pixel ids (i*W + j); ``key``: (k0, k1) key words. Returns
    (origins (N, 3), directions (N, 3)); the jitter is
    ``uniform(key, (2, N)) - 0.5``, as in ``generate_rays``. The sharded
    scan renderer (``parallel/mesh.py``) gives each rank a slice of the
    pixels."""
    from tinyraytracing_tpu_torch.ops.linalg import normalize
    from tinyraytracing_tpu_torch.ops.rng import uniform

    W, H = cam.width, cam.height
    eye, horizontal, vertical, llc = (
        v.to(device) for v in camera_basis(cam))
    c = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    pixf = torch.as_tensor(pix, device=device).to(torch.float32)
    i = torch.floor(pixf / c(float(W)))
    j = pixf - i * c(float(W))
    jit = uniform(key, (2,) + tuple(pixf.shape), device) - 0.5
    x = j / c(W - 1.0) + jit[0] / c(float(W))
    y = (H - i) / c(H - 1.0) + jit[1] / c(float(H))
    d = (llc[None, :] + x[:, None] * horizontal[None, :]
         + y[:, None] * vertical[None, :] - eye[None, :])
    d = normalize(d)
    return eye.expand(d.shape), d


def generate_rays_np(cam: Camera, x, y):
    """Host-side (numpy, float64) rays through the screen points (x, y)
    (main.cpp:88-93's mapping), for tests against hand math. Returns
    (origins (N, 3), directions (N, 3)) as float64 arrays."""
    import numpy as np

    f64 = lambda t: t.detach().cpu().double().numpy()
    fovy = float(cam.fovy)
    eye, lookat, up = f64(cam.eye), f64(cam.lookat), f64(cam.up)
    h = np.tan(np.deg2rad(fovy) / 2)
    vh, vw = 2 * h, 2 * h * cam.aspect
    w = eye - lookat
    w /= np.linalg.norm(w)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    horizontal, vertical = vw * u, vh * v
    llc = eye - horizontal / 2 - vertical / 2 - w
    d = (llc + np.asarray(x)[:, None] * horizontal
         + np.asarray(y)[:, None] * vertical - eye)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape), d
