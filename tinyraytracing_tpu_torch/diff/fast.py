"""Gradients on the fast path: the trace kernels under a custom backward,
and a fixed-depth planar renderer — the counterpart of
``tinyraytracing_tpu/diff/fast.py``.

- ``fused_trace_diff``: a ``torch.autograd.Function`` around
  ``ops.trace.fused_trace_planes(..., return_tri=True)``. Its forward is
  the trace kernel (``csrc/trace.cu``: kernel 1, or the near-first walk
  under ``walk_order="near"``) on a CUDA tensor, and its plain version on
  a CPU tensor; it never falls back. Its backward is path replay: with
  the hit triangle fixed (hit selection is discrete), the outputs (t,
  interpolated shading normal, texcoord) are closed-form Moller-Trumbore
  functions of the ray and the triangle's vertices, normals and
  texcoords (``_replay_outputs``), and the backward is their VJP, plain
  PyTorch ops (the JAX package has no backward kernel either). The
  kernel computes t, u, v through the Woop rows: the same function,
  equal up to float32 rounding. The triangle rows are gathered with
  ``index_select`` (``ops.lookup.gather_rows``; the JAX package's one-hot
  MXU product for small scenes is a TPU device), whose backward sums the
  cotangent rows in a fixed order (``ops.scatter.scatter_add_rows_fixed``:
  a kernel on the card, its plain version on the CPU). That order is
  another than XLA's scatter-add, so the vertex cotangents agree with the
  JAX package's to float rounding; from run to run they repeat bitwise,
  on the card as on the CPU. ``mtl``, ``em`` and ``tri`` are discrete: no
  gradient.
- ``render_diff``: the fixed-depth planar renderer, the estimator of
  ``integrator/wavefront.trace`` (NEE, Russian roulette, the reference's
  quirks) on the pieces of ``integrator/fused.py`` and the path-indexed
  threefry of ``ops/rng.py``. Each bounce runs under
  ``torch.utils.checkpoint`` (recomputed in the backward, which launches
  the trace kernels again), shadow visibility is traced on detached
  inputs through ``ops.trace.occlusion_trace_segmented`` (kernel 2) and
  sampling is detached under ``config.detach_sampling``.

Vertex moves keep the kernels' BVH valid through ``diff/refit.py``
(``inverse.apply_params``); the refit is detached, and every geometry
gradient flows through the replay, not through the tree.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tinyraytracing_tpu_torch.config import (
    CAMERA, INVALID, SPECULAR, TRANSMISSION, RenderConfig,
)
from tinyraytracing_tpu_torch.integrator.fused import (
    _material_planes, _nee_geometry, _tex_kd, sample_bsdf_planar,
)
from tinyraytracing_tpu_torch.models.camera import camera_basis
from tinyraytracing_tpu_torch.ops import vec
from tinyraytracing_tpu_torch.ops.lookup import gather_rows
from tinyraytracing_tpu_torch.ops.rng import (
    bits_to_uniform, bounce_uniforms, fold_in, path_keys,
)
from tinyraytracing_tpu_torch.ops.trace import (
    _INF, fused_trace_planes, occlusion_trace_segmented,
)

# the scene arrays the replay differentiates, in fused_trace_diff's order
GEOMETRY = ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2")


def _replay_outputs(v0, v1, v2, n0, n1, n2, t0, t1, t2,
                    ox, oy, oz, dx, dy, dz, tri, hit):
    """Closed-form (t, pn xyz, tc uv) of the fixed hit triangles: the
    function whose VJP is the interior-term backward. Lanes that hit
    nothing give 0."""
    i = torch.clamp_min(tri, 0)
    a0, b0, c0 = gather_rows(v0, i), gather_rows(v1, i), gather_rows(v2, i)
    o = torch.stack([ox, oy, oz], dim=-1)
    d = torch.stack([dx, dy, dz], dim=-1)
    dot = lambda a, b: a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]
    cross = lambda a, b: torch.stack(
        [a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    e1 = b0 - a0
    e2 = c0 - a0
    p = cross(d, e2)
    det = dot(e1, p)
    safe = det.abs() > 1e-24
    one = torch.ones_like(det)
    inv = torch.where(safe, one, torch.zeros_like(det)) / torch.where(safe, det, one)
    s = o - a0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    w = 1.0 - u - v
    m = hit.to(torch.float32)
    row = lambda tab: gather_rows(tab, i)
    pn = row(n0) * w[:, None] + row(n1) * u[:, None] + row(n2) * v[:, None]
    tc = row(t0) * w[:, None] + row(t1) * u[:, None] + row(t2) * v[:, None]
    return (t * m, pn[:, 0] * m, pn[:, 1] * m, pn[:, 2] * m,
            tc[:, 0] * m, tc[:, 1] * m)


class _FusedTraceDiff(torch.autograd.Function):
    """Inputs: (scene, config, t_bound, target_mtl, ox..dz, v0..t2); the
    scene travels beside its geometry planes, which are explicit inputs
    so that autograd routes their cotangents."""

    @staticmethod
    def forward(ctx, scene, config, t_bound, target_mtl, *planes):
        rays, geom = planes[:6], planes[6:]
        out = fused_trace_planes(scene, *rays, config, t_bound=t_bound,
                                 target_mtl=target_mtl, return_tri=True)
        tri = out[8].to(torch.int64)
        ctx.save_for_backward(*rays, *geom, tri)
        ctx.mark_non_differentiable(*out[6:])
        return out

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        prim, tri = saved[:-1], saved[-1]
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            x = [p.detach().requires_grad_(n) for p, n in zip(prim, needs)]
            outs = _replay_outputs(*x[6:], *x[:6], tri, tri >= 0)
            want = [xi for xi in x if xi.requires_grad]
            grads = iter(torch.autograd.grad(
                outs, want,
                [torch.zeros_like(o) if c is None else c
                 for o, c in zip(outs, cts[:6])],
                allow_unused=True) if want else ())
        return (None, None, None, None,
                *(next(grads) if n else None for n in needs))


def fused_trace_diff(scene, ox, oy, oz, dx, dy, dz, config: RenderConfig,
                     t_bound, target_mtl):
    """Differentiable fused trace: the 9 planes of
    ``fused_trace_planes(return_tri=True)``; gradients flow to the rays
    and to ``scene.{v0,v1,v2,n0,n1,n2,t0,t1,t2}`` by path replay."""
    return _FusedTraceDiff.apply(
        scene, config, t_bound, target_mtl, ox, oy, oz, dx, dy, dz,
        *(getattr(scene, k) for k in GEOMETRY))


def render_diff(scene, cam, key, config: RenderConfig, spp: int,
                return_rays: bool = False, pix_lo=0,
                n_pix_local: int | None = None):
    """Fixed-depth differentiable render on the fast (trace-kernel) path,
    on the scene's device.

    Returns the (H, W, 3) linear mean image (with ``return_rays`` also the
    traced-ray count, closest-hit plus shadow rays, for forward + backward
    rays/s). ``key``: (k0, k1) key words (``ops.rng.master_key_data``).
    Needs ``scene.bvh.packed`` (``attach_bvh``; under vertex offsets
    ``apply_params`` refits it). The RNG is path-indexed (path = pixel *
    spp + sample), so the image does not depend on the scheduling.

    ``pix_lo`` and ``n_pix_local`` select the contiguous pixel slice
    [pix_lo, pix_lo + n_pix_local) (for tile-sharded differentiation); the
    return is then the flat (n_pix_local, 3) slice.
    """
    if scene.bvh is None or scene.bvh.packed is None:
        raise ValueError("render_diff needs a packed BVH (ops.bvh.attach_bvh; "
                         "vertex offsets keep it only with refit metadata)")
    dev = scene.device
    f32 = torch.float32
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    n_pix = W * H
    sliced = n_pix_local is not None
    R = n_pix_local if sliced else n_pix
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].to(f32) for l in range(L)]
    eye, horizontal, vertical, llc = (v.to(dev) for v in camera_basis(cam))
    c_w1, c_w, c_h1, c_h = c(W - 1.0), c(float(W)), c(H - 1.0), c(float(H))
    pix = torch.clamp_max(pix_lo + torch.arange(R, device=dev), n_pix - 1)
    zero, one = torch.zeros(R, dtype=f32, device=dev), torch.ones(R, dtype=f32, device=dev)
    far3 = (zero + 1e30,) * 3
    up = (zero, zero, one)
    inf_b, park_b, no_tg = c(_INF), c(0.0), torch.full((R,), -2.0, device=dev)
    inv_prr = c(1.0 / config.p_rr)
    detach = (lambda x: x.detach()) if config.detach_sampling else (lambda x: x)

    def camera_ray(path_id):
        i = torch.div(pix, W, rounding_mode="floor").to(f32)
        j = (pix % W).to(f32)
        pk0, pk1 = path_keys(key, path_id)
        h1 = bits_to_uniform(pk0)
        h2 = bits_to_uniform(pk1)
        x = j / c_w1 + (h1 - 0.5) / c_w
        y = (H - i) / c_h1 + (h2 - 0.5) / c_h
        d = vec.normalize(tuple(llc[k] + x * horizontal[k] + y * vertical[k]
                                - eye[k] for k in range(3)))
        return tuple(eye[k].expand(R) for k in range(3)), d, (pk0, pk1)

    def bounce(b, pk0, pk1, active, ox, oy, oz, dx, dy, dz, ray_type,
               tr0, tr1, tr2, rd0, rd1, rd2, rays):
        o, d, thr, rad = (ox, oy, oz), (dx, dy, dz), (tr0, tr1, tr2), (rd0, rd1, rd2)
        o_m = vec.where(active, o, far3)
        t, pnx, pny, pnz, tcu, tcv, mtl, em, _ = fused_trace_diff(
            scene, o_m[0], o_m[1], o_m[2], d[0], d[1], d[2], config,
            torch.where(active, inf_b, park_b), no_tg)
        rays = rays + active.to(f32)
        hit = mtl >= 0.0
        point = vec.add(o_m, vec.scale(d, t))
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
        ks, ns = mat["ks"], mat["ns"]
        wi = vec.neg(d)
        draws = bounce_uniforms(pk0, pk1, torch.tensor(b, device=dev), 4 * L + 5)

        pend, sh_o, sh_d = [], [], []
        for l in range(L):
            wo, contrib, distl, okl = _nee_geometry(
                scene, config, l, point, pn, wi, kd_val, ks, ns,
                draws[4 * l + 0], draws[4 * l + 1], draws[4 * l + 2],
                draws[4 * l + 3], shade_mask)
            pend.append((okl, contrib, distl))
            sh_o.append(vec.where(okl, point, far3))
            sh_d.append(vec.where(okl, wo, up))
        # visibility is discrete: the shadow trace runs outside the
        # gradient path, on detached inputs
        cat = lambda xs: torch.cat(xs).detach()
        sh_args = (cat([s[0] for s in sh_o]), cat([s[1] for s in sh_o]),
                   cat([s[2] for s in sh_o]), cat([s[0] for s in sh_d]),
                   cat([s[1] for s in sh_d]), cat([s[2] for s in sh_d]))
        sh_tb = cat([torch.where(okl, distl, zero) for okl, _, distl in pend])
        sh_tg = cat([torch.where(okl, light_mtl_f[l], no_tg)
                     for l, (okl, _, _) in enumerate(pend)])
        occl_q = config.shadow_test == "mtl"
        if occl_q:
            svis = occlusion_trace_segmented(scene, *sh_args, sh_tb, sh_tg,
                                             config, L)
        else:
            st, _, _, _, _, _, smtl, _ = fused_trace_planes(
                scene, *sh_args, config, t_bound=sh_tb, target_mtl=sh_tg,
                attrs=False)
        for l, (okl, contrib, distl) in enumerate(pend):
            sl = slice(l * R, (l + 1) * R)
            if occl_q:
                vis = svis[sl] > 0.5
            else:
                occ = (smtl[sl] == -3.0) | (
                    (smtl[sl] >= 0.0) & (st[sl] < distl.detach() - 1e-3))
                vis = ~occ
            add = okl & vis
            rad = tuple(rad[k] + torch.where(add, thr[k] * contrib[k], zero)
                        for k in range(3))
            rays = rays + okl.to(f32)

        u = draws[4 * L:4 * L + 5]
        survive = shade_mask & (u[0] < config.p_rr) & (b + 1 < config.max_depth)
        new_dir, new_type = sample_bsdf_planar(
            tuple(detach(x) for x in d), tuple(detach(x) for x in pn),
            mat["kd"], ks, ns, mat["ni"], u[1], u[2], u[3], u[4])
        new_dir = tuple(detach(x) for x in new_dir)
        alive_next = survive & (new_type != INVALID)
        if config.specular_weight == "ref":
            ds_weight = kd_val
        else:
            ds_weight = vec.where(new_type == SPECULAR, ks, kd_val)
        weight = vec.where(new_type == TRANSMISSION, mat["tr"], ds_weight)
        thr = vec.where(alive_next, tuple(thr[k] * weight[k] * inv_prr
                                          for k in range(3)), thr)
        o = vec.where(alive_next, point, o)
        d = vec.where(alive_next, new_dir, up)
        ray_type = torch.where(alive_next, new_type, ray_type)
        return (alive_next, *o, *d, ray_type, *thr, *rad, rays)

    def one_pass(s):
        path_id = pix * spp + s
        o, d, (pk0, pk1) = camera_ray(path_id)
        carry = (torch.ones(R, dtype=torch.bool, device=dev), *o, *d,
                 torch.full((R,), CAMERA, dtype=torch.int64, device=dev),
                 one, one, one, zero, zero, zero, zero)
        for b in range(config.max_depth):
            if torch.is_grad_enabled():
                carry = checkpoint(bounce, b, pk0, pk1, *carry,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                carry = bounce(b, pk0, pk1, *carry)
        return torch.stack(carry[11:14], dim=-1), torch.sum(carry[14])

    img = torch.zeros((R, 3), dtype=f32, device=dev)
    rays = torch.zeros((), dtype=f32, device=dev)
    for s in range(spp):
        im, r = one_pass(s)
        img, rays = img + im, rays + r
    img = img / c(float(spp))
    if not sliced:
        img = img.reshape(H, W, 3)
    if return_rays:
        return img, rays
    return img


def render_loss_fast(params, scene, cam, key, target, config: RenderConfig,
                     spp: int, edge_samples: int = 0,
                     shadow_edge_samples: int = 0, edge_aux=None,
                     edge_delta: float = 0.1, shadow_light: int = 0):
    """Mean-squared pixel loss through the fast differentiable path:
    ``apply_params`` (BVH refit under vertex offsets) and ``render_diff``
    (the trace kernels under path replay); the fast-path counterpart of
    ``diff.inverse.render_loss``.

    Edge-sampled boundary terms (``diff/edge.py``): with ``edge_samples``
    > 0 the gradient also carries the primary-visibility boundary term
    (view-dependent silhouettes, closed meshes included), with
    ``shadow_edge_samples`` > 0 the shadow-silhouette term for
    camera-visible shading points under planar light ``shadow_light``.
    Both are added as ``x - x.detach()``, so the loss value is unchanged.
    ``edge_aux``: ``diff.edge.build_edge_aux(scene)``, built here when
    None (build it once per scene). The terms' integrands trace through
    ``config.intersector`` (on the card the packet-BVH or slot kernel)."""
    from tinyraytracing_tpu_torch.diff import edge
    from tinyraytracing_tpu_torch.diff.inverse import apply_params

    s2, c2 = apply_params(scene, cam, params)
    img = render_diff(s2, c2, key, config, spp)
    loss = torch.mean((img - target) ** 2)
    if edge_samples or shadow_edge_samples:
        if edge_aux is None:
            edge_aux = edge.build_edge_aux(scene)
        if edge_samples:
            sur = edge.primary_edge_surrogate(
                s2, c2, config, target, fold_in(key, 101), edge_aux,
                edge_samples, edge_delta, spp=1)
            loss = loss + (sur - sur.detach())
        if shadow_edge_samples:
            sur2 = edge.shadow_edge_surrogate(
                s2, c2, config, target, img.detach(), fold_in(key, 102),
                edge_aux, shadow_edge_samples, light=shadow_light)
            loss = loss + (sur2 - sur2.detach())
    return loss
