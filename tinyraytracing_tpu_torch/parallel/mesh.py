"""Rendering over several processes: the counterpart of
``tinyraytracing_tpu/parallel/mesh.py`` over ``torch.distributed``.

One process is one rank. The caller initialises the process group (its
backend, its rendezvous) and builds the scene on the rank's device; every
rank then calls the same entry point with the same arguments and gets the
whole result back (JAX's replicated output). Each entry point computes
its rank's share as a plain function of the rank's mesh coordinates (the
``_*_share`` functions, which tests also run serially in one process),
then combines the shares with one collective:

- ``render_sharded``: the scan renderer. The 2-D mesh (tile, spp) splits
  the pixels into contiguous tiles and the sample passes between the spp
  ranks; sum over the spp axis, then an all-gather over the tile axis.
- ``render_fused_sharded``: the pixel-persistent renderer over ranges of
  image-tile slots; an all-gather of the slot images. The RNG is
  path-indexed, so the image is bitwise ``render_fused``'s.
- ``render_queue_sharded`` (and ``render_queue_sharded_chunked``, which
  checkpoints and resumes): the queue renderer over slices of the global
  path queue; a sum of the images. Only the float-add order of the
  pixel sums differs from ``render_fused_queue``.
- ``render_loss_fast_sharded``: ``diff.fast.render_loss_fast`` over
  pixel slices. After ``loss.backward()`` every rank holds the whole loss
  and the whole gradient in each parameter's ``.grad``.

The last three use the mesh's flattened axis: the rank itself. Several
ranks on one card must use gloo (NCCL refuses two ranks on one device);
gloo takes CUDA tensors for every collective used here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models.camera import (
    Camera, generate_rays_for_pixels,
)
from tinyraytracing_tpu_torch.models.scene import Scene
from tinyraytracing_tpu_torch.ops.rng import fold_in, split
from tinyraytracing_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, spp) mesh over the ranks of a process group: rank r has
    coordinates (r // n_spp, r % n_spp), JAX's row-major device layout.
    ``group`` is None only for the 1x1 mesh of a process without a
    process group, whose collectives are identities. ``tile_group`` and
    ``spp_group`` are the process groups along each axis through this
    rank (None where the axis has one rank)."""

    n_tile: int
    n_spp: int
    rank: int = 0
    group: object = None
    tile_group: object = None
    spp_group: object = None

    @property
    def size(self) -> int:
        return self.n_tile * self.n_spp

    @property
    def coords(self) -> tuple[int, int]:
        return self.rank // self.n_spp, self.rank % self.n_spp

    def _axis_group(self, axis):
        if axis is None:
            return self.group, self.group is not None
        g = self.tile_group if axis == "tile" else self.spp_group
        return g, g is not None

    def all_reduce(self, x, axis=None, op=None):
        """``x`` summed (or reduced by ``op``) over the mesh, or over one
        ``axis``; a new tensor."""
        g, real = self._axis_group(axis)
        x = x.clone()
        if real:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=g)
        return x

    def all_gather(self, x, axis=None):
        """Every rank's ``x`` (of one shape) along the mesh, or one axis,
        concatenated along dim 0 in rank order."""
        g, real = self._axis_group(axis)
        if not real:
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x.contiguous(), group=g)
        return torch.cat(parts)

    def broadcast(self, x):
        """Mesh rank 0's ``x`` on every rank; a new tensor."""
        x = x.clone()
        if self.group is not None:
            dist.broadcast(x, dist.get_global_rank(self.group, 0),
                           group=self.group)
        return x


def make_mesh(n_tile: int | None = None, n_spp: int | None = None,
              group=None) -> Mesh:
    """2-D mesh over the ranks of ``group`` (default: the default process
    group). Defaults, as the JAX package's: every rank on the tile axis,
    spp axis 1. Without a process group, the 1x1 mesh. Every rank of
    ``group`` calls it. A mesh with both axes longer than 1 spans the
    default group and creates its axis groups: every rank creates every
    one of them, in the same order."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
    elif group is not None:
        raise ValueError("make_mesh(group=...) without a process group")
    else:
        ranks, me = [0], 0
    n = len(ranks)
    if n_tile is None and n_spp is None:
        n_tile, n_spp = n, 1
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    if n_tile * n_spp != n:
        raise ValueError(f"mesh {n_tile}x{n_spp} != {n} ranks")
    if group is None:
        return Mesh(n_tile, n_spp)
    tile_group = group if n_spp == 1 and n_tile > 1 else None
    spp_group = group if n_tile == 1 and n_spp > 1 else None
    if n_tile > 1 and n_spp > 1:
        if n != dist.get_world_size():
            raise ValueError("a mesh with both axes longer than 1 spans the "
                             "default process group")
        t_me, s_me = me // n_spp, me % n_spp
        for t in range(n_tile):          # the spp axis through tile t
            g = dist.new_group([t * n_spp + s for s in range(n_spp)])
            spp_group = g if t == t_me else spp_group
        for s in range(n_spp):           # the tile axis through spp s
            g = dist.new_group([t * n_spp + s for t in range(n_tile)])
            tile_group = g if s == s_me else tile_group
    return Mesh(n_tile, n_spp, me, group, tile_group, spp_group)


def _f32(x, dev):
    # divisors as float32 tensors: CUDA turns a division by a Python
    # scalar into a multiplication by its reciprocal
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# the scan renderer over (tile, spp)
# ---------------------------------------------------------------------------

def _render_share(scene, cam: Camera, key, config: RenderConfig, spp: int,
                  n_tile: int, n_spp: int, tile_i: int, spp_i: int):
    """Rank (tile_i, spp_i)'s radiance summed over its sample passes, for
    its tile's pixels: (per, 3), per = ceil(W*H / n_tile). The last tile
    is padded with the last pixel (traced, dropped by the caller). The
    spp ids are padded to a multiple of n_spp; a padded pass adds zero in
    the JAX package and is not traced here. Pass s of tile t draws from
    ``split(fold_in(fold_in(key, s), t))`` and traces the whole tile in
    one ``wavefront.trace``."""
    from tinyraytracing_tpu_torch.integrator.wavefront import trace

    dev = scene.device
    n_pix = cam.width * cam.height
    per = -(-n_pix // n_tile)
    pix = torch.clamp_max(tile_i * per + torch.arange(per, device=dev),
                          n_pix - 1)
    ids = -(-spp // n_spp)
    acc = torch.zeros((per, 3), dtype=torch.float32, device=dev)
    for s in range(spp_i * ids, min((spp_i + 1) * ids, spp)):
        k_ray, k_trace = split(fold_in(fold_in(key, s), tile_i))
        o, d = generate_rays_for_pixels(cam, pix, k_ray, dev)
        acc = acc + trace(scene, o, d, k_trace, config)
    return acc


def render_sharded(scene: Scene, cam: Camera, key, config: RenderConfig,
                   mesh: Mesh | None = None, spp: int | None = None):
    """Render over ``mesh`` (default: every rank on the tile axis); returns
    the (H, W, 3) linear mean image on every rank. ``key``: (k0, k1) key
    words. The stream layout is the JAX package's ``render_sharded``, not
    ``render``'s: the two agree statistically."""
    mesh = mesh if mesh is not None else make_mesh()
    spp = spp or config.spp
    W, H = cam.width, cam.height
    tile_i, spp_i = mesh.coords
    acc = _render_share(scene, cam, key, config, spp, mesh.n_tile,
                        mesh.n_spp, tile_i, spp_i)
    acc = mesh.all_reduce(acc, "spp") / _f32(spp, acc.device)
    return mesh.all_gather(acc, "tile")[:W * H].reshape(H, W, 3)


# ---------------------------------------------------------------------------
# the pixel-persistent renderer over image-tile slots
# ---------------------------------------------------------------------------

def _fused_share(scene, cam: Camera, key, config: RenderConfig, spp: int,
                 lanes: int, n_ranks: int, r: int):
    """Rank r's slot images (n, 3), in slot order, and its traced-ray
    count: ``render_fused`` over the slots [r * n, (r + 1) * n), the
    pixels split evenly in 128-aligned ranges."""
    from tinyraytracing_tpu_torch.integrator.fused import render_fused

    n = -(-cam.width * cam.height // (128 * n_ranks)) * 128
    img, rays = render_fused(scene, cam, key, config, spp,
                             lanes=min(lanes, n), slot_base=r * n, n_slots=n)
    return img[:n], rays


def _slots_to_image(slots, cam: Camera):
    """(H, W, 3) from every rank's slot images concatenated in rank
    order."""
    from tinyraytracing_tpu_torch.integrator.fused import pixel_tile_order

    inv = torch.as_tensor(pixel_tile_order(cam.width, cam.height)[1],
                          dtype=torch.int64, device=slots.device)
    return slots[inv].reshape(cam.height, cam.width, 3)


def render_fused_sharded(scene: Scene, cam: Camera, key, config: RenderConfig,
                         spp: int, mesh: Mesh | None = None,
                         lanes: int = 262144):
    """The pixel-persistent renderer over the mesh's ranks; returns
    ((H, W, 3) image, traced rays) on every rank. The image is bitwise
    ``render_fused``'s for any mesh; the ray count is the sum of the
    ranks' float32 counts."""
    mesh = mesh if mesh is not None else make_mesh()
    slots, rays = _fused_share(scene, cam, key, config, spp, lanes,
                               mesh.size, mesh.rank)
    return (_slots_to_image(mesh.all_gather(slots), cam),
            mesh.all_reduce(rays))


# ---------------------------------------------------------------------------
# the queue renderer over slices of the global path queue
# ---------------------------------------------------------------------------

def _queue_slice(cam: Camera, spp: int, lanes: int, n_ranks: int):
    """(paths per rank, lanes per rank): rank r serves the queue slice
    [r * per, (r + 1) * per) of the W*H*spp paths (in tile order, so its
    refills stay spatially coherent)."""
    per = -(-cam.width * cam.height * spp // n_ranks)
    return per, min(lanes, per)


def _queue_share(scene, cam: Camera, key, config: RenderConfig, spp: int,
                 lanes: int, n_ranks: int, r: int):
    """Rank r's (n_pix, 3) partial image and traced-ray count."""
    from tinyraytracing_tpu_torch.integrator.fused_queue import (
        render_fused_queue,
    )

    per, lanes_dev = _queue_slice(cam, spp, lanes, n_ranks)
    return render_fused_queue(scene, cam, key, config, spp, lanes=lanes_dev,
                              path_lo=r * per, n_paths=per)


def render_queue_sharded(scene: Scene, cam: Camera, key, config: RenderConfig,
                         spp: int, mesh: Mesh | None = None,
                         lanes: int = 262144):
    """The queue renderer over the mesh's ranks (path-queue slices);
    returns ((H, W, 3) image, traced rays) on every rank. Each path's
    radiance does not depend on the rank that traces it; the pixel sums
    add in another order than ``render_fused_queue``'s."""
    mesh = mesh if mesh is not None else make_mesh()
    with span("mesh.share"):
        img, rays = _queue_share(scene, cam, key, config, spp, lanes,
                                 mesh.size, mesh.rank)
    with span("mesh.allreduce"):
        return (mesh.all_reduce(img).reshape(cam.height, cam.width, 3),
                mesh.all_reduce(rays))


# ---------------------------------------------------------------------------
# the fast gradient path over pixel slices
# ---------------------------------------------------------------------------

class _CopyToRanks(torch.autograd.Function):
    """The parameters on entry to a rank's share: the identity forward;
    the backward sums every rank's gradient (one all-reduce for the
    parameters of each device: a camera's may live on the CPU), so each
    rank's ``.grad`` is the whole gradient."""

    @staticmethod
    def forward(ctx, mesh, *params):
        ctx.mesh = mesh
        ctx.like = [(p.shape, p.dtype, p.device) for p in params]
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=t, device=d) if g is None else g
                 for g, (s, t, d) in zip(grads, ctx.like)]
        out = list(grads)
        for dev in sorted({str(g.device) for g in grads}):
            idx = [i for i, g in enumerate(grads) if str(g.device) == dev]
            flat = ctx.mesh.all_reduce(
                torch.cat([grads[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.reshape(grads[i].shape)
        return (None, *out)


class _SumOverRanks(torch.autograd.Function):
    """A rank's partial sum on exit: the forward sums it over the ranks;
    the backward passes the gradient through (every rank differentiates
    its own share)."""

    @staticmethod
    def forward(ctx, mesh, x):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def render_loss_fast_sharded(params, scene, cam, key, target,
                             config: RenderConfig, spp: int,
                             mesh: Mesh | None = None):
    """``diff.fast.render_loss_fast``'s mean-squared loss (no edge terms)
    over the mesh's ranks: rank r renders and differentiates pixels
    [r * per, (r + 1) * per) through ``diff.fast.render_diff``, and the
    squared-error sums are added over the ranks. After
    ``loss.backward()`` every rank holds the whole loss and each set
    parameter's whole gradient. Pixel values do not depend on the slice
    (path-indexed RNG); only the order of the sums differs."""
    from tinyraytracing_tpu_torch.diff.fast import render_diff
    from tinyraytracing_tpu_torch.diff.inverse import PARAM_FIELDS, apply_params

    mesh = mesh if mesh is not None else make_mesh()
    W, H = cam.width, cam.height
    n_pix = W * H
    D, r = mesh.size, mesh.rank
    per = -(-n_pix // D)
    dev = scene.device
    tgt = torch.as_tensor(target, device=dev).reshape(n_pix, 3)
    tgt = torch.cat([tgt, tgt.new_zeros((D * per - n_pix, 3))])
    fields = [f for f in PARAM_FIELDS if getattr(params, f) is not None]
    if fields:
        copied = _CopyToRanks.apply(mesh, *(getattr(params, f) for f in fields))
        params = dataclasses.replace(params, **dict(zip(fields, copied)))
    s2, c2 = apply_params(scene, cam, params)
    img = render_diff(s2, c2, key, config, spp, pix_lo=r * per,
                      n_pix_local=per)
    idx = r * per + torch.arange(per, device=dev)
    w = (idx < n_pix).to(torch.float32)[:, None]          # drop pad pixels
    err = torch.sum(((img - tgt[r * per:(r + 1) * per]) ** 2) * w)
    return _SumOverRanks.apply(mesh, err) / _f32(n_pix * 3, dev)


# ---------------------------------------------------------------------------
# the chunked queue driver over the ranks
# ---------------------------------------------------------------------------

def render_queue_sharded_chunked(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    mesh: Mesh | None = None,
    lanes: int = 262144,
    target_chunk_s: float = 8.0,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 120.0,
    resume: bool = False,
    progress=None,
    stop_after_chunks: int | None = None,
):
    """``render_queue_sharded`` in host chunks of iterations, with
    checkpoint and resume; returns ((H, W, 3) image, traced rays) on
    every rank, on the CPU bitwise ``render_queue_sharded``'s.

    Every rank advances its own queue slice; each chunk takes every
    still-running rank to the same ``stop = min(its of running ranks) +
    chunk`` (a rank whose slice drained stops below it and is done). The
    ranks agree on every decision: one all-gather per chunk carries each
    rank's iteration, queue counter, chunk seconds and rank 0's verdict
    on the checkpoint clock; the next chunk is sized from the slowest
    rank's seconds; ``stop_after_chunks`` is rank 0's.

    Snapshots: rank r of D writes ``f"{checkpoint_path}.rank{r}-of-{D}"``,
    bound to everything ``render_fused_queue_chunked`` binds plus the rank
    count, the slice and the lanes, so a snapshot of another mesh shape is
    never read. A resume happens only where every rank found its snapshot
    valid; otherwise every rank starts afresh. ``stop_after_chunks``
    preempts after that many chunks, snapshotting (kept) so that a
    ``resume=True`` call continues; a finished render removes the
    snapshots once every rank is done. ``progress(it=, counter=,
    seconds=)``: the largest iteration, the smallest counter and the
    slowest rank's seconds of each chunk.
    """
    from tinyraytracing_tpu_torch.integrator.fused_queue import (
        _flatten, _queue_setup, _result, _snapshot_meta, _unflatten,
    )
    from tinyraytracing_tpu_torch.utils import checkpoint as ckpt

    mesh = mesh if mesh is not None else make_mesh()
    D, r = mesh.size, mesh.rank
    dev = scene.device
    per, lanes_dev = _queue_slice(cam, spp, lanes, D)
    max_iters, init_state, more, body = _queue_setup(
        scene, cam, key, config, spp, lanes_dev, r * per, per)
    s = init_state()
    path = f"{checkpoint_path}.rank{r}-of-{D}" if checkpoint_path else None
    meta = dict(_snapshot_meta(scene, cam, key, config, spp, lanes_dev,
                               r * per, per), n_ranks=D)
    if resume and path:
        leaves = ckpt.load_queue_state(path, meta)
        got = _unflatten(leaves, s) if leaves is not None else s
        found = torch.tensor([int(got is not s)], device=dev)
        if int(mesh.all_reduce(found, op=dist.ReduceOp.MIN)[0]):
            s = got
    stop_after = int(mesh.broadcast(torch.tensor(
        [-1 if stop_after_chunks is None else stop_after_chunks],
        device=dev))[0])

    def gather(dt, due):
        """[[it, counter, seconds, checkpoint due]] of every rank."""
        row = torch.tensor([[s["it"], s["counter"], dt, due]],
                           dtype=torch.float64, device=dev)
        return mesh.all_gather(row).cpu().numpy()

    rows = gather(0.0, 0.0)
    its = rows[:, 0].astype(np.int64)
    running = np.ones(D, bool)
    chunk, chunks_done, preempted = 4, 0, False
    last_ckpt = time.perf_counter()
    while running.any() and int(its[running].min()) < max_iters:
        if stop_after >= 0 and chunks_done >= stop_after:
            preempted = True
            if path:
                ckpt.save_queue_state(path, _flatten(s), meta)
            break
        stop = int(its[running].min()) + chunk
        t0 = time.perf_counter()
        while more(s) and s["it"] < stop:
            s = body(s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        due = (time.perf_counter() - last_ckpt > checkpoint_every_s)
        rows = gather(dt, float(due))
        its = rows[:, 0].astype(np.int64)
        dt = float(rows[:, 2].max())
        running = its >= stop
        if progress is not None:
            progress(it=int(its.max()), counter=int(rows[:, 1].min()),
                     seconds=dt)
        chunk = max(1, min(chunk * 4, int(target_chunk_s
                                          / max(dt / max(chunk, 1), 1e-4))))
        chunks_done += 1
        if path and rows[0, 3]:
            ckpt.save_queue_state(path, _flatten(s), meta)
            last_ckpt = time.perf_counter()
    img, rays = _result(s, cam.width * cam.height)
    img, rays = mesh.all_reduce(img), mesh.all_reduce(rays)
    if path and not preempted:
        ckpt.clear_queue_state(path)      # after the collective: all done
    return img.reshape(cam.height, cam.width, 3), rays
