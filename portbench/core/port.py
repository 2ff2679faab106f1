"""The only module of the benchmark that imports the program (the port,
``tinyraytracing_tpu_torch``): it builds the program's scene from a raw
scene of ``core.scenes`` through the port's own loading path
(``assemble_scene``, then ``attach_bvh``, the CLI's tree) and hands the
drivers the port's entry points."""

from __future__ import annotations

import numpy as np


def build_scene(raw: dict, config: dict, device):
    """(scene, camera, render config) of the program for a raw scene."""
    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.io.mtl import MaterialSpec
    from tinyraytracing_tpu_torch.io.objmesh import MeshArrays
    from tinyraytracing_tpu_torch.io.xmlscene import LightSpec, SceneConfig
    from tinyraytracing_tpu_torch.models.camera import Camera
    from tinyraytracing_tpu_torch.models.scene import assemble_scene
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    cam = raw["camera"]
    cfg = SceneConfig(width=cam["width"], height=cam["height"], fovy=cam["fovy"],
                      eye=cam["eye"], lookat=cam["lookat"], up=cam["up"],
                      lights=[LightSpec(n, tuple(r)) for n, r in raw["lights"]])
    v = np.asarray(raw["v"], np.float64)
    mesh = MeshArrays(v=v, vn=np.asarray(raw["vn"]), vt=np.zeros((len(v), 3, 2)),
                      normal=np.asarray(raw["normal"]), center=v.mean(axis=1),
                      mtl=np.asarray(raw["mtl"], np.int32),
                      mtl_names=list(raw["mtl_names"]))
    mats = {n: MaterialSpec(n, kd=tuple(m["kd"]), ks=tuple(m["ks"]), tr=tuple(m["tr"]),
                            ns=float(m["ns"]), ni=float(m["ni"]))
            for n, m in raw["materials"].items()}
    render = RenderConfig(max_depth=int(config["max_depth"]), p_rr=float(config["p_rr"]),
                          leaf_size=int(config.get("leaf_size", 8)), intersector="bvh")
    scene = attach_bvh(assemble_scene(cfg, mesh, mats, device=device), render)
    camera = Camera.create(cam["eye"], cam["lookat"], cam["up"], cam["fovy"],
                           cam["width"], cam["height"])
    return scene, camera, render


def set_up(raw: dict, config: dict, device):
    """The program's scene for a raw scene, timed: (scene, camera, render
    config, seconds of host clock around the build, synchronized). On the
    card it also builds the trace kernels' records of the scene and then
    compiles (or loads from the checkout's build directory) every CUDA
    kernel of the program."""
    import time

    import torch

    t = time.perf_counter()
    scene, cam, render = build_scene(raw, config, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        scene.trace_records                      # built once per scene
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    if cuda:
        from tinyraytracing_tpu_torch.ops import kernels

        kernels.build()
    return scene, cam, render, seconds


def render_queue_slice(scene, cam, key, config, spp: int, lanes: int, path_lo: int,
                       n_paths: int):
    """The CLI's queue route on a slice of the path queue: ((n_pix, 3)
    image in pixel order, traced rays)."""
    from tinyraytracing_tpu_torch.integrator.fused_queue import render_fused_queue_chunked

    return render_fused_queue_chunked(scene, cam, key, config, spp, lanes=lanes,
                                      path_lo=path_lo, n_paths=n_paths)


def render_persistent(scene, cam, key, config, spp: int, lanes: int):
    """The pixel-persistent renderer over the whole image: ((slots, 3)
    image in the renderers' tile order, traced rays)."""
    from tinyraytracing_tpu_torch.integrator.fused import render_fused

    return render_fused(scene, cam, key, config, spp, lanes=lanes)


def inverse_problem(scene, cam, target_key, config, spp: int, learning_rate: float,
                    kd_start: float):
    """The inverse-rendering loop of the port's example on the fast
    gradient path: (target image, step, state), where ``step(state, key)``
    -> (state, loss) takes one Adam step of ``render_loss_fast`` in the
    albedos and the per-triangle vertex offsets, which start at
    ``kd_start`` and at zero, and ``loss_of(state, key)``, the step's loss
    call alone. The target is rendered with the true parameters under
    ``target_key``. Returns (step, state, loss_of)."""
    import torch

    from tinyraytracing_tpu_torch.diff.fast import render_diff, render_loss_fast
    from tinyraytracing_tpu_torch.diff.inverse import SceneParams, make_train_step

    with torch.no_grad():
        target = render_diff(scene, cam, target_key, config, spp)
    step, init = make_train_step(scene, cam, target, config, spp,
                                 learning_rate=learning_rate, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=torch.full_like(scene.kd, kd_start),
                             vertex_offset=torch.zeros_like(scene.v0)))

    def loss_of(state, key):
        return render_loss_fast(state[0], scene, cam, key, target, config, spp)

    return step, state, loss_of


def parameters(state) -> dict:
    """The leaves an inverse-rendering state optimises, by name."""
    params = state[0]
    return {"kd": params.kd, "vertex_offset": params.vertex_offset}


def first_gradients(state) -> dict:
    """Each leaf's gradient of the first step, worked out from the Adam
    state after it: exp_avg = (1 - beta1) g (zero where the optimizer
    holds no state: it never took the step)."""
    import torch

    params, opt = state
    beta1 = opt.param_groups[0]["betas"][0]
    return {k: opt.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt.state[p]
            else torch.zeros_like(p) for k, p in parameters(state).items()}


def make_mesh():
    """The port's mesh over the initialised process group: every rank on
    the tile axis."""
    from tinyraytracing_tpu_torch.parallel.mesh import make_mesh as mesh

    return mesh()


def render_sharded_queue(scene, cam, key, config, spp: int, mesh, lanes: int):
    """The queue renderer over the mesh's ranks: ((H, W, 3) image summed
    over the ranks, traced rays of all ranks) on every rank."""
    from tinyraytracing_tpu_torch.parallel.mesh import render_queue_sharded

    return render_queue_sharded(scene, cam, key, config, spp, mesh=mesh, lanes=lanes)
