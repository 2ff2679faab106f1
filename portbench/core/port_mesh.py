"""The program's side of the mesh cells, beside ``core/port.py``: the raw
scene of ``scenes/height_grid.py`` through the port's own loading path with
its shared vertex table (``assemble_scene`` with the mesh's vertex index,
then ``attach_bvh``), and the inverse-rendering loop in the albedos and the
mesh's shared vertex offsets on the fast gradient path."""

from __future__ import annotations

import dataclasses
import time

import numpy as np


def require_mesh_leaf() -> None:
    """Raise at once where the program has no per-vertex geometry leaf."""
    from tinyraytracing_tpu_torch.diff.inverse import SceneParams

    if "shared_vertex_offset" not in {f.name for f in dataclasses.fields(SceneParams)}:
        raise RuntimeError("the program has no shared_vertex_offset leaf: it cannot run "
                           "gradients in a mesh's shared vertex positions")


def build_scene(raw: dict, config: dict, device):
    """(scene, camera, render config) of the program for a raw scene with
    a mesh: ``core.port.build_scene``'s path, the mesh's vertex ids handed
    to ``assemble_scene`` (-1 outside ``mesh_range``)."""
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
    lo, hi = raw["mesh_range"]
    index = np.full((len(v), 3), -1, np.int64)
    index[lo:hi] = raw["vertex_index"]
    mesh = MeshArrays(v=v, vn=np.asarray(raw["vn"]), vt=np.zeros((len(v), 3, 2)),
                      normal=np.asarray(raw["normal"]), center=v.mean(axis=1),
                      mtl=np.asarray(raw["mtl"], np.int32),
                      mtl_names=list(raw["mtl_names"]),
                      vertices=np.asarray(raw["vertex_positions"], np.float64),
                      vertex_index=index)
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
    """``core.port.set_up`` for a raw scene with a mesh: (scene, camera,
    render config, seconds of host clock around the build, synchronized);
    on the card it also builds the trace records and every CUDA kernel."""
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


def inverse_problem(scene, cam, target_key, config, spp: int, learning_rate: float,
                    kd_start: float, offset_start):
    """Inverse rendering of the mesh on the fast gradient path:
    ``step(state, key)`` -> (state, loss) takes one Adam step of
    ``render_loss_fast`` in the albedos (from ``kd_start``) and the shared
    vertex offsets (from ``offset_start``, (V, 3)); the target is rendered
    under ``target_key`` with the loaded albedos and the unmoved mesh.
    Returns (step, state, loss_of), ``loss_of(state, key)`` the step's
    loss call alone."""
    import torch

    from tinyraytracing_tpu_torch.diff.fast import render_diff, render_loss_fast
    from tinyraytracing_tpu_torch.diff.inverse import SceneParams, make_train_step

    with torch.no_grad():
        target = render_diff(scene, cam, target_key, config, spp)
    step, init = make_train_step(scene, cam, target, config, spp,
                                 learning_rate=learning_rate, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=torch.full_like(scene.kd, kd_start),
                             shared_vertex_offset=offset_start.to(scene.device)))

    def loss_of(state, key):
        return render_loss_fast(state[0], scene, cam, key, target, config, spp)

    return step, state, loss_of


def parameters(state) -> dict:
    """The leaves the mesh's inverse-rendering state optimises, by name."""
    params = state[0]
    return {"kd": params.kd, "shared_vertex_offset": params.shared_vertex_offset}


def gradients(state) -> dict:
    """Each leaf's gradient of the last step (a step leaves it in place)."""
    import torch

    return {k: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
            for k, p in parameters(state).items()}


def recording():
    """The program's span and counter recording (``utils.spans``)."""
    from tinyraytracing_tpu_torch.utils import spans

    return spans.recording()


def num_vertices(scene) -> int:
    return int(scene.vertices.shape[0])
