"""Gradients in a mesh's shared vertex positions
(``SceneParams.shared_vertex_offset``), on the CPU, on an 8x8-cell
heightfield of ``portbench/scenes/height_grid.py`` (128 mesh triangles on
81 shared vertices, in the Cornell box without its blocks):

- the OBJ loader and the scene keep the shared vertex table and each
  triangle's vertex ids, through both tree builds (``load_scene``'s and
  ``attach_bvh``'s), emitters left out of the mesh;
- the fast gradient path against the plain reference
  (``portbench/core/reference_mesh.py``, loaded with ``portbench/`` on
  ``sys.path``) on seeded random albedos and vertex offsets: 24x24, 2 spp,
  depth 3;
- the vertex gradient repeats bitwise; smooth normals under the leaf
  raise; the refit writes the moved normals into the shading records;
- the per-triangle ``vertex_offset`` path is as it was: its numbers on the
  Cornell box are bitwise those from before the shared-vertex leaf, and a
  mesh in the scene does not change them;
- the reference's culled search equals ``core/reference.py``'s brute force;
- the spans and counters of a step.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff import SceneParams, apply_params, render_diff, render_loss_fast
from tinyraytracing_tpu_torch.diff.inverse import make_train_step
from tinyraytracing_tpu_torch.io.objmesh import parse_obj
from tinyraytracing_tpu_torch.models import procedural as tproc
from tinyraytracing_tpu_torch.models.scene import load_scene
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.utils import spans

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from core import common, port_mesh, reference, reference_mesh, scenes  # noqa: E402

SIZE, SPP, DEPTH = 24, 2, 3
CONFIG = {"scene": {"kind": "height_grid", "cells": 8, "grid_seed": 5}, "width": SIZE,
          "height": SIZE, "max_depth": DEPTH, "p_rr": 0.8, "leaf_size": 8}


@pytest.fixture(scope="module")
def raw():
    return scenes.build(CONFIG)


@pytest.fixture(scope="module")
def port_scene(raw):
    scene, cam, rc = port_mesh.build_scene(raw, CONFIG, "cpu")
    return scene, cam, rc


def _params(raw, seed):
    """Seeded albedos in [0.2, 0.8] by material name and vertex offsets of
    2 units a component (a cell is 61 units wide)."""
    g = torch.Generator().manual_seed(seed)
    names = sorted(raw["materials"])
    V = len(raw["vertex_positions"])
    kd = 0.2 + 0.6 * torch.rand((len(names), 3), generator=g)
    return dict(zip(names, kd)), 2.0 * torch.randn((V, 3), generator=g)


def _table(kd: dict, names) -> torch.Tensor:
    """The albedos in a material order (the port's and the reference's
    differ: the port puts the lights' first)."""
    return torch.stack([kd[n] for n in names])


def _program(scene, cam, rc, kd, off, key=master_key_data(11), tkey=master_key_data(3)):
    """(loss, kd gradient by material name, vertex gradient) of
    ``render_loss_fast``."""
    with torch.no_grad():
        target = render_diff(scene, cam, tkey, rc, SPP)
    kd = _table(kd, scene.mtl_names).requires_grad_(True)
    off = off.clone().requires_grad_(True)
    loss = render_loss_fast(SceneParams(kd=kd, shared_vertex_offset=off), scene, cam, key,
                            target, rc, SPP)
    loss.backward()
    return float(loss.detach()), _by_name(kd.grad, scene.mtl_names), off.grad


def _by_name(grad, names) -> torch.Tensor:
    """The rows of a material table in sorted order of their names."""
    return torch.stack([grad[list(names).index(n)] for n in sorted(names)])


def _reference(raw, kd, off, key=(0, 11), tkey=(0, 3)):
    """The plain reference's (loss, kd gradient by material name, vertex
    gradient)."""
    scn = reference_mesh.MeshRefScene(raw, "cpu")
    opts = common.ref_opts(CONFIG)
    pix = torch.arange(SIZE * SIZE)
    pids = (pix[:, None] * SPP + torch.arange(SPP)[None, :]).reshape(-1)
    cam = raw["camera"]

    def image(k, kd_tab):
        rad, _ = reference_mesh.trace_paths(scn, cam, k, pids, pids // SPP, opts, kd_tab)
        return rad.reshape(-1, SPP, 3).sum(1) / SPP

    with torch.no_grad():
        scn.move(None)
        target = image(tkey, None)
    kd = _table(kd, scn.names).requires_grad_(True)
    off = off.clone().requires_grad_(True)
    scn.move(off)
    loss = ((image(key, kd) - target) ** 2).sum() / (3 * SIZE * SIZE)
    loss.backward()
    return float(loss.detach()), _by_name(kd.grad, scn.names), off.grad


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _write_obj(d, raw):
    """The raw scene as XML, OBJ (the mesh on its shared vertices, every
    other triangle on vertices of its own, one flat ``vn`` a face) and MTL
    under ``d``."""
    pos, index = raw["vertex_positions"], raw["vertex_index"]
    lo, hi = raw["mesh_range"]
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in pos.tolist()]
    ids = np.empty((len(raw["v"]), 3), np.int64)
    ids[lo:hi] = index
    others = [t for t in range(len(raw["v"])) if not lo <= t < hi]
    for n, t in enumerate(others):
        lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in raw["v"][t].tolist()]
        ids[t] = len(pos) + 3 * n + np.arange(3)
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in raw["normal"].tolist()]
    for t in range(len(raw["v"])):
        lines.append(f"usemtl {raw['mtl_names'][raw['mtl'][t]]}")
        lines.append("f " + " ".join(f"{i + 1}/{t + 1}/" for i in ids[t]))   # v/vn/vt
    (d / "h.obj").write_text("\n".join(lines) + "\n")
    (d / "h.mtl").write_text("".join(
        f"newmtl {n}\nKd {m['kd'][0]} {m['kd'][1]} {m['kd'][2]}\n"
        for n, m in raw["materials"].items()))
    cam = raw["camera"]
    xyz = lambda tag, p: f'<{tag} x="{p[0]}" y="{p[1]}" z="{p[2]}"/>'
    (name, radiance), = raw["lights"]
    (d / "h.xml").write_text(
        '<?xml version="1.0" encoding="utf-8"?>\n'
        f'<camera type="perspective" width="{cam["width"]}" height="{cam["height"]}" '
        f'fovy="{cam["fovy"]}">\n  {xyz("eye", cam["eye"])}{xyz("lookat", cam["lookat"])}\n'
        f'  {xyz("up", cam["up"])}\n</camera>\n'
        f'<light mtlname="{name}" radiance="{", ".join(map(str, radiance))}"/>\n')
    return [str(d / n) for n in ("h.xml", "h.obj", "h.mtl")], ids


def test_obj_loader_keeps_the_shared_index(tmp_path, raw):
    paths, ids = _write_obj(tmp_path, raw)
    mesh = parse_obj(paths[1])
    np.testing.assert_array_equal(mesh.vertex_index, ids)
    np.testing.assert_array_equal(mesh.vertices[mesh.vertex_index], mesh.v)
    light = raw["mtl"] == raw["mtl_names"].index("Light")
    for with_bvh in (True, False):
        scene, _ = load_scene(*paths, with_bvh=with_bvh, device="cpu")
        if not with_bvh:
            scene = attach_bvh(scene, RenderConfig())
        idx = scene.vertex_index.long()
        inside = idx[:, 0] >= 0
        assert int(inside.sum()) == len(raw["v"]) - int(light.sum())   # emitters left out
        assert not bool(inside[scene.tri_emissive].any())
        assert scene.mesh_flat
        assert torch.equal(scene.vertices, torch.as_tensor(mesh.vertices))     # float64
        for k, v in enumerate((scene.v0, scene.v1, scene.v2)):
            assert torch.equal(v[inside], scene.vertices[idx[inside, k]].float())


def test_port_scene_carries_the_mesh(raw, port_scene):
    scene = port_scene[0]
    lo, hi = raw["mesh_range"]
    assert int((scene.vertex_index[:, 0] >= 0).sum()) == hi - lo == 128
    assert scene.vertices.shape == (81, 3) and scene.mesh_flat


# ---------------------------------------------------------------------------
# the fast path against the plain reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compared(raw, port_scene):
    kd, off = _params(raw, 1)
    prog = _program(*port_scene, kd, off)
    ref = _reference(raw, kd, off)
    return prog, ref


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_loss_and_gradients_match_the_reference(compared):
    """Both sides trace the same paths with the same draws, from the same
    float64-derived Woop rows with the same float32 tests, except on about
    1% of the paths (seeds 1-6 at this size): a shadow ray from a wall just
    under the ceiling grazes the ceiling's plane, which the light shares,
    and the port's walk (a tie band in walk order) and the reference's rule
    (a tie band against the bound) land on either side of it. Each such
    path carries its whole share of the gradient. So: the loss within 3e-5
    relative (read: at most 3.2e-6 over seeds 1-6), the kd gradient within
    5e-3 of its norm (7.1e-4) and the vertex gradient within 5e-2 of its
    norm (2.0e-2); shading with the unmoved normals reads 0.7-0.9 there."""
    (pl, pkd, pv), (rl, rkd, rv) = compared
    assert abs(pl - rl) <= 3e-5 * abs(rl)
    assert _rel(pkd, rkd) <= 5e-3
    assert _rel(pv, rv) <= 5e-2
    assert int((rv != 0).any(1).sum()) == 81


def test_vertex_gradient_repeats_bitwise(raw, port_scene):
    kd, off = _params(raw, 2)
    a, b = (_program(*port_scene, kd, off) for _ in range(2))
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_smooth_normals_under_the_leaf_raise(raw):
    smooth = dict(raw, vn=raw["vn"] + np.array([0.0, 0.0, 0.01]))
    scene, cam, _ = port_mesh.build_scene(smooth, CONFIG, "cpu")
    assert not scene.mesh_flat
    with pytest.raises(ValueError, match="flat-shaded"):
        apply_params(scene, cam, SceneParams(shared_vertex_offset=torch.zeros_like(scene.vertices)))
    # the per-triangle leaf still runs on such a scene
    apply_params(scene, cam, SceneParams(vertex_offset=torch.zeros_like(scene.v0)))


def test_refit_moves_the_shading_records(raw, port_scene):
    """The moved faces' normals are in the scene and in the tree's packed
    shading records, which the trace kernels shade with; triangles outside
    the mesh keep theirs."""
    scene, cam, _ = port_scene
    off = _params(raw, 3)[1]
    s2, _ = apply_params(scene, cam, SceneParams(shared_vertex_offset=off))
    inside = scene.vertex_index[:, 0] >= 0
    for k in ("n0", "n1", "n2"):
        assert torch.equal(getattr(s2, k)[inside], s2.gn[inside])
        assert torch.equal(getattr(s2, k)[~inside], getattr(scene, k)[~inside])
    pk = s2.bvh.packed
    S = pk.PS[4:].reshape(4, pk.n_leaves, 4, 32)
    slot = torch.nonzero(pk.slot_valid).squeeze(1)
    tri = pk.tid.long()[slot]
    for a in range(9):
        r, c = divmod(a, 4)
        got = S[r, :, c].reshape(-1)[slot]
        assert torch.equal(got, getattr(s2, f"n{a // 3}")[tri, a % 3])


# ---------------------------------------------------------------------------
# the per-triangle leaf is as it was
# ---------------------------------------------------------------------------

def test_per_triangle_gradient_is_unchanged():
    """``render_loss_fast`` in kd and per-triangle offsets on the 16x16
    Cornell box: the loss and the gradients' bits as the tree before the
    shared-vertex leaf gave them (their int32 views summed)."""
    scene, cam = tproc.cornell_box(16, 16, device="cpu")
    cfg = RenderConfig(max_depth=3)
    scene = attach_bvh(scene, cfg)
    with torch.no_grad():
        target = render_diff(scene, cam, master_key_data(3), cfg, 2)
    g = torch.Generator().manual_seed(5)
    kd = (scene.kd * 0.7).requires_grad_(True)
    off = (torch.rand(scene.v0.shape, generator=g) * 0.002 - 0.001).requires_grad_(True)
    loss = render_loss_fast(SceneParams(kd=kd, vertex_offset=off), scene, cam,
                            master_key_data(7), target, cfg, 2)
    loss.backward()
    assert float(loss.detach()) == 0.01907259039580822
    assert off.grad.view(torch.int32).long().sum().item() == -548182819
    assert kd.grad.view(torch.int32).long().sum().item() == -10495708650


def test_a_mesh_in_the_scene_leaves_the_per_triangle_leaf_alone(raw, port_scene):
    scene, cam, rc = port_scene
    bare = dataclasses.replace(scene, vertices=None, vertex_index=None)
    off = 0.5 * torch.randn(scene.v0.shape, generator=torch.Generator().manual_seed(4))
    grads = []
    for s in (scene, bare):
        with torch.no_grad():
            target = render_diff(s, cam, master_key_data(3), rc, SPP)
        o = off.clone().requires_grad_(True)
        render_loss_fast(SceneParams(vertex_offset=o), s, cam, master_key_data(9), target,
                         rc, SPP).backward()
        grads.append(o.grad)
    assert torch.equal(*grads)


# ---------------------------------------------------------------------------
# the reference's culled search
# ---------------------------------------------------------------------------

def test_culled_search_equals_brute_force(raw, monkeypatch):
    """The culled search (blocks of 16 triangles) bitwise the same search
    over one block of every triangle, and the same hits as
    ``core/reference.py``'s brute force, which sums by matrix products:
    rays from random points in the box in random directions (closest
    hits) and towards points of the light (visibility, bounded there)."""
    off = _params(raw, 6)[1]
    scn = reference_mesh.MeshRefScene(raw, "cpu")
    monkeypatch.setattr(reference_mesh, "BLOCK", 16)
    culled = reference_mesh.MeshRefScene(raw, "cpu")
    assert len(culled.blocks) > 8 and len(scn.blocks) <= 2
    scn.blocks = [torch.arange(scn.T)]
    for s in (scn, culled):
        s.move(off)
    opts = common.ref_opts(CONFIG)
    g = torch.Generator().manual_seed(0)
    N = 4096
    o = torch.rand((N, 3), generator=g) * torch.tensor([556.0, 300.0, 559.0])
    d = torch.nn.functional.normalize(torch.randn((N, 3), generator=g), dim=1)
    t1, i1 = reference_mesh.search(culled, o, d, opts)
    t2, i2 = reference_mesh.search(scn, o, d, opts)
    assert torch.equal(i1, i2) and torch.equal(t1, t2) and int((i1 >= 0).sum()) > N // 2
    t3, i3 = reference.closest_hit(scn, o, d, opts)
    same = i1 == i3
    assert int(same.sum()) >= N - 4
    torch.testing.assert_close(t1[same], t3[same], rtol=1e-5, atol=1e-4)
    light = scn.lights[0]
    corner = scn.v[light["tri"][0]]
    w = torch.rand((N, 2), generator=g) * 0.5
    p = corner[0] + w[:, :1] * (corner[1] - corner[0]) + w[:, 1:] * (corner[2] - corner[0])
    to = p - o
    dist = to.norm(dim=1)
    target = torch.full((N,), light["mat"])
    args = (o, to / dist[:, None], opts)
    vis = [reference_mesh.search(s, *args, bound=dist, target=target) for s in (culled, scn)]
    assert torch.equal(*vis) and 0 < int(vis[0].sum()) < N
    assert int((vis[0] != reference.visible(scn, o, to / dist[:, None], dist, target,
                                            opts)).sum()) <= 4


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def test_a_steps_spans_and_counters(raw, port_scene):
    """One step in a recording: the per-vertex apply nests in the refit's
    span, the backward opens the scatter's, ``mesh.vertices`` counts the
    shared vertices and ``diff.rays`` the forward's traced rays."""
    scene, cam, rc = port_scene
    kd, off = _params(raw, 7)
    key = master_key_data(8)
    with torch.no_grad():
        target = render_diff(scene, cam, master_key_data(3), rc, SPP)
    step, init = make_train_step(scene, cam, target, rc, SPP, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=_table(kd, scene.mtl_names), shared_vertex_offset=off))
    with torch.no_grad():
        s2, c2 = apply_params(scene, cam, state[0])
        _, rays = render_diff(s2, c2, key, rc, SPP, return_rays=True)
    with spans.recording() as rec:
        step(state, key)
    names = {s[0] for s in rec.spans}
    assert {"diff.mesh", "diff.mesh.scatter", "diff.refit"} <= names
    (mesh,), (refit,) = ([s for s in rec.spans if s[0] == n] for n in ("diff.mesh", "diff.refit"))
    assert refit[1] <= mesh[1] <= mesh[2] <= refit[2]
    (back,) = [s for s in rec.spans if s[0] == "diff.backward"]
    (scatter,) = [s for s in rec.spans if s[0] == "diff.mesh.scatter"]
    assert back[1] <= scatter[1] <= scatter[2] <= back[2]
    assert rec.counts["mesh.vertices"] == 81
    assert rec.counts["diff.rays"] == int(rays) > SIZE * SIZE * SPP
