"""The port's intersectors against the JAX package's on the CPU: the XLA
paths (Moller-Trumbore, brute, mxu, the per-ray "bvh" walk) against their
plain PyTorch ports, and the plain versions of the two CUDA kernels
(``bvh_intersect_plain``, ``slot_intersect_plain``) against the Pallas
kernels they replace, run in Pallas interpret mode.

Rays: the scan renderer's three kinds (tests/torch_port_util.py
``scan_rays``): 1024 camera rays, 1024 diffuse-bounce rays and 1024 shadow
rays, misses parked as the renderer parks them. The JAX side runs in a
process of its own with XLA's FMA contraction off
(tests/torch_aligned_intersect.py), which otherwise flips a few self-hits
of the bounce and shadow rays. Held (ROADMAP.md): hit and triangle index
exactly equal; t within rtol 1e-5; u and v within 1e-4.

The kernel-4 port walks the tree per ray where the TPU kernel walks it per
1024-ray packet; equal outputs on coherent (camera, shadow) and incoherent
(bounce) rays are the evidence that a lane's result does not depend on
its packet (csrc/bvh_intersect.cu, source note).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyraytracing_tpu.ops.pallas_intersect import pack_triangle_slots as jpack
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops import intersect as tisect
from tinyraytracing_tpu_torch.ops.bvh_intersect import bvh_intersect_plain
from tinyraytracing_tpu_torch.ops.slot_intersect import (
    pack_triangle_slots, slot_intersect_plain,
)
from tests.torch_port_util import scene_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The rays and the JAX results of every case, from one process with
    FMA contraction off (tests/torch_aligned_intersect.py)."""
    out = tmp_path_factory.mktemp("aligned") / "intersect.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX"))
    subprocess.run([sys.executable, "-m", "tests.torch_aligned_intersect",
                    str(out)], cwd=ROOT, env=env, check=True, timeout=600)
    with np.load(out) as f:
        return dict(f)


def _rays(jax_out, name):
    """(org, dir) numpy float32, (3072, 3) each."""
    return jax_out[f"{name}-org"], jax_out[f"{name}-dir"]


def _want(jax_out, name, what, n=4):
    return [jax_out[f"{name}-{what}-{k}"] for k in range(n)]


def _ray_planes(org, d):
    return torch.stack([torch.from_numpy(np.ascontiguousarray(a[:, k]))
                        for a in (org, d) for k in range(3)]).contiguous()


def _check(want, got):
    """want/got: (t, idx, u, v) numpy. Discrete exact, floats in tolerance."""
    t0, i0, u0, v0 = (np.asarray(x) for x in want)
    t1, i1, u1, v1 = (np.asarray(x) for x in got)
    hit0, hit1 = t0 < 3e38, t1 < 3e38
    np.testing.assert_array_equal(hit1, hit0)
    np.testing.assert_array_equal(i1.astype(np.int64), i0.astype(np.int64))
    np.testing.assert_allclose(t1[hit0], t0[hit0], rtol=1e-5)
    np.testing.assert_allclose(u1[hit0], u0[hit0], atol=1e-4)
    np.testing.assert_allclose(v1[hit0], v0[hit0], atol=1e-4)
    return int(hit0.sum())


@pytest.mark.parametrize("name", ["cornell", "grid2000", "grid2000_32"])
def test_bvh_kernel_plain_matches_pallas_bvh(name, jax_out):
    _, ts = scene_pair(name)
    want = _want(jax_out, name, "bvh_pallas")
    rays = _ray_planes(*_rays(jax_out, name))
    stats = {}
    got = [x.numpy() for x in bvh_intersect_plain(ts.bvh.packed, rays,
                                                  RenderConfig(), stats)]
    assert got[1].dtype == np.int32
    n_hit = _check(want, got)
    assert n_hit > 1024                  # camera and bounce rays mostly hit
    assert stats["node_visits"] >= 3072
    pk = ts.bvh.packed
    assert 0 < stats["slot_tests"] <= stats["node_visits"] * pk.leaf_size
    assert 0 < stats["scene_bytes"] <= (pk.node_box.nbytes + pk.node_meta.nbytes
                                        + 16 * 4 * pk.tid.numel()
                                        + pk.tid.nbytes)


@pytest.mark.parametrize("name", ["cornell", "grid600"])
def test_slot_kernel_plain_matches_pallas_intersect(name, jax_out):
    _, ts = scene_pair(name)
    want = _want(jax_out, name, "pallas")
    rays = _ray_planes(*_rays(jax_out, name))
    P, n_chunks = ts.slot_payload
    stats = {}
    got = [x.numpy() for x in slot_intersect_plain(P, ts.num_triangles, rays,
                                                   RenderConfig(), stats)]
    assert got[1].dtype == np.int32
    assert _check(want, got) > 1024
    assert n_chunks == -(-ts.num_triangles // 32)
    assert stats["slot_tests"] == 3072 * ts.num_triangles
    assert stats["scene_bytes"] == 64 * ts.num_triangles


@pytest.mark.parametrize("name", ["cornell", "grid600"])
def test_pack_triangle_slots_equals_jax(name):
    js, ts = scene_pair(name)
    jP, jn = jpack(js.woop_a, js.woop_b, js.gn, js.tri_emissive)
    P, n = pack_triangle_slots(ts.woop_a, ts.woop_b, ts.gn, ts.tri_emissive)
    assert n == jn and P.dtype == torch.float32
    np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
    assert ts.slot_payload[0] is ts.slot_payload[0]      # packed once


@pytest.mark.parametrize("backend", ["brute", "mxu", "bvh"])
@pytest.mark.parametrize("name", ["cornell", "grid2000"])
def test_xla_backends_match_jax(name, backend, jax_out):
    _, ts = scene_pair(name)
    org, d = (torch.from_numpy(a) for a in _rays(jax_out, name))
    th = tisect.intersect(ts, org, d, RenderConfig(intersector=backend))
    want = _want(jax_out, name, backend)
    assert _check(want, (th.t, th.idx, th.u, th.v)) > 1024
    np.testing.assert_array_equal(th.hit.numpy(), want[0] < 3e38)
    np.testing.assert_allclose(th.w.numpy(), 1.0 - want[2] - want[3], atol=2e-4)


def test_bvh_walk_without_early_out_matches_jax(jax_out):
    _, ts = scene_pair("grid2000")
    org, d = (torch.from_numpy(a) for a in _rays(jax_out, "grid2000"))
    th = tisect.intersect(ts, org, d,
                          RenderConfig(intersector="bvh", bvh_early_out=False))
    _check(_want(jax_out, "grid2000", "bvh_noearly"),
           (th.t, th.idx, th.u, th.v))


def test_moller_trumbore_matches_jax(jax_out):
    _, ts = scene_pair("cornell")
    org, d = (torch.from_numpy(a[::4]) for a in _rays(jax_out, "cornell"))
    targs = [getattr(ts, f)[:32] for f in ("v0", "v1", "v2", "gn")]
    jt, ju, jv, jok = _want(jax_out, "cornell", "mt")
    tt, tu, tv, tok = tisect.moller_trumbore(org, d, *targs, RenderConfig())
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() > 500
    np.testing.assert_allclose(tt.numpy()[jok], jt[jok], rtol=1e-5)
    np.testing.assert_allclose(tu.numpy()[jok], ju[jok], atol=1e-4)
    np.testing.assert_allclose(tv.numpy()[jok], jv[jok], atol=1e-4)


def test_auto_dispatch_on_cpu():
    """"auto" on the CPU: the per-ray "bvh" walk with a BVH, "mxu" without,
    as the JAX package on the CPU; the kernels' backends only on CUDA."""
    _, ts = scene_pair("cornell")
    org = torch.zeros(4, 3)
    auto = RenderConfig()
    assert tisect.resolve_backend(ts, org, auto) == "bvh"
    assert tisect.resolve_backend(dataclasses.replace(ts, bvh=None), org,
                                  auto) == "mxu"
    with pytest.raises(ValueError, match="unknown intersector"):
        tisect.resolve_backend(ts, org, RenderConfig(intersector="nope"))


@pytest.mark.parametrize("backend", ["mxu", "brute", "bvh", "pallas",
                                     "bvh_pallas"])
def test_explicit_backend_reaches_it(backend, monkeypatch):
    from tinyraytracing_tpu_torch.models.camera import Camera, generate_rays
    from tinyraytracing_tpu_torch.ops import bvh_intersect, slot_intersect, traverse

    _, ts = scene_pair("cornell")
    cam = Camera.create((278.0, 273.0, -800.0), (278.0, 273.0, -799.0),
                        (0.0, 1.0, 0.0), 39.3077, 8, 8)
    org, d = generate_rays(cam, (0, 1), "cpu")
    calls = []

    def spy(mod, fn):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, **k: calls.append(fn) or real(*a, **k))

    spy(tisect, "mxu_intersect")
    spy(tisect, "brute_force_intersect")
    spy(traverse, "bvh_intersect")
    spy(slot_intersect, "slot_intersect_plain")
    spy(bvh_intersect, "bvh_intersect_plain")
    hit = tisect.intersect(ts, org, d, RenderConfig(intersector=backend))
    want = {"mxu": "mxu_intersect", "brute": "brute_force_intersect",
            "bvh": "bvh_intersect", "pallas": "slot_intersect_plain",
            "bvh_pallas": "bvh_intersect_plain"}[backend]
    assert calls == [want]
    assert hit.idx.dtype == torch.int64 and bool(hit.hit.any())
