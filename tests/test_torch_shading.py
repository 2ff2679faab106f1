"""Per-bounce shading helpers of the port (integrator/fused.py) against the
JAX package's on the same random planes: BSDF sampling, material lookups,
texture Kd, next-event geometry for small (select-chain) and large
(one-hot matmul / row gather) light tables, and the tile pixel order.

Floats within 1e-6 relative (atol 1e-6 for unit-vector components, which
cross zero): XLA's CPU sin/cos/arcsin/pow/rsqrt and PyTorch's differ in
the last ulps (~1e-7 relative). One exception, stated where it is used:
the Phong term pow(cos, ns) multiplies cos's last-ulp difference by ns.
Discrete outputs equal."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.integrator import fused as jf
from tinyraytracing_tpu.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.models.scene import assemble_scene
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator import fused as tf
from tests.torch_port_util import port_scene

TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _j(a):
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, k])) for k in range(3))


def _t(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3))


def _close(t_planes, j_planes, **tol):
    for x, y in zip(t_planes, j_planes):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **(tol or TOL))


MATERIALS = {
    "diffuse": dict(kd=(0.7, 0.5, 0.3), ks=(0.0, 0.0, 0.0), ns=1.0, ni=1.0),
    "specular": dict(kd=(0.2, 0.2, 0.2), ks=(0.8, 0.8, 0.8), ns=200.0, ni=1.0),
    "glossy": dict(kd=(0.4, 0.3, 0.3), ks=(0.5, 0.5, 0.5), ns=20.0, ni=1.0),
    "refractive": dict(kd=(0.1, 0.1, 0.1), ks=(0.9, 0.9, 0.9), ns=200.0, ni=1.5),
}


@pytest.mark.parametrize("kind", list(MATERIALS))
def test_sample_bsdf_planar_matches_jax(kind):
    rng = np.random.default_rng(41)
    n = 4096
    m = MATERIALS[kind]
    d, pn = _unit(rng, n), _unit(rng, n)
    full = lambda v: np.tile(np.asarray(v, np.float32), (n, 1))
    kd, ks = full(m["kd"]), full(m["ks"])
    ns = np.full(n, m["ns"], np.float32)
    ni = np.full(n, m["ni"], np.float32)
    u = rng.uniform(0, 1, (4, n)).astype(np.float32)
    jd, jt = jf.sample_bsdf_planar(_j(d), _j(pn), _j(kd), _j(ks),
                                   jnp.asarray(ns), jnp.asarray(ni),
                                   *map(jnp.asarray, u))
    td, tt = tf.sample_bsdf_planar(_t(d), _t(pn), _t(kd), _t(ks),
                                   torch.from_numpy(ns), torch.from_numpy(ni),
                                   *map(torch.from_numpy, u))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(td, jd)
    types_seen = set(np.unique(np.asarray(jt)).tolist())
    assert len(types_seen) >= (1 if kind == "diffuse" else 2), types_seen


def _split_light_scene(k_side):
    """Floor + a cornell light quad split into 2*k_side^2 triangles, so the
    light table has K > CHAIN_LIMIT for k_side >= 6 (the one-hot branch)."""
    quads = [jproc._CORNELL_QUADS[0], jproc._CORNELL_QUADS[2]]
    xs = np.linspace(213.0, 343.0, k_side + 1)
    zs = np.linspace(227.0, 332.0, k_side + 1)
    for a in range(k_side):
        for b in range(k_side):
            x0, x1, z0, z1 = xs[a], xs[a + 1], zs[b], zs[b + 1]
            quads.append(([(x1, 548.8, z0), (x1, 548.8, z1), (x0, 548.8, z1),
                           (x0, 548.8, z0)], "Light"))
    mesh = jproc._quads_to_mesh(quads)
    cfg = SceneConfig(8, 8, 40.0, (278.0, 273.0, -800.0),
                      (278.0, 273.0, -799.0), (0.0, 1.0, 0.0),
                      [LightSpec("Light", (34.0, 24.0, 8.0))])
    js = assemble_scene(cfg, mesh, dict(jproc.CORNELL_MATERIALS))
    return js, port_scene(js)


_NEE_SCENES = {}


@pytest.mark.parametrize("specular_weight", ["ref", "ks"])
@pytest.mark.parametrize("light_sampler", ["ref", "uniform"])
@pytest.mark.parametrize("k_side", [1, 7])
def test_nee_geometry_matches_jax(k_side, light_sampler, specular_weight):
    if k_side not in _NEE_SCENES:
        _NEE_SCENES[k_side] = _split_light_scene(k_side)
    js, ts = _NEE_SCENES[k_side]
    K = ts.lt_counts[0]
    assert (K > 64) == (k_side == 7)
    rng = np.random.default_rng(42 + k_side)
    n = 2048
    point = (rng.uniform(0, 1, (n, 3)) * (550.0, 300.0, 550.0)).astype(np.float32)
    pn, wi = _unit(rng, n), _unit(rng, n)
    pn[:, 1] = np.abs(pn[:, 1])          # mostly facing the light
    kd = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ks = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ns = rng.uniform(1, 100, n).astype(np.float32)
    u = rng.uniform(0, 1, (4, n)).astype(np.float32)
    u[0, :8] = [0.0, 0.999999, 0.5, 0.25, 1e-7, 0.75, 0.9, 0.1]
    mask = rng.uniform(size=n) < 0.8
    jc = JConfig(light_sampler=light_sampler, specular_weight=specular_weight)
    tc = RenderConfig(light_sampler=light_sampler,
                      specular_weight=specular_weight)
    jw, jc_, jd, jok = jf._nee_geometry(
        js, jc, 0, _j(point), _j(pn), _j(wi), _j(kd), _j(ks),
        jnp.asarray(ns), *map(jnp.asarray, u), jnp.asarray(mask))
    tw, tc_, td, tok = tf._nee_geometry(
        ts, tc, 0, _t(point), _t(pn), _t(wi), _t(kd), _t(ks),
        torch.from_numpy(ns), *map(torch.from_numpy, u),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert np.asarray(jok).mean() > 0.2
    _close(tw, jw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    # contribution: 1e-6 relative per unit of Phong exponent (see top)
    for a, b in zip(tc_, jc_):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b)
        assert (err <= 1e-6 * (ns + 1.0) * np.abs(b) + 1e-12).all(), err.max()


def test_material_planes_and_tex_kd_match_jax():
    js, _ = jproc.cornell_box_specular(8, 8)
    ts = port_scene(js)
    M = ts.num_materials
    m = np.array([-3.0, -1.0] + list(range(M)) * 3, np.float32)
    jm = jf._material_planes(js, jnp.asarray(m))
    tm = tf._material_planes(ts, torch.from_numpy(m))
    for k, v in jm.items():
        got = tm[k]
        if isinstance(v, tuple):
            for a, b in zip(got, v):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    # textured materials: a synthetic 2-texture atlas on the same tables
    rng = np.random.default_rng(44)
    tex = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    hw = np.array([[5, 7], [3, 4]], np.int32)
    n = 512
    tid = rng.integers(-1, 2, n).astype(np.int32)
    tcu = rng.uniform(-2, 2, n).astype(np.float32)
    tcv = rng.uniform(-2, 2, n).astype(np.float32)
    kd = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jscene = types.SimpleNamespace(tex=jnp.asarray(tex), tex_hw=jnp.asarray(hw))
    tscene = types.SimpleNamespace(tex=torch.from_numpy(tex),
                                   tex_hw=torch.from_numpy(hw))
    jk = jf._tex_kd(jscene, {"tex_id": jnp.asarray(tid)}, jnp.asarray(tcu),
                    jnp.asarray(tcv), _j(kd))
    tk = tf._tex_kd(tscene, {"tex_id": torch.from_numpy(tid)},
                    torch.from_numpy(tcu), torch.from_numpy(tcv), _t(kd))
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("M", [7, 100])
def test_chain_lookup_matches_jax(M):
    """Select chains (M <= 64: out-of-range ids read the last row) and the
    direct gather past CHAIN_LIMIT (negative ids wrap, others clamp)."""
    from tinyraytracing_tpu.ops.lookup import chain_lookup as jl
    from tinyraytracing_tpu_torch.ops.lookup import chain_lookup as tl

    rng = np.random.default_rng(45)
    tab = rng.normal(size=(M, 3)).astype(np.float32)
    idx = np.concatenate([np.arange(-3, M + 3),
                          rng.integers(0, M, 50)]).astype(np.int32)
    if M > 64:     # the JAX gather path takes only in-range or wrapped ids
        idx = idx[idx >= -M]
    np.testing.assert_array_equal(
        tl(torch.from_numpy(tab), torch.from_numpy(idx)).numpy(),
        np.asarray(jl(jnp.asarray(tab), jnp.asarray(idx))))


@pytest.mark.parametrize("wh", [(16, 16), (50, 37), (1024, 1024)])
def test_pixel_tile_order_matches_jax(wh):
    for a, b in zip(tf.pixel_tile_order(*wh), jf.pixel_tile_order(*wh)):
        np.testing.assert_array_equal(a, b)
