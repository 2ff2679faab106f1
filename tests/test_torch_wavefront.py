"""The scan renderer's shading steps against the JAX package's on the CPU,
in the (R, 3) layout: ``sample_lobe``, ``sample_bsdf`` and ``direct_light``
(with one fixed intersect result handed to both, so only the NEE
arithmetic is compared), plus ``generate_rays`` and the linalg helpers.

Inputs are made with numpy from a seed. The transcendentals (sin, cos,
arcsin, arccos, pow, sqrt) of XLA and PyTorch differ in the last ulp, and
XLA contracts a*b+c into FMAs, so floats are held within 1e-5 (relative,
with an absolute floor of 1e-5) and discrete outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.integrator.bsdf import sample_bsdf as jbsdf
from tinyraytracing_tpu.integrator.nee import direct_light as jnee
from tinyraytracing_tpu.models.camera import generate_rays as jgen
from tinyraytracing_tpu.ops import linalg as jlin
from tinyraytracing_tpu.ops import intersect as jisect
from tinyraytracing_tpu.ops.sampling import sample_lobe as jlobe
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.integrator.bsdf import sample_bsdf
from tinyraytracing_tpu_torch.integrator.nee import direct_light
from tinyraytracing_tpu_torch.models.camera import generate_rays
from tinyraytracing_tpu_torch.ops import intersect as tisect
from tinyraytracing_tpu_torch.ops import linalg
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tinyraytracing_tpu_torch.ops.sampling import sample_lobe
from tests.torch_aligned_render import scenes

R = 2048


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    (ja, jb, je), (ta, tb, te) = _both(_unit(rng, R) * 3, _unit(rng, R),
                                      rng.uniform(0.5, 2, R).astype(np.float32))
    for fn in ("dot", "length", "length2", "normalize"):
        args = (ja,) if fn in ("length", "length2", "normalize") else (ja, jb)
        targs = (ta,) if len(args) == 1 else (ta, tb)
        _close(getattr(linalg, fn)(*targs), getattr(jlin, fn)(*args))
    _close(linalg.cross(ta, tb), jlin.cross(ja, jb))
    _close(linalg.reflect(ta, tb), jlin.reflect(ja, jb))
    (jn,), (tn,) = _both(_unit(rng, R))
    jr, jt = jlin.refract(jb, jn, je)
    tr, tt = linalg.refract(tb, tn, te)
    assert 0 < int(tt.sum()) < R              # both sides of TIR
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tr, jr)


@pytest.mark.parametrize("diffuse", [True, False])
def test_sample_lobe_matches_jax(diffuse):
    rng = np.random.default_rng(1)
    axis = _unit(rng, R)
    axis[:64, 0] = 0.0                  # both branches of the reference ONB
    u = rng.uniform(size=(2, R)).astype(np.float32)
    ns = rng.uniform(1, 200, R).astype(np.float32)
    is_d = np.full(R, diffuse)
    (ja, ju, jn, jd), (ta, tu, tn, td) = _both(axis, u, ns, is_d)
    _close(sample_lobe(ta, tu[0], tu[1], td, tn), jlobe(ja, ju[0], ju[1], jd, jn))


def test_sample_bsdf_matches_jax():
    rng = np.random.default_rng(2)
    d = _unit(rng, R)
    pn = _unit(rng, R)
    kd = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ks = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    kd[:100] = 0.0
    ks[50:150] = 0.0                      # |Kd| + |Ks| == 0: INVALID
    ns = rng.choice([1.0, 10.0, 500.0], R).astype(np.float32)
    ni = rng.choice([1.0, 1.5, 2.4], R).astype(np.float32)
    u = rng.uniform(size=(4, R)).astype(np.float32)
    j, t = _both(d, pn, kd, ks, ns, ni, u)
    jdir, jtype = jbsdf(*j[:6], *j[6])
    tdir, ttype = sample_bsdf(*t[:6], *t[6])
    np.testing.assert_array_equal(ttype.numpy(), np.asarray(jtype))
    assert len(set(np.asarray(jtype).tolist())) == 4       # every ray type
    _close(tdir, jdir)


@pytest.mark.parametrize("cfg", [{}, dict(light_sampler="uniform",
                                          shadow_test="tmin")])
def test_direct_light_matches_jax(cfg):
    js, _, ts, _ = scenes("cornell")
    rng = np.random.default_rng(3)
    L = int(ts.light_mtl.shape[0])
    # shading points inside the box, a random hit record for the shadow rays
    point = rng.uniform(50, 500, (R, 3)).astype(np.float32)
    pn = _unit(rng, R)
    wi = _unit(rng, R)
    kd = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ks = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ns = rng.uniform(1, 50, R).astype(np.float32)
    uni = rng.uniform(size=(R, L, 4)).astype(np.float32)
    sh_t = rng.uniform(1, 900, R * L).astype(np.float32)
    sh_t[::5] = 3e38
    sh_idx = rng.integers(0, ts.num_triangles, R * L)
    sh_u = rng.uniform(0, 0.5, R * L).astype(np.float32)

    def jfn(o, d):
        return jisect.Hit(t=jnp.asarray(sh_t), idx=jnp.asarray(sh_idx, jnp.int32),
                          u=jnp.asarray(sh_u), v=jnp.asarray(sh_u),
                          hit=jnp.asarray(sh_t < 3e38))

    def tfn(o, d):
        assert tuple(o.shape) == tuple(d.shape) == (R * L, 3)
        t = torch.from_numpy(sh_t)
        return tisect.Hit(t=t, idx=torch.from_numpy(sh_idx), u=torch.from_numpy(sh_u),
                          v=torch.from_numpy(sh_u), hit=t < 3e38)

    j, t = _both(point, pn, wi, kd, ks, ns, uni)
    want = jnee(js, JConfig(**cfg), jfn, *j)
    got = direct_light(ts, RenderConfig(**cfg), tfn, *t)
    assert got.shape == (R, 3) and float(got.sum()) > 0
    _close(got, want)


def test_generate_rays_matches_jax():
    _, jcam, _, tcam = scenes("cornell")
    for seed in (0, 9):
        jo, jd = jgen(jcam, jax.random.PRNGKey(seed))
        to, td = generate_rays(tcam, master_key_data(seed), "cpu")
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        _close(td, jd)
